"""Probe coverage of an IVF-PQ index: the recall ceiling against nprobe (the
port of ``scripts/coverage_probe.py``).

    python -m nvdb_tpu_torch.tools.coverage_probe index.npz q.vecbin gt.gtbin
        [--nprobe 16 32 64 128 256] [--metric l2|dot|corr:B] [--shards S]
        [--device cuda|cpu]

For each query the lists are ranked as the serving path ranks them, and a
ground-truth neighbour counts as covered at nprobe when a list holding it
is among the top nprobe. That share is the recall ceiling of any candidate
generator and refine depth at that nprobe: a neighbour whose list is never
scanned cannot be found, and one that spilled out of every list (its row
in no list) is never found at all. ``placed`` is the share of ground-truth
neighbours that sit in some list.

List rankings, over the rotated queries (TF32 off) and with lists that hold
no live slot masked out:

- ``l2``: ``index.ivf_flat._coarse_probes`` with the index's cached
  ``coarse_terms``, what ``search_device`` probes (argmax 2 q.c - ||c||^2);
- ``dot``: q.c;
- ``corr:B``: 2 q.c - ||c||^2 + B max(1 - ||c||^2, 0), the per-list variance
  estimated as 1 - ||c||^2 (exact for unit-norm rows, E[x] = c).

It reads the ``.npz`` of either package, replicated indexes included: a row
there sits in several lists, and it is covered when any of them is probed
(its best rank). With one copy per row that is the JAX script's count.
Prints the JAX script's lines: ``N= nlist= Q= k= placed=``, one
``nprobe= coverage=`` per nprobe, and the probe-rank percentiles of the
placed neighbours' lists when some placed neighbour is missed at the
smallest nprobe. ``--shards S`` reads the probe set of the sharded search
(``dist.ShardedIVFPQIndex`` over S shards: contiguous blocks of lists, each
probing ``ceil(nprobe / S)`` of its own by the same ranking), with no
percentiles. ``main`` returns {"placed", "coverage": {nprobe: share},
"percentiles"}. It runs on the card unless ``--device cpu`` is given;
without a card it exits 1.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.formats import gtbin, vecbin
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device


def load_queries(torch, path: str, dp: int, rotation, device):
    """The queries zero-padded to ``dp`` and rotated into the index's space."""
    from nvdb_tpu_torch.index.ivf_pq import _matmul

    q = vecbin.VecbinFile(path).rows_f32()
    qp = np.zeros((q.shape[0], dp), np.float32)
    qp[:, :q.shape[1]] = q
    qt = torch.from_numpy(qp).to(device)
    return _matmul(qt, rotation) if rotation is not None else qt


def list_ranking(torch, q, idx, metric: str):
    """[Q, nlist] int64 list ids, best first, by ``metric``."""
    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes
    from nvdb_tpu_torch.kernels import ops

    if metric == "l2":
        return _coarse_probes(q, idx.centroids, idx.slot_ids, idx.nlist,
                              terms=idx.coarse_terms())
    ops.no_tf32()
    cents = idx.centroids
    cs = q @ cents.T
    if metric.startswith("corr:"):
        c2 = torch.sum(cents * cents, dim=1)[None, :]
        cs = 2.0 * cs - c2 + float(metric.split(":", 1)[1]) * torch.clamp(1.0 - c2, min=0.0)
    elif metric != "dot":
        fail(f"unknown metric {metric!r}: l2, dot or corr:B")
    live = (idx.slot_ids >= 0).any(dim=1)[None, :]
    return torch.topk(torch.where(live, cs, ops.NEG_INF), idx.nlist, dim=1).indices


def shard_ranks(torch, q, idx, metric: str, shards: int):
    """[Q, nlist] int64: each list's rank among the lists of its own shard,
    the ``dist.ShardedIVFPQIndex`` layout (contiguous blocks of
    ``round_up(nlist, S) / S`` lists, each shard ranking its own)."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.utils import cdiv

    block = cdiv(idx.nlist, shards)
    rank_of = torch.empty((q.shape[0], idx.nlist), dtype=torch.int64, device=q.device)
    for s in range(0, idx.nlist, block):
        part = IVFPQIndex(None, idx.centroids[s:s + block], idx.codebooks,
                          idx.codes[s:s + block], idx.slot_ids[s:s + block], idx.n, idx.d,
                          idx.m)
        order = list_ranking(torch, q, part, metric)
        rows = torch.arange(order.shape[1], device=q.device).expand_as(order)
        rank_of[:, s:s + block] = torch.empty_like(order).scatter_(1, order, rows)
    return rank_of


def lists_of_rows(slot_ids: np.ndarray, n: int) -> np.ndarray:
    """[n, R] the lists that hold each row (-1 past its copies), R the most
    copies of any row."""
    li, lane = np.nonzero(slot_ids >= 0)
    rows = slot_ids[li, lane].astype(np.int64) % n
    order = np.argsort(rows, kind="stable")
    rows, li = rows[order], li[order]
    counts = np.bincount(rows, minlength=n)
    out = np.full((n, max(int(counts.max()) if counts.size else 1, 1)), -1, np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out[rows, np.arange(rows.size) - start[rows]] = li
    return out


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("index")
    p.add_argument("queries")
    p.add_argument("gt")
    p.add_argument("--nprobe", type=int, nargs="+", default=[16, 32, 64, 128, 256])
    p.add_argument("--metric", default="l2",
                   help="list ranking: l2 (the serving path's), dot, or corr:B")
    p.add_argument("--shards", type=int, default=1,
                   help=">1: the sharded search's probe set: the lists split into S "
                        "contiguous blocks, each probing ceil(nprobe / S) of its own")
    args = p.parse_args(argv)
    if not (args.metric in ("l2", "dot") or args.metric.startswith("corr:")):
        fail(f"unknown metric {args.metric!r}: l2, dot or corr:B")
    device = setup_device(args)

    import torch

    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex

    idx = IVFPQIndex.load(args.index, device=device)
    gt_ids = np.asarray(gtbin.read_gtbin(args.gt)[1]).astype(np.int64)     # [Q, k]
    q = load_queries(torch, args.queries, idx.centroids.shape[1], idx.rotation, device)
    if q.shape[0] != gt_ids.shape[0]:
        fail(f"{q.shape[0]} queries against {gt_ids.shape[0]} ground-truth rows")
    Q, nlist = q.shape[0], idx.nlist
    if args.shards > 1:
        rank_of = shard_ranks(torch, q, idx, args.metric, args.shards)
    else:
        order = list_ranking(torch, q, idx, args.metric)
        rank_of = torch.empty_like(order).scatter_(
            1, order, torch.arange(nlist, device=order.device).expand(Q, nlist))
    rank_of = np.concatenate([rank_of.cpu().numpy(), np.full((Q, 1), nlist, np.int64)], 1)

    held = lists_of_rows(idx.slot_ids.cpu().numpy(), idx.n)           # [n, R]
    gt_lists = held[gt_ids % idx.n]                                     # [Q, k, R]
    placed = gt_lists[..., 0] >= 0
    # a missing copy (-1) reads column nlist: never probed
    ranks = np.take_along_axis(rank_of, np.where(gt_lists >= 0, gt_lists, nlist)
                               .reshape(Q, -1), 1).reshape(gt_lists.shape)
    gt_rank = ranks.min(axis=2)
    print(f"N={idx.n} nlist={nlist} Q={Q} k={gt_ids.shape[1]} "
          f"placed={placed.mean():.6f} (unplaced GT rows can never be found)")
    coverage = {}
    for np_ in args.nprobe:
        # sharded: the probes of each shard, as dist.sharded_ivf takes them
        per = max(1, min(-(-np_ // args.shards), -(-nlist // args.shards)))
        coverage[np_] = float(((gt_rank < per) & placed).mean())
        print(f"nprobe={np_:4d} coverage={coverage[np_]:.4f}"
              + (f" shards={args.shards} per_shard={per}" if args.shards > 1 else ""))
    pct = None
    if args.shards == 1 and (placed & (gt_rank >= min(args.nprobe))).any():
        pct = np.percentile(gt_rank[placed], [50, 90, 99, 99.9])
        print("gt-list probe-rank percentiles p50/p90/p99/p99.9:",
              " ".join(f"{v:.0f}" for v in pct))
    return {"placed": float(placed.mean()), "coverage": coverage,
            "percentiles": None if pct is None else [float(v) for v in pct]}


if __name__ == "__main__":
    main()
