"""The ADC ranking's share of an IVF-PQ recall loss (the port of
``scripts/adc_rank_probe.py``).

    python -m nvdb_tpu_torch.tools.adc_rank_probe index.npz q.vecbin gt.gtbin
        [--nprobe 64] [--rk 32 64 128 256 512 1024] [--chunk 32]
        [--score-mode f32|bf16lut|bf16score] [--backend auto|cuda|torch]
        [--device cuda|cpu]

For each query every live candidate of its top-nprobe lists is scored by
ADC, and recall@rk is read off the top rk of them for a ladder of refine
depths, as if the refine were perfect. With ``tools.coverage_probe`` this
splits the serving recall in two factors:

    measured recall = probe coverage x P(ADC rank <= rk | covered)

The probes are ``index.ivf_flat._coarse_probes`` (the serving path's
ranking: argmax 2 q.c - ||c||^2 over the rotated queries, dead lists
masked). Score modes:

- ``f32``: ``pq.adc_lut`` and ``pq.adc_scores`` with TF32 off, the exact
  f32 oracle (the JAX package's jnp block);
- ``bf16lut``: the tables in bf16, summed in f32: on a card the serving
  path's own tables, ``adc_tables_cuda`` (``--backend torch``, or the CPU:
  ``adc_tables_reference``), the tables of the dma kernel;
- ``bf16score``: ``bf16lut`` with each score rounded to bf16, which models
  the key kernel's bf16 ranking.

Prints the JAX script's lines: ``[e/Q] rk=R:recall ...`` after each chunk of
queries and ``FINAL recall@rk=R=... ...``; ``main`` returns {rk: recall}.
It runs on the card unless ``--device cpu`` is given; without a card it
exits 1.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.formats import gtbin
from nvdb_tpu_torch.tools._common import make_parser, setup_device
from nvdb_tpu_torch.tools.coverage_probe import load_queries


def chunk_scores(torch, idx, qb, probes, mode: str, backend: str):
    """[b, P * Lcap] ADC scores of the probed lists' slots (-inf where a
    slot holds no row)."""
    from nvdb_tpu_torch.kernels import adc_scan, dispatch, ops, pq

    b, P = probes.shape
    if mode == "f32":
        res = qb[:, None, :] - idx.centroids[probes]
        lut = pq.adc_lut(res.reshape(b * P, -1), idx.codebooks, idx.m)
    else:
        fills = idx.fills()
        if dispatch.refine_backend(backend, idx.codes) == "cuda":
            lut = adc_scan.adc_tables_cuda(qb.contiguous(), probes.to(torch.int32),
                                           idx.centroids, idx.codebooks, fills)
        else:
            lut = adc_scan.adc_tables_reference(qb, probes, idx.centroids, idx.codebooks,
                                                fills)
    lut = lut.reshape(b, P, idx.m, pq.KSUB).to(torch.float32)
    s = pq.adc_scores(lut, idx.codes[probes].transpose(-1, -2))        # [b, P, L]
    if mode == "bf16score":
        s = s.to(torch.bfloat16).to(torch.float32)
    return torch.where(idx.slot_ids[probes] >= 0, s, ops.NEG_INF).reshape(b, -1)


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("index")
    p.add_argument("queries")
    p.add_argument("gt")
    p.add_argument("--nprobe", type=int, default=64)
    p.add_argument("--rk", type=int, nargs="+", default=[32, 64, 128, 256, 512, 1024])
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--score-mode", default="f32", choices=["f32", "bf16lut", "bf16score"],
                   help="f32: the exact oracle; bf16lut: bf16 tables, f32 sums (the dma "
                        "kernel); bf16score: bf16lut with scores rounded to bf16 (the key "
                        "kernel's ranking)")
    args = p.parse_args(argv)
    device = setup_device(args)

    import torch

    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex

    idx = IVFPQIndex.load(args.index, device=device)
    q = load_queries(torch, args.queries, idx.centroids.shape[1], idx.rotation, device)
    gt_ids = np.asarray(gtbin.read_gtbin(args.gt)[1])
    Q, k = gt_ids.shape
    P = min(args.nprobe, idx.nlist)
    probes = _coarse_probes(q, idx.centroids, idx.slot_ids, P, terms=idx.coarse_terms())

    rkmax = max(args.rk)
    hits = {r: 0 for r in args.rk}
    for s in range(0, Q, args.chunk):
        e = min(Q, s + args.chunk)
        pr = probes[s:e]
        scores = chunk_scores(torch, idx, q[s:e], pr, args.score_mode, args.backend)
        # the JAX script's host sort, so that equal scores (frequent at bf16)
        # fall in the same order
        top = np.argsort(-scores.cpu().numpy(), axis=1)[:, :rkmax]
        sids = idx.slot_ids[pr].reshape(e - s, -1).cpu().numpy()
        cand = np.take_along_axis(sids, top, axis=1)
        for r in args.rk:
            hits[r] += sum(len(np.intersect1d(cand[i, :r], gt_ids[s + i]))
                           for i in range(e - s))
        done = {r: hits[r] / (e * k) for r in args.rk}
        print(f"[{e}/{Q}] " + " ".join(f"rk={r}:{v:.4f}" for r, v in done.items()),
              flush=True)
    final = {r: hits[r] / (Q * k) for r in args.rk}
    print("FINAL " + " ".join(f"recall@rk={r}={v:.4f}" for r, v in final.items()))
    return final


if __name__ == "__main__":
    main()
