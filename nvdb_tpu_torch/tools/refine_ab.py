"""Paired A/B of the exact refine (the port of ``scripts/refine_ab.py``):
the rerank kernel against the gather path, per (B, R).

    python -m nvdb_tpu_torch.tools.refine_ab [--n 1000000] [--d 768]
        [--dtype f32|bf16|i8] [--batches 8,64,256] [--rs 50,100] [--k 10]
        [--pairs 10] [--chain 20] [--check] [--device cuda|cpu]

Arms, interleaved cuda, oracle, cuda, ... (``tools._ab``):

- ``cuda``: ``rerank_topk_cuda``, the default refine on a card (on the CPU
  its plain version, ``rerank_topk_reference``), metric l2 with the store's
  cached norms;
- ``oracle``: ``dispatch.oracle_refine``, the gather path that ``auto``
  takes for CPU tensors: the candidate rows gathered into a [B, R, Dp] f32
  slab and ``ops.exact_rerank``; the counterpart of the JAX script's
  ``_refine_block(backend="jnp")``.

The store is Gaussian rows from ``np.random.default_rng(seed)`` (in
blocks, padded to 4,096 rows; int8 rows quantized per row, max-abs / 127),
the queries [max(B), Dp] from ``seed + 1``, and each query's R candidate ids
uniform in [0, n) from ``seed + 2`` (repeats allowed, as the JAX script's
``randint``). ``--check`` holds both arms, before timing, to a float64
oracle of the candidates' l2 scores by score regret (at most
``REGRET_REL`` of the largest top score; a repeated candidate can take two
places in the oracle arm, never in the kernel's) and prints their id match.

One ``RESULT stage=refine B= R= k= dtype= n= pairs= chain= cuda_ms=
oracle_ms= delta_ms= ci95= cuda_ms_q= oracle_ms_q= device= power_limit_w=``
line per (B, R): the JAX script's keys (``pallas`` / ``jnp`` become
``cuda`` / ``oracle``), ``delta_ms`` = cuda - oracle with its paired 95%
CI; ``main`` returns the records. This measures the H100's answer to the
TPU's refine crossover ``B*R <= 3200`` (``nvdb_tpu/kernels/dispatch.py:45``),
which the port does not carry. Without a card and without ``--device cpu``
it exits 1.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.tools import _ab
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device

REGRET_REL = 1e-5     # float64 regret over the largest top score
_BLOCK = 1 << 18      # rows drawn per numpy block


def numpy_store(torch, n: int, d: int, dtype: str, device, seed: int):
    """A padded ``VectorStore`` of ``n`` Gaussian rows drawn by numpy in
    blocks and encoded on ``device``."""
    from nvdb_tpu_torch.formats import vecbin
    from nvdb_tpu_torch.store import VectorStore
    from nvdb_tpu_torch.utils import round_up

    code = vecbin.dtype_code(dtype)
    Np, Dp = round_up(n, 4096), round_up(d, 128)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8}[dtype]
    vecs = torch.zeros((Np, Dp), dtype=tdt, device=device)
    scales = torch.ones((Np,), dtype=torch.float32, device=device) if dtype == "i8" else None
    rng = np.random.default_rng(seed)
    for r0 in range(0, n, _BLOCK):
        r1 = min(r0 + _BLOCK, n)
        x = torch.from_numpy(rng.standard_normal((r1 - r0, d), dtype=np.float32)).to(device)
        if dtype == "i8":
            amax = x.abs().amax(dim=1)
            sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            vecs[r0:r1, :d] = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(tdt)
            scales[r0:r1] = sc
        else:
            vecs[r0:r1, :d] = x.to(tdt)
    return VectorStore(vecs, scales, n, d, code, code)


def regret(torch, q, cand, store, ids):
    """(largest float64 l2-score regret of ``ids`` against the best k
    distinct candidates, the largest |top score|)."""
    f64 = torch.float64
    k = ids.shape[1]

    def score(i):
        safe = i.long().clamp(min=0)
        r = store.vectors[safe].to(f64)
        if store.scales is not None:
            r = r * store.scales[safe].to(f64)[..., None]
        s = 2.0 * torch.einsum("bd,brd->br", q.to(f64), r) - (r * r).sum(-1)
        return torch.where(i >= 0, s, float("-inf"))

    sc = score(cand)
    # each id once: a repeat of an id scores -inf past its first place
    srt, order = torch.sort(cand, dim=1)
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    uniq = torch.ones_like(dup).scatter(1, order, ~dup)
    best = torch.topk(torch.where(uniq, sc, float("-inf")), k, dim=1).values
    got = torch.sort(score(ids), dim=1, descending=True).values
    return float((best - got).max()), float(best.abs().max())


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16", "i8"])
    p.add_argument("--batches", default="8,64,256")
    p.add_argument("--rs", default="50,100")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check", action="store_true",
                   help="hold both arms to the float64 oracle by score regret")
    args = p.parse_args(argv)
    device = setup_device(args)

    import torch

    from nvdb_tpu_torch.kernels import dispatch, rerank

    store = numpy_store(torch, args.n, args.d, args.dtype, device, args.seed)
    norms2 = store.norms2()
    v, sc = store.vectors, store.scales
    batches = [int(b) for b in args.batches.split(",")]
    rs = [int(r) for r in args.rs.split(",")]
    bmax, rmax = max(batches), max(rs)
    qpool = np.zeros((bmax, store.d_padded), np.float32)
    qpool[:, :args.d] = np.random.default_rng(args.seed + 1).standard_normal(
        (bmax, args.d), dtype=np.float32)
    qpool = torch.from_numpy(qpool).to(device)
    cpool = torch.from_numpy(np.random.default_rng(args.seed + 2).integers(
        0, args.n, (bmax, rmax), dtype=np.int32)).to(device)
    kernel = rerank.rerank_topk_cuda if device.type == "cuda" else rerank.rerank_topk_reference
    dev = _ab.device_fields(device)
    results = []
    for B in batches:
        for R in rs:
            q = qpool[:B]
            cand = cpool[:B, :R].contiguous()
            arms = {"cuda": lambda: kernel(q, cand, v, sc, args.k, norms2=norms2, metric="l2"),
                    "oracle": lambda: dispatch.oracle_refine(q, cand, v, sc, args.k,
                                                             metric="l2")}
            if args.check:
                (_, ic), (_, io) = arms["cuda"](), arms["oracle"]()
                match = float((ic.long() == io.long()).float().mean())
                for name, ids in (("cuda", ic), ("oracle", io)):
                    rg, top = regret(torch, q, cand, store, ids)
                    tol = REGRET_REL * max(top, 1.0)
                    print(f"# check B={B} R={R} arm={name}: float64 regret {rg:.3e} "
                          f"(tolerance {tol:.3e}); cuda-vs-oracle id match {match:.4f}",
                          flush=True)
                    if not rg <= tol:
                        fail(f"--check: arm {name} B={B} R={R} float64 regret {rg} > {tol}")
            s = _ab.paired(arms, args.pairs, args.chain, device)
            summ = _ab.summary(s)
            c, o = summ["cuda"]["ms"], summ["oracle"]["ms"]
            rec = dict(stage="refine", B=B, R=R, k=args.k, dtype=args.dtype, n=args.n,
                       pairs=args.pairs, chain=args.chain, cuda_ms=c, oracle_ms=o,
                       delta_ms=-summ["oracle"]["delta_ms"],
                       ci95=summ["oracle"]["delta_ci95_ms"], cuda_ms_q=c / B,
                       oracle_ms_q=o / B, **dev)
            print(result_line(**rec), flush=True)
            results.append(rec)
    return results


if __name__ == "__main__":
    main()
