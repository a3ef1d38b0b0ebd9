"""Paired A/B of the flat-scan top-k (the port of ``scripts/kernel_ab.py``).

    python -m nvdb_tpu_torch.tools.kernel_ab [--n 1000000] [--d 768]
        [--dtype f32|bf16|i8 [--qi8]] [--batches 512,8] [--ks 10]
        [--arms kernel,library] [--iters 20] [--pairs 10] [--check]
        [--device cuda|cpu]

The store is ``nvdb_tpu_torch.bench.synth_store`` (Gaussian rows made on
the device from seed 0, padded to 4,096 rows) and the queries
``synth_queries`` (seed 1): a pool of 2 x max(batches), each sample's
chained calls alternating its two halves, as the JAX script does. Arms:

- ``kernel``: ``flat_topk_cuda``, the store's default instance;
- ``simt``: f32 stores only, ``flat_topk_cuda(f32_kernel="simt")``;
- ``library``: ``torch.matmul`` of the scores (bf16 out for a bf16 store,
  f32 with TF32 off for an f32 one) and ``torch.topk``: a yardstick, on no
  path of the port; it takes f32 and bf16 stores;
- ``plain``: ``flat_topk_reference``, the kernel's plain version.

On the CPU (``--device cpu``) the kernel arms run their plain version. The
TPU script's ``--merges`` (its merge strategies) and ``--tile`` (its VMEM
tile model) have no counterpart in the CUDA kernel.

``--pairs P > 0``: P interleaved samples of ``--iters`` chained calls per
arm (``tools._ab``), each arm's mean with its 95% CI and the paired delta
against the first arm. ``--pairs 0``: one sample per arm. ``--check``
holds each arm's ids, before timing, to a float64 oracle of the inputs as
the arm sees them (bf16-rounded queries on a bf16 or int8 store, the
dequantized int8 store) by score regret, not id order (the tie orders
differ): at most ``REGRET_REL`` of the largest top score, and one bf16 step
of it for the library arm on a bf16 store, whose scores are bf16.

Prints one ``RESULT arm=... B= k= dtype= n= d= [pairs= iters=] ms=
[ci95_ms= delta_vs_<first>_ms= delta_ci95_ms=] qps= gbps= device=
power_limit_w=`` line per (arm, B, k): the JAX script's keys, ``arm`` in
place of ``merge``; ``main`` returns the records. Without a card and
without ``--device cpu`` it exits 1.
"""

from __future__ import annotations

from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.tools import _ab
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device

ARMS = ("kernel", "simt", "library", "plain")
REGRET_REL = 1e-5      # exact arms: float64 regret over the largest top score
BF16_STEP = 2.0 ** -7  # the library arm's bf16 scores: one step of the largest


def oracle_inputs(torch, store, q, qq, qs):
    """float64 (queries, valid rows) as the scan sees them."""
    f64 = torch.float64
    v = store.vectors[:store.n]
    if store.scales is not None:
        rows = v.to(f64) * store.scales[:store.n].to(f64)[:, None]
        if qq is not None:
            return qq.to(f64) * qs.to(f64)[:, None], rows
        return q.to(torch.bfloat16).to(f64), rows
    if v.dtype == torch.bfloat16:
        return q.to(torch.bfloat16).to(f64), v.to(f64)
    return q.to(f64), v.to(f64)


def regret(torch, q64, rows64, ids, k, chunk=1 << 16):
    """(largest float64 score regret of ``ids`` against the true top-k,
    the largest |top score|), the true top-k taken in row chunks."""
    best = None
    for r in range(0, rows64.shape[0], chunk):
        s = q64 @ rows64[r:r + chunk].T
        top = torch.topk(s, min(k, s.shape[1]), dim=1).values
        best = top if best is None else torch.topk(torch.cat([best, top], 1), k, dim=1).values
    safe = ids.long().clamp(min=0)
    got = torch.einsum("bd,bkd->bk", q64, rows64[safe])
    got = torch.where(ids >= 0, got, float("-inf"))
    got = torch.sort(got, dim=1, descending=True).values
    return float((best - got).max()), float(best.abs().max())


def make_arm(torch, arm, store, k, qi8):
    """The arm's function of one query batch (and its int8 pair)."""
    from nvdb_tpu_torch.kernels import flat_scan, ops

    v, sc, n = store.vectors, store.scales, store.n
    card = v.is_cuda
    if arm == "plain" or (not card and arm in ("kernel", "simt")):
        return lambda q, qq, qs: flat_scan.flat_topk_reference(
            qq if qi8 else q, v, sc, n, k, query_scales=qs)
    if arm == "kernel":
        return lambda q, qq, qs: flat_scan.flat_topk_cuda(
            qq if qi8 else q, v, sc, n, k, query_scales=qs)
    if arm == "simt":
        return lambda q, qq, qs: flat_scan.flat_topk_cuda(q, v, None, n, k, f32_kernel="simt")
    rows = v[:n]
    if v.dtype == torch.bfloat16:
        return lambda q, qq, qs: torch.topk(torch.matmul(q.to(torch.bfloat16), rows.T), k, dim=1)

    def library(q, qq, qs):
        ops.no_tf32()
        return torch.topk(torch.matmul(q, rows.T), k, dim=1)
    return library


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16", "i8"])
    p.add_argument("--qi8", action="store_true",
                   help="with --dtype i8: quantize the queries too (int8 x int8)")
    p.add_argument("--batches", default="512")
    p.add_argument("--ks", default="10")
    p.add_argument("--arms", default="kernel,library",
                   help=f"comma-separated, from {','.join(ARMS)}; deltas against the first")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--check", action="store_true",
                   help="hold every arm to the float64 oracle by score regret")
    args = p.parse_args(argv)
    arms = args.arms.split(",")
    for arm in arms:
        if arm not in ARMS:
            fail(f"unknown arm {arm!r}; arms are {', '.join(ARMS)}")
    if args.qi8 and args.dtype != "i8":
        fail("--qi8 requires --dtype i8")
    if "simt" in arms and args.dtype != "f32":
        fail("the simt arm scores f32 stores only")
    if "library" in arms and args.dtype == "i8":
        fail("the library arm takes f32 and bf16 stores: no single PyTorch call scores "
             "an int8 store")
    device = setup_device(args)

    import torch

    from nvdb_tpu_torch.bench import synth_queries, synth_store
    from nvdb_tpu_torch.index.flat import quantize_queries_i8

    store = synth_store(args.n, args.d, args.dtype, device, seed=0)
    batches = [int(b) for b in args.batches.split(",")]
    qpool = synth_queries(2 * max(batches), store, seed=1)
    bpe = store.vectors.element_size()
    gbytes = store.n_padded * store.d_padded * bpe / 1e9
    dev = _ab.device_fields(device)
    results = []
    for B in batches:
        halves = [qpool[:B], qpool[B:2 * B]]
        pairs = [(q,) + (quantize_queries_i8(q) if args.qi8 else (None, None)) for q in halves]
        for k in (int(x) for x in args.ks.split(",")):
            fns = {arm: make_arm(torch, arm, store, k, args.qi8) for arm in arms}
            if args.check:
                q64, rows64 = oracle_inputs(torch, store, *pairs[0])
                for arm, fn in fns.items():
                    _, ids = fn(*pairs[0])
                    rg, top = regret(torch, q64, rows64, ids, k)
                    bf16_lib = arm == "library" and args.dtype == "bf16"
                    tol = (BF16_STEP if bf16_lib else REGRET_REL) * max(top, 1.0)
                    print(f"# check arm={arm} B={B} k={k}: float64 regret {rg:.3e} "
                          f"(tolerance {tol:.3e})", flush=True)
                    if not rg <= tol:
                        fail(f"--check: arm {arm} B={B} k={k} float64 regret {rg} > {tol}")
                del q64, rows64

            def chained(fn):
                state = {"i": 0}

                def call():
                    state["i"] += 1
                    return fn(*pairs[state["i"] % 2])
                return call

            samples = _ab.paired({arm: chained(fn) for arm, fn in fns.items()},
                                 max(args.pairs, 1), args.iters, device)
            summ = _ab.summary(samples)
            for arm in arms:
                s = summ[arm]
                rec = dict(arm=arm, B=B, k=k, dtype=args.dtype, n=args.n, d=args.d)
                if args.qi8:
                    rec["qi8"] = 1
                if args.pairs > 0:
                    rec.update(pairs=args.pairs, iters=args.iters, ms=s["ms"],
                               ci95_ms=s["ci95_ms"])
                    rec[f"delta_vs_{arms[0]}_ms"] = s["delta_ms"]
                    rec["delta_ci95_ms"] = s["delta_ci95_ms"]
                else:
                    rec["ms"] = s["ms"]
                rec.update(qps=B / s["ms"] * 1e3, gbps=gbytes / s["ms"] * 1e3, **dev)
                print(result_line(**rec), flush=True)
                results.append(rec)
    return results


if __name__ == "__main__":
    main()
