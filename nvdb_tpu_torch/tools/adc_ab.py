"""Paired A/B of the ADC scan's id modes (the port of ``scripts/adc_ab.py``).

    python -m nvdb_tpu_torch.tools.adc_ab --mode gen4|gen5|gen6 [--nlist 4096]
        [--m 96] [--lcap 1024] [--b 64] [--p 64] [--k 100] [--fill-frac 0.16]
        [--pairs 10] [--chain 10] [--device cuda|cpu]

The index is random and made on the device, with the JAX script's defaults:
codes uniform in [0, 256) [nlist, M, Lcap], prefix-packed lists whose fills
are lognormal around ``--fill-frac`` of Lcap (``np.random.default_rng(7)``,
as ``adc_ab.py:74-80``), slot ids ``list * Lcap + lane``, ``--p`` distinct
probes per query (the key modes rank unique ids, so no list is probed
twice), and random bf16 tables [B, P, M, 256]. The TPU's [B, P, M, 16, 16]
nibble layout has no counterpart. Modes, each a pair of arms timed in turns
(``tools._ab``):

- ``gen4``: ``full`` (``adc_topk_cuda`` with every fill set to Lcap; no slot
  past a list's fill has an id, so it never scores) against ``live`` (the
  list fills): bit-identical by construction;
- ``gen5``: ``dma`` (``adc_topk_cuda``) against ``key``
  (``adc_topk_keys_cuda``); the key mode ranks bf16-truncated scores, so
  the check is ROADMAP §3's: the sorted truncated values equal, and every
  key-mode id's value its ADC score truncated to bf16;
- ``gen6``: ``key`` against ``gather`` (``adc_topk_keys_cuda(gathered=True)``,
  the ``index_select`` of the slab inside the arm, as the JAX script's gather
  sits inside its jitted arm), and in the same turns ``gather_slab``, the
  slab made beforehand: each bit-identical to ``key``.

The TPU-only modes exit 2 naming the reason: ``slim`` (measured slower on
the TPU) and ``gen5diag`` / ``gen6diag`` (timing probes that return wrong
results by design; ``tools.adc_breakdown`` decomposes the CUDA scan).

On the CPU (``--device cpu``) each arm runs its kernel's plain version. A
failed check exits 1. One ``RESULT stage=adc mode= B= P= m= lcap= k= pairs=
chain= fill_frac= <a>_ms= <b>_ms= delta_ms= ci95= <b>_ms_q= id_match=
device= power_limit_w=`` line per compared arm: the JAX script's keys, with
``delta_ms`` = a - b (the TPU's ``g`` and ``chunk`` have no counterpart);
``main`` returns the records.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.tools import _ab
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device

MODES = ("gen4", "gen5", "gen6")
TPU_ONLY = {"slim": "the TPU's all-bf16 intermediates, measured slower there; the CUDA "
                    "scan has no such variant (ROADMAP: do not port)",
            "gen5diag": "a TPU timing probe whose results are wrong by design (ROADMAP: do "
                        "not port); tools.adc_breakdown decomposes the CUDA scan",
            "gen6diag": "a TPU timing probe whose results are wrong by design (ROADMAP: do "
                        "not port); tools.adc_breakdown decomposes the CUDA scan"}


def random_index(torch, device, nlist: int, m: int, lcap: int, fill_frac: float, seed: int = 0):
    """(codes [nlist, M, Lcap] uint8, slot_ids [nlist, Lcap] int32, fills
    [nlist] int32): the JAX script's lognormal prefix fills, ids list * Lcap
    + lane."""
    rng = np.random.default_rng(7)
    f = rng.lognormal(mean=0.0, sigma=0.6, size=nlist) * fill_frac
    fills = np.clip(np.round(f * lcap), 0, lcap).astype(np.int32)
    lane = np.arange(lcap, dtype=np.int32)[None, :]
    sid = np.where(lane < fills[:, None],
                   lane + (np.arange(nlist, dtype=np.int32) * lcap)[:, None], -1)
    g = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 256, (nlist, m, lcap), generator=g, device=device,
                          dtype=torch.uint8)
    return (codes, torch.from_numpy(sid.astype(np.int32)).to(device),
            torch.from_numpy(fills).to(device))


def truncated_scores(torch, lut, probes, codes, ids, lcap):
    """Each id's ADC score truncated to bf16, summed over m in order as the
    kernels do; ids are ``list * Lcap + lane`` of a probed list (-inf at -1)."""
    safe = ids.long().clamp(min=0)
    li, lane = safe // lcap, safe % lcap
    p = (probes.long()[:, :, None] == li[:, None, :]).int().argmax(dim=1)     # [B, k]
    lut = lut.to(torch.float32)
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    for m in range(codes.shape[1]):
        code = codes[li, m, lane].long()
        acc += lut[torch.arange(ids.shape[0], device=ids.device)[:, None], p, m, code]
    score = (-acc) + 0.0
    trunc = (score.view(torch.int32) & -65536).view(torch.float32)
    return torch.where(ids >= 0, trunc, float("-inf"))


def make_arms(torch, mode, lut, probes, codes, slot_ids, fills, k):
    """{arm: function of no arguments} of ``mode``, the kernels on a card
    and their plain versions on the CPU."""
    from nvdb_tpu_torch.kernels import adc_scan

    if not codes.is_cuda:
        keys = lambda codes=codes, gathered=False: adc_scan.adc_topk_keys_reference(
            lut, probes, codes, slot_ids, k, fills=fills, gathered=gathered)
        dma = lambda f=None: adc_scan.adc_topk_reference(lut, probes, codes, slot_ids, k)
    else:
        keys = lambda codes=codes, gathered=False, slab=None: adc_scan.adc_topk_keys_cuda(
            lut, probes, codes, slot_ids, k, fills=fills, gathered=gathered, slab=slab)
        dma = lambda f=fills: adc_scan.adc_topk_cuda(lut, probes, codes, slot_ids, k, fills=f)
    if mode == "gen4":
        full = torch.full_like(fills, codes.shape[2])
        return {"full": lambda: dma(full), "live": lambda: dma(fills)}
    if mode == "gen5":
        return {"dma": lambda: dma(fills), "key": lambda: keys()}
    slab = adc_scan.gather_codes(codes, probes)
    if codes.is_cuda:
        pre = lambda: keys(gathered=True, slab=slab)
    else:
        pre = lambda: keys(codes=slab, gathered=True)
    gather = ((lambda: keys(gathered=True)) if codes.is_cuda
              else (lambda: keys(codes=adc_scan.gather_codes(codes, probes), gathered=True)))
    return {"key": lambda: keys(), "gather": gather, "gather_slab": pre}


def check_mode(torch, mode, outs, lut, probes, codes, lcap):
    """Fails unless the arms agree as the mode's check says; returns the
    id match of the first arm against each other arm."""
    names = list(outs)
    va, ia = outs[names[0]]
    match = {}
    for nb in names[1:]:
        vb, ib = outs[nb]
        match[nb] = float((ia.long() == ib.long()).float().mean())
        if mode in ("gen4", "gen6"):
            if not (torch.equal(va, vb) and torch.equal(ia, ib)):
                fail(f"{mode}: {names[0]} and {nb} are not bit-identical")
            continue
        # gen5: dma (exact f32) against key (bf16-truncated)
        tv = ((va + 0.0).view(torch.int32) & -65536).view(torch.float32)
        tv = torch.where(ia >= 0, tv, float("-inf"))
        if not torch.equal(torch.sort(tv, dim=1, descending=True).values,
                           torch.sort(vb, dim=1, descending=True).values):
            fail("gen5: the key mode's sorted values are not the dma mode's truncated")
        if not torch.equal(truncated_scores(torch, lut, probes, codes, ib, lcap), vb):
            fail("gen5: a key-mode value is not its id's ADC score truncated to bf16")
    return match


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("--mode", default="gen5", help=f"one of {', '.join(MODES)}")
    p.add_argument("--nlist", type=int, default=4096)
    p.add_argument("--m", type=int, default=96)
    p.add_argument("--lcap", type=int, default=1024)
    p.add_argument("--b", type=int, default=64)
    p.add_argument("--p", type=int, default=64)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--fill-frac", type=float, default=0.16)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--chain", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.mode in TPU_ONLY:
        fail(f"--mode {args.mode} is not ported: {TPU_ONLY[args.mode]}", code=2)
    if args.mode not in MODES:
        fail(f"unknown mode {args.mode!r}; modes are {', '.join(MODES)}")
    if args.p > args.nlist:
        fail(f"--p {args.p} distinct probes need at least as many lists (--nlist {args.nlist})")
    device = setup_device(args)

    import torch

    B, P, M, L = args.b, args.p, args.m, args.lcap
    codes, slot_ids, fills = random_index(torch, device, args.nlist, M, L, args.fill_frac,
                                          args.seed)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    lut = torch.randn((B, P, M, 256), generator=g, device=device).to(torch.bfloat16)
    probes = torch.stack([torch.randperm(args.nlist, generator=g, device=device)[:P]
                          for _ in range(B)]).to(torch.int32)
    fm = float(fills.float().mean())
    print(f"# fills: mean={fm:.0f}/{L} ({fm / L:.2%}), max={int(fills.max())}", flush=True)

    arms = make_arms(torch, args.mode, lut, probes, codes, slot_ids, fills, args.k)
    outs = {name: fn() for name, fn in arms.items()}
    match = check_mode(torch, args.mode, outs, lut, probes, codes, L)
    del outs
    summ = _ab.summary(_ab.paired(arms, args.pairs, args.chain, device))
    names = list(arms)
    na = names[0]
    dev = _ab.device_fields(device)
    results = []
    for nb in names[1:]:
        sa, sb = summ[na], summ[nb]
        rec = dict(stage="adc", mode=args.mode, B=B, P=P, m=M, lcap=L, k=args.k,
                   pairs=args.pairs, chain=args.chain, fill_frac=args.fill_frac)
        rec[f"{na}_ms"] = sa["ms"]
        rec[f"{nb}_ms"] = sb["ms"]
        rec.update(delta_ms=-sb["delta_ms"], ci95=sb["delta_ci95_ms"])
        rec[f"{nb}_ms_q"] = sb["ms"] / B
        rec.update(id_match=match[nb], **dev)
        print(result_line(**rec), flush=True)
        results.append(rec)
    return results


if __name__ == "__main__":
    main()
