"""IVF-PQ ADC candidate top-k: the wrappers of the CUDA kernels in
``csrc/adc_topk.cu`` (the port of ``nvdb_tpu.kernels.adc_scan.pallas_adc_topk``
in its three id modes) and their plain PyTorch versions; and the bf16 ADC
tables they read: the wrapper of ``csrc/adc_tables.cu`` and its plain
version (in exact arithmetic ``pq.adc_lut`` then the bf16 cast, which the
JAX package leaves to XLA; here each entry is built from a query's, a
list's and a pair's share, ``csrc/adc_table_math.cuh``, with the kernels'
f32 FMA chains, so kernel and plain version agree bit for bit).

All modes score slot l of probed list p by -sum_m bf16(lut[b, p, m, code]),
summed in f32 over m in order, and return the top kk (kk <= 1024) with
(-inf, -1) fill after the real candidates.

- ``dma`` (``adc_topk_cuda``, ``adc_topk_reference``): slots whose id is -1
  never score; one slot per id (its best score; replicated indexes); ranked
  by (score desc, id desc).
- ``key`` (``adc_topk_keys_cuda``, ``adc_topk_keys_reference``): on a
  prefix-packed index with unique ids (replicas == 1) the lanes below the
  list's fill are live; each score is truncated to bf16 (low 16 bits of its
  f32 pattern cleared, toward zero) and candidates rank by (truncated score
  desc, coordinate desc), coordinate = p * Lcap + lane; the winners' ids are
  read from ``slot_ids[probes[b, p], lane]`` and returned beside their
  truncated scores.
- ``gather``: the key mode's result bit for bit. The TPU kernel scans a
  slab of the probed lists that XLA gathers first, because the TPU paid
  for each per-list DMA it issued; on the card each probed list's codes are
  one contiguous block of ``codes`` that a CTA copies itself, so the IVF-PQ
  path's gather mode is the fused key scan below, which reads the lists in
  place. The slab route stays as its A/B: ``adc_topk_keys_cuda(...,
  gathered=True)``, the key mode over ``gather_codes(codes, probes)`` [B *
  P, M, Lcap].
- fused key scan (``adc_fused_keys_cuda``, ``adc_fused_keys_reference``):
  the key mode from the rotated queries, probes, centroids and codebooks,
  bit for bit ``adc_topk_keys_cuda`` on ``adc_tables_cuda``'s tables, with
  each pair's tables built in shared memory from each entry's query share
  (the query-term pass it opens with, ``adc_query_terms_cuda`` /
  ``adc_query_terms_reference``: once a query), its list share (once a
  list) and the pair's residual norm, list-major (the pairs grouped
  by list, each probed list read once for a chunk of queries); the key and
  gather modes of the IVF-PQ path. ``adc_topk_keys_listmajor_reference`` is
  the key mode's plain scan walked the same way, bit for bit
  ``adc_topk_keys_reference``.
- fused dma scan (``adc_fused_topk_cuda``, ``adc_fused_topk_reference``):
  the dma mode the same way, bit for bit ``adc_topk_cuda`` on
  ``adc_tables_cuda``'s tables; the dma mode of the IVF-PQ path (ADC-only
  searches, replicated indexes, lists with holes). The staged route (the
  table kernel, then ``adc_topk_cuda``) is its A/B.

The TPU kernel's nibble one-hot matmul works around the TPU's lack of a
fast gather and is not carried over. The ``*_cuda`` wrappers launch their
kernels on CUDA tensors and raise on any other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.kernels import ops, pq
from nvdb_tpu_torch.kernels.flat_scan import check_tensor, require_cuda
from nvdb_tpu_torch.utils import cdiv

MAX_K = 1024
_CTAS_PER_SM = 2     # pass-1 CTAs per SM the probe split aims for
_TABLE_CTAS_PER_SM = 4   # CTAs per SM the table kernel's walk is split into
_SMEM_LIMIT = 227 * 1024 - 1024   # a CTA's shared memory, less the kernel's static part

# Launches of the scan kernel since the last reset. Only adc_topk_cuda's
# launch adds to it.
LAUNCHES = 0
# Launches of the table kernel; only adc_tables_cuda's launch adds to it.
TABLE_LAUNCHES = 0
# Launches of the key kernel and of its gather instance over the code slab
# (the gather mode's A/B); only adc_topk_keys_cuda's launch adds to them, to
# the one of its mode.
KEY_LAUNCHES = 0
GATHER_LAUNCHES = 0
# Key modes: a probe group's coordinates fit 16 bits of a candidate key.
COORD_SPAN = 1 << 16


def list_fills(slot_ids: torch.Tensor) -> torch.Tensor:
    """Per-list fill = 1 + index of the last live slot (0 if none)."""
    live = slot_ids >= 0
    lane = torch.arange(1, slot_ids.shape[1] + 1, device=slot_ids.device,
                        dtype=torch.int32)
    return torch.amax(torch.where(live, lane, 0), dim=1).to(torch.int32)


def is_prefix_packed(slot_ids: torch.Tensor) -> bool:
    """True iff every list's live slots are exactly a prefix."""
    live = slot_ids >= 0
    fills = list_fills(slot_ids)
    lane = torch.arange(slot_ids.shape[1], device=slot_ids.device)[None, :]
    return bool(torch.all(live == (lane < fills[:, None])))


def _pow2_at_least(x: int) -> int:
    c = 1
    while c < x:
        c <<= 1
    return c


def adc_topk_reference(
    lut: torch.Tensor,        # [B, P, M, 256] f32 or bf16 ADC tables
    probes: torch.Tensor,     # [B, P] int probed list ids
    codes: torch.Tensor,      # [nlist, M, Lcap] uint8 (transposed PQ codes)
    slot_ids: torch.Tensor,   # [nlist, Lcap] int32 (-1 padding)
    k: int,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, chunked over queries so the
    gathered code slab stays near 256 MB (at the flagship shape a whole
    batch's [B, P, M, Lcap] int64 index would be 8 GB)."""
    B, P = probes.shape
    nlist, M, L = codes.shape
    if q_chunk is None:
        q_chunk = max(1, (256 << 20) // max(1, P * M * L))
    lut = lut.to(torch.bfloat16).to(torch.float32)
    probes = probes.long()
    vals, ids = [], []
    for s in range(0, B, q_chunk):
        pr = probes[s:s + q_chunk]                             # [c, P]
        slab = codes[pr]                                       # [c, P, M, L]
        acc = torch.zeros(pr.shape + (L,), dtype=torch.float32, device=lut.device)
        for m in range(M):
            acc += torch.gather(lut[s:s + q_chunk, :, m, :], -1, slab[:, :, m, :].long())
        sids = slot_ids[pr]                                    # [c, P, L]
        scores = torch.where(sids >= 0, -acc, ops.NEG_INF)
        v, i = ops.dedup_topk(scores.reshape(pr.shape[0], -1),
                              sids.reshape(pr.shape[0], -1).to(torch.int32), k)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def scan_plan(k: int, M: int, L: int, key_bytes: int = 8) -> Tuple[int, int]:
    """(stages, tile) of pass 1's ring (``csrc/adc_topk.cu``): a stage holds
    one probe's bf16 table (M x 512 bytes) and a tile of its codes (M rows
    of ``tile`` slots); the key buffer holds pow2(max(1024, k + 512)) keys
    of ``key_bytes`` (8 in the dma mode, 4 in the key modes). Two stages of
    whole lists where a CTA's shared memory allows, else narrower tiles
    (multiples of 128 slots), else one stage. Raises when one table and a
    128-slot tile do not fit."""
    cap = _pow2_at_least(max(1024, k + 512))
    for stages in (2, 1):
        room = (_SMEM_LIMIT - cap * key_bytes) // stages - M * 512
        tile = L if room >= M * L else (room // M) // 128 * 128
        if tile >= min(L, 128):
            return stages, tile
    raise ValueError(f"k={k} with M={M} exceeds the kernel's shared memory")


def bind_adc_topk(fn):
    """Declare the C signature of ``nvdb_adc_topk`` on a loaded symbol."""
    # 8 pointers, B, P, M, Lcap, nlist, kk, S, stages, tile, stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    return bind_adc_topk(_build.load("adc_topk").nvdb_adc_topk)


@functools.cache
def _keys_lib():
    """The key modes' C entry point (the same library as ``_lib``)."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("adc_topk").nvdb_adc_topk_keys
    # 8 pointers, B, P, M, Lcap, nlist, kk, S, stages, tile, gathered, stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _probe_groups(batch: int, P: int, device: torch.device) -> int:
    """Probe groups S of pass 1: about ``_CTAS_PER_SM`` CTAs per SM at any
    batch, never more groups than probes."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(P, cdiv(_CTAS_PER_SM * n_sm, batch)))


def adc_topk_cuda(
    lut: torch.Tensor,        # [B, P, M, 256] f32 or bf16 ADC tables
    probes: torch.Tensor,     # [B, P] int32 probed list ids
    codes: torch.Tensor,      # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,   # [nlist, Lcap] int32 (-1 padding)
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills), cached by callers
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k over each query's probed lists; the contract of
    ``adc_topk_reference``. Returns (vals [B, k] f32, ids [B, k] int32)."""
    global LAUNCHES
    require_cuda(codes, "adc_topk")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    dev = codes.device
    if codes.dim() != 3 or lut.dim() != 4 or probes.dim() != 2:
        raise ValueError("lut [B, P, M, 256], probes [B, P], codes [nlist, M, Lcap]")
    nlist, M, L = codes.shape
    B, P = probes.shape
    if L % 16 != 0:
        raise ValueError(f"list capacity {L} is not a multiple of 16 (the kernel "
                         f"copies code rows in 16-byte pieces)")
    stages, tile = scan_plan(k, M, L)
    lut = lut.to(torch.bfloat16).contiguous()
    probes = probes.to(torch.int32).contiguous()
    if fills is None:
        fills = list_fills(slot_ids)
    check_tensor(lut, "lut", dev, (torch.bfloat16,), (B, P, M, 256))
    check_tensor(probes, "probes", dev, (torch.int32,), (B, P))
    check_tensor(codes, "codes", dev, (torch.uint8,), (nlist, M, L))
    check_tensor(slot_ids, "slot_ids", dev, (torch.int32,), (nlist, L))
    check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))

    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or P == 0:
        vals.fill_(ops.NEG_INF)
        ids.fill_(-1)
        return vals, ids
    S = _probe_groups(B, P, dev)
    part_keys = torch.empty((B, S, k), dtype=torch.int64, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lut.data_ptr(), probes.data_ptr(), codes.data_ptr(), slot_ids.data_ptr(),
                fills.data_ptr(), part_keys.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                B, P, M, L, nlist, k, S, stages, tile, stream)
    if rc != 0:
        raise RuntimeError(f"adc_topk kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return vals, ids


def gather_codes(codes: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """The slab of the gather mode's A/B route: the probed lists' codes [B *
    P, M, Lcap], row b * P + p holding list probes[b, p] (list 0 for a probe
    out of range, which no mode reads). The counterpart of the XLA gather of
    the TPU kernel (``adc_scan.py:699``); at B = 256, P = 64, M = 96, Lcap =
    640 it is 1.007 GB."""
    flat = probes.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < codes.shape[0]), flat, 0)
    return codes.index_select(0, flat)


def _mono16(trunc: torch.Tensor) -> torch.Tensor:
    """int64 monotone 16 bits of bf16-truncated f32 scores (their order)."""
    h = (trunc.view(torch.int32) >> 16).to(torch.int64) & 0xFFFF
    return torch.where(h >= 0x8000, ~h & 0xFFFF, h | 0x8000)


def adc_topk_keys_reference(
    lut: torch.Tensor,        # [B, P, M, 256] f32 or bf16 ADC tables
    probes: torch.Tensor,     # [B, P] int probed list ids
    codes: torch.Tensor,      # [nlist, M, Lcap] uint8, or gathered: [B * P, M, Lcap]
    slot_ids: torch.Tensor,   # [nlist, Lcap] int32, prefix-packed, unique ids
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills)
    gathered: bool = False,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the key (and, on a ``gather_codes``
    slab, the gather) kernel: the module docstring's key-mode contract.
    Chunked over queries as ``adc_topk_reference``."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    B, P = probes.shape
    M, L = codes.shape[1:]
    nlist = slot_ids.shape[0]
    if fills is None:
        fills = list_fills(slot_ids)
    if q_chunk is None:
        q_chunk = max(1, (256 << 20) // max(1, P * M * L))
    lut = lut.to(torch.bfloat16).to(torch.float32)
    probes = probes.long()
    ok = (probes >= 0) & (probes < nlist)
    safe = torch.where(ok, probes, 0)
    fill = torch.where(ok, fills.long()[safe], 0)                      # [B, P]
    lane = torch.arange(L, device=codes.device)
    coord = (torch.arange(P, device=codes.device)[:, None] * L + lane).reshape(-1)
    vals, ids = [], []
    for s in range(0, B, q_chunk):
        pr = safe[s:s + q_chunk]                                       # [c, P]
        c = pr.shape[0]
        rows = (torch.arange(s, s + c, device=codes.device)[:, None] * P
                + torch.arange(P, device=codes.device)) if gathered else pr
        slab = codes[rows]                                             # [c, P, M, L]
        acc = torch.zeros((c, P, L), dtype=torch.float32, device=lut.device)
        for m in range(M):
            acc += torch.gather(lut[s:s + c, :, m, :], -1, slab[:, :, m, :].long())
        score = (-acc) + 0.0                                           # -0 -> +0
        trunc = (score.view(torch.int32) & -65536).view(torch.float32).reshape(c, -1)
        live = (lane < fill[s:s + c, :, None]).reshape(c, -1)
        key = torch.where(live, (_mono16(trunc) << 32) | coord, -1)
        top, at = torch.topk(key, min(k, P * L), dim=1)
        hit = top >= 0
        cd = top & 0xFFFFFFFF
        li = torch.gather(pr, 1, torch.where(hit, cd // L, 0))
        rid = slot_ids[li, torch.where(hit, cd % L, 0)]
        v = torch.where(hit, torch.gather(trunc, 1, at), ops.NEG_INF)
        i = torch.where(hit, rid, -1).to(torch.int32)
        if v.shape[1] < k:
            v = torch.cat([v, v.new_full((c, k - v.shape[1]), ops.NEG_INF)], dim=1)
            i = torch.cat([i, i.new_full((c, k - i.shape[1]), -1)], dim=1)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def key_groups(S: int, P: int, L: int) -> int:
    """Probe groups of the key kernels' pass 1: at least ``S``, and enough
    that each group's Lcap sum, ceil(P / groups) * L, fits a 16-bit
    coordinate. Raises when one list does not."""
    if L > COORD_SPAN:
        raise ValueError(f"list capacity {L} exceeds the key kernels' 16-bit "
                         f"coordinate ({COORD_SPAN} lanes): use ids_mode='dma'")
    return min(P, max(S, cdiv(P, COORD_SPAN // L)))


def adc_topk_keys_cuda(
    lut: torch.Tensor,        # [B, P, M, 256] f32 or bf16 ADC tables
    probes: torch.Tensor,     # [B, P] int32 probed list ids
    codes: torch.Tensor,      # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,   # [nlist, Lcap] int32, prefix-packed, unique ids
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills), cached by callers
    gathered: bool = False,
    slab: Optional[torch.Tensor] = None,   # gathered: gather_codes(codes, probes), made before
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The key kernel, or with ``gathered`` the gather kernel over
    ``gather_codes(codes, probes)`` (1.007 GB at B = 256, P = 64, M = 96,
    Lcap = 640; made whole, not in chunks, unless the caller passes it as
    ``slab``). The contract of ``adc_topk_keys_reference``; the caller
    guarantees a prefix-packed index with unique ids. Returns (vals [B, k]
    f32, ids [B, k] int32)."""
    global KEY_LAUNCHES, GATHER_LAUNCHES
    require_cuda(codes, "adc_topk_keys")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    dev = codes.device
    if codes.dim() != 3 or lut.dim() != 4 or probes.dim() != 2:
        raise ValueError("lut [B, P, M, 256], probes [B, P], codes [nlist, M, Lcap]")
    nlist, M, L = codes.shape
    B, P = probes.shape
    if L % 16 != 0:
        raise ValueError(f"list capacity {L} is not a multiple of 16 (the kernel "
                         f"copies code rows in 16-byte pieces)")
    key_groups(1, P, L)   # raises on a list wider than a 16-bit coordinate
    stages, tile = scan_plan(k, M, L, key_bytes=4)
    lut = lut.to(torch.bfloat16).contiguous()
    probes = probes.to(torch.int32).contiguous()
    if fills is None:
        fills = list_fills(slot_ids)
    check_tensor(lut, "lut", dev, (torch.bfloat16,), (B, P, M, 256))
    check_tensor(probes, "probes", dev, (torch.int32,), (B, P))
    check_tensor(codes, "codes", dev, (torch.uint8,), (nlist, M, L))
    check_tensor(slot_ids, "slot_ids", dev, (torch.int32,), (nlist, L))
    check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))

    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or P == 0:
        vals.fill_(ops.NEG_INF)
        ids.fill_(-1)
        return vals, ids
    S = key_groups(_probe_groups(B, P, dev), P, L)
    if slab is not None:
        if not gathered:
            raise ValueError("a slab goes with gathered=True")
        check_tensor(slab, "slab", dev, (torch.uint8,), (B * P, M, L))
    src = (slab if slab is not None else gather_codes(codes, probes)) if gathered else codes
    part_keys = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    fn = _keys_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lut.data_ptr(), probes.data_ptr(), src.data_ptr(), slot_ids.data_ptr(),
                fills.data_ptr(), part_keys.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                B, P, M, L, nlist, k, S, stages, tile, int(gathered), stream)
    if rc != 0:
        raise RuntimeError(f"adc_topk_keys kernel launch failed: cudaError_t {rc}")
    if gathered:
        GATHER_LAUNCHES += 1
    else:
        KEY_LAUNCHES += 1
    return vals, ids


def live_probes(probes: torch.Tensor, fills: torch.Tensor) -> torch.Tensor:
    """[B, P] bool: probes of a list in range that holds a live slot."""
    nlist = fills.shape[0]
    ok = (probes >= 0) & (probes < nlist)
    return ok & (fills[torch.where(ok, probes, 0).long()] > 0)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf(a, b, c)``: a * b + c rounded once to f32, as the kernels
    compute it. The product of two f32 values is exact in float64 and the
    float64 sum's own error is recovered exactly (TwoSum), so the one case
    where rounding the float64 sum to f32 would round twice, a sum that
    lands halfway between two f32 values, is settled by that error's sign."""
    p = a.double() * b.double()
    c = c.double()
    hi = p + c
    v = hi - p
    lo = (p - (hi - v)) + (c - v)
    r = hi.float()
    back = r.double()
    toward = torch.where(hi > back, torch.inf, -torch.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    tie = (lo != 0) & (hi != back) & ((back + other.double()) * 0.5 == hi)
    return torch.where(tie, torch.where(lo > 0, torch.maximum(r, other),
                                        torch.minimum(r, other)), r)


def fma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_d a[..., d] * b[..., d] (broadcast) as the kernels compute it: one
    f32 FMA chain from 0 over d = 0, 1, ... in order (adc_table_math.cuh)."""
    s = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dtype=torch.float32,
                    device=a.device)
    for d in range(a.shape[-1]):
        s = _fma(a[..., d], b[..., d], s)
    return s


def adc_query_terms_reference(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    codebooks: torch.Tensor,   # [M, 256, dsub] f32
) -> torch.Tensor:
    """The plain version of the query-term pass: [B, M, 256] f32,
    ``c2 - 2 q_m . cb[m, j]`` with q_m the query's slice of subspace m and c2
    = |cb[m, j]|^2, each a chain of FMAs (``fma_chain``) and the combination
    rounded once (2 q . cb is exact): the query's share of each ADC table
    entry (``adc_tables_reference``), the kernel's bits."""
    m, _, dsub = codebooks.shape
    q = q_rot[:, :m * dsub].reshape(q_rot.shape[0], m, 1, dsub)
    return fma_chain(codebooks, codebooks)[None] - 2.0 * fma_chain(q, codebooks[None])


def adc_tables_reference(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32
    fills: torch.Tensor,       # [nlist] int32 (list_fills)
) -> torch.Tensor:
    """The plain version of the table kernel: each probe's bf16 tables [B,
    P, M, 256], entry ``bf16((r2 + 2 c_m . cb_j) + (c2 - 2 q_m . cb_j))`` for
    the query q, the probed list's centroid c and the residual's squared
    norm r2 = |q_m - c_m|^2, which is ||res_m - cb_j||^2 (``pq.adc_lut``) in
    exact arithmetic. The dots and norms are the kernels' FMA chains
    (``fma_chain``), the query's share ``adc_query_terms_reference``, the
    list's once a distinct probed list (1,024 lists at a time), the
    combinations rounded once each in that order: the kernels' bits. Probes
    of a dead or out-of-range list get zeros (the scan reads nothing of them)."""
    B, P = probes.shape
    m, _, dsub = codebooks.shape
    live = live_probes(probes, fills)
    safe = torch.where(live, probes, 0).long()
    lists, where = torch.unique(safe, return_inverse=True)              # where: [B, P]
    cent = centroids[:, :m * dsub].reshape(centroids.shape[0], m, 1, dsub)
    ldot = torch.cat([fma_chain(cent[lists[s:s + 1024]], codebooks[None])
                      for s in range(0, lists.numel(), 1024)])          # [lists, M, 256]
    q = q_rot[:, :m * dsub].reshape(B, 1, m, dsub)
    res = q - centroids[safe][:, :, :m * dsub].reshape(B, P, m, dsub)  # one rounding each
    r2 = fma_chain(res, res)                                           # [B, P, M]
    qterm = adc_query_terms_reference(q_rot, codebooks)                # [B, M, 256]
    lut = ((r2[..., None] + 2.0 * ldot[where]) + qterm[:, None]).to(torch.bfloat16)
    return torch.where(live[:, :, None, None], lut, 0.0)


@functools.cache
def _tables_lib():
    """The table kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("adc_tables").nvdb_adc_tables
    # 7 pointers, B, P, Dp, M, dsub, nlist, ctas, stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adc_tables_cuda(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int32 probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32, M * dsub == Dp
    fills: torch.Tensor,       # [nlist] int32 (list_fills)
) -> torch.Tensor:
    """bf16 ADC tables [B, P, M, 256], bit for bit ``adc_tables_reference``:
    the query-term pass (``adc_query_terms_cuda``, one launch on its counter),
    then the table kernel, which reads each entry's query share from it."""
    global TABLE_LAUNCHES
    require_cuda(codebooks, "adc_tables")
    if q_rot.dim() != 2 or probes.dim() != 2 or centroids.dim() != 2 or codebooks.dim() != 3:
        raise ValueError("q_rot [B, Dp], probes [B, P], centroids [nlist, Dp], "
                         "codebooks [M, 256, dsub]")
    dev = codebooks.device
    B, Dp = q_rot.shape
    P = probes.shape[1]
    nlist = centroids.shape[0]
    M, ksub, dsub = codebooks.shape
    if ksub != pq.KSUB or M * dsub != Dp:
        raise ValueError(f"codebooks {tuple(codebooks.shape)} do not split dim {Dp} "
                         f"into M x {pq.KSUB} codewords")
    check_tensor(q_rot, "q_rot", dev, (torch.float32,), (B, Dp))
    check_tensor(probes, "probes", dev, (torch.int32,), (B, P))
    check_tensor(centroids, "centroids", dev, (torch.float32,), (nlist, Dp))
    check_tensor(codebooks, "codebooks", dev, (torch.float32,), (M, ksub, dsub))
    check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))
    lut = torch.empty((B, P, M, pq.KSUB), dtype=torch.bfloat16, device=dev)
    if B == 0 or P == 0:
        return lut
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = _tables_lib()
    qterms = adc_query_terms_cuda(q_rot, codebooks)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q_rot.data_ptr(), qterms.data_ptr(), probes.data_ptr(), centroids.data_ptr(),
                codebooks.data_ptr(), fills.data_ptr(), lut.data_ptr(), B, P, Dp, M, dsub,
                nlist, _TABLE_CTAS_PER_SM * n_sm, stream)
    if rc != 0:
        raise RuntimeError(f"adc_tables kernel launch failed: cudaError_t {rc}")
    TABLE_LAUNCHES += 1
    return lut


# -- the fused key scan ----------------------------------------------------------

# Launches of the fused key scan (the key and gather modes); only
# adc_fused_keys_cuda's launch adds to it, and ``index/graphs.py`` keeps it to
# the kernels that ran: a served chain's capture adds nothing, each replay
# adds its launches.
FUSED_LAUNCHES = 0
# The widest query chunk the fused scan's plan may take, and the batch below
# which it takes one query a chunk (few pairs then share a list, and a wide
# chunk's registers cost more than its shared codebook reads save);
# chip_smoke.py phase 9 sweeps 1 / 4 / 8 / 16 / 32 (PERF.md).
FUSED_NQ_MAX = 8
FUSED_CHUNK_MIN_BATCH = 32
FUSED_TILE = 768         # lanes a fused CTA takes (three a thread): a list's tiles are CTAs


def _mono16_score(m: torch.Tensor) -> torch.Tensor:
    """f32 truncated scores of 16 monotone bits (``_mono16``'s inverse)."""
    h = torch.where(m >= 0x8000, m & 0x7FFF, ~m & 0xFFFF)
    return (h << 16).to(torch.int32).view(torch.float32)


def adc_topk_keys_listmajor_reference(
    lut: torch.Tensor,        # [B, P, M, 256] f32 or bf16 ADC tables
    probes: torch.Tensor,     # [B, P] int probed list ids
    codes: torch.Tensor,      # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,   # [nlist, Lcap] int32, prefix-packed, unique ids
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills)
    q_chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The key mode computed the way the fused kernel's passes walk it, bit
    for bit ``adc_topk_keys_reference``: the pairs grouped by list into
    items of at most ``q_chunk`` (``ivf_scan.group_pairs_reference``), each
    item's list read once for its pairs, each pair's top-k keys
    (mono16(truncated score) << 16 | lane) kept as its partial list, then
    each query's P partials merged with p put back in the coordinate. The
    CPU witness of the item bookkeeping the kernel relies on."""
    from nvdb_tpu_torch.kernels import ivf_scan

    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    B, P = probes.shape
    L = codes.shape[2]
    if fills is None:
        fills = list_fills(slot_ids)
    lut = lut.to(torch.bfloat16).to(torch.float32)
    order, items = ivf_scan.group_pairs_reference(probes, fills, q_chunk)
    part = torch.zeros((B * P, k), dtype=torch.int64, device=codes.device)  # 0: empty
    for lst, first, cnt in items.tolist():
        pairs = order[first:first + cnt].long()
        b, p = pairs // P, pairs % P
        fill = int(fills[lst])
        c = codes[lst, :, :fill].long()                                # [M, fill]
        acc = torch.zeros((cnt, fill), dtype=torch.float32, device=codes.device)
        for m in range(c.shape[0]):
            acc += lut[b, p, m][:, c[m]]
        trunc = (((-acc) + 0.0).view(torch.int32) & -65536).view(torch.float32)
        key = (_mono16(trunc) << 16) | torch.arange(fill, device=codes.device)
        top = torch.topk(key, min(k, fill), dim=1).values
        part[pairs, :top.shape[1]] = top
    # the merge: each key widened to mono16 << 32 | (p * Lcap + lane)
    part = part.reshape(B, P, k)
    p_of = torch.arange(P, device=codes.device)[None, :, None]
    wide = torch.where(part > 0, ((part >> 16) << 32) | (p_of * L + (part & 0xFFFF)), -1)
    top = torch.topk(wide.reshape(B, -1), min(k, P * k), dim=1).values
    hit = top >= 0
    cd = top & 0xFFFFFFFF
    li = torch.gather(probes.long(), 1, torch.where(hit, cd // L, 0))
    ids = torch.where(hit, slot_ids[li, torch.where(hit, cd % L, 0)], -1).to(torch.int32)
    vals = torch.where(hit, _mono16_score(top >> 32), ops.NEG_INF)
    return vals, ids


def adc_fused_keys_reference(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32
    codes: torch.Tensor,       # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,    # [nlist, Lcap] int32, prefix-packed, unique ids
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the fused key scan: the key mode's plain scan
    on the plain tables, ``adc_topk_keys_reference(adc_tables_reference(...))``."""
    if fills is None:
        fills = list_fills(slot_ids)
    lut = adc_tables_reference(q_rot, probes, centroids, codebooks, fills)
    return adc_topk_keys_reference(lut, probes, codes, slot_ids, k, fills=fills)


def bind_fused(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the fused scans' C entries and the query-term pass's on a
    build of ``csrc/adc_topk.cu`` (the port's, or a measurement build of the
    same source)."""
    # 12 pointers (the dma scan: 13, with the leads), B, P, Dp, M, dsub, nlist,
    # Lcap, kk, nq, U, stream
    lib.nvdb_adc_fused_keys.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    lib.nvdb_adc_fused_topk.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    lib.nvdb_adc_fused_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    # q_rot, codebooks, qterms, B, Dp, M, dsub, stream
    lib.nvdb_adc_query_terms.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    for fn in (lib.nvdb_adc_fused_keys, lib.nvdb_adc_fused_topk, lib.nvdb_adc_fused_plan,
               lib.nvdb_adc_query_terms):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _fused_lib():
    """The fused scan's C entries (the library of ``_lib``), built at first call."""
    from nvdb_tpu_torch.kernels import _build

    return bind_fused(_build.load("adc_topk"))


@functools.cache
def fused_plan(m: int, nq_max: int, device_index: int) -> int:
    """Queries a chunk of the fused scan: the widest of 32, 16, 8, 4 and 1
    at most ``nq_max`` whose copy rings, tables and residual norms fit a
    CTA's shared memory at M = ``m``. Raises, naming the shape, where not
    even one query's do."""
    nq = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _fused_lib().nvdb_adc_fused_plan(m, nq_max, ctypes.byref(nq))
    if rc != 0:
        raise ValueError(f"the fused ADC scan: one query's rings, tables and residual norms "
                         f"at M={m} exceed a CTA's shared memory (cudaError_t {rc})")
    return nq.value


# Launches of the query-term pass: one at every fused key and fused dma call
# (they launch it first) and one at every adc_query_terms_cuda call;
# ``index/graphs.py`` keeps it to the kernels that ran.
QTERM_LAUNCHES = 0


def adc_query_terms_cuda(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    codebooks: torch.Tensor,   # [M, 256, dsub] f32, M * dsub == Dp
) -> torch.Tensor:
    """The query-term pass alone (the fused scans launch it themselves):
    [B, M, 256] f32, bit for bit ``adc_query_terms_reference``. One launch."""
    global QTERM_LAUNCHES
    require_cuda(codebooks, "adc_query_terms")
    if q_rot.dim() != 2 or codebooks.dim() != 3:
        raise ValueError("q_rot [B, Dp], codebooks [M, 256, dsub]")
    dev = codebooks.device
    B, Dp = q_rot.shape
    M, ksub, dsub = codebooks.shape
    if ksub != pq.KSUB or M * dsub != Dp:
        raise ValueError(f"codebooks {tuple(codebooks.shape)} do not split dim {Dp} into "
                         f"M x {pq.KSUB} codewords")
    check_tensor(q_rot, "q_rot", dev, (torch.float32,), (B, Dp))
    check_tensor(codebooks, "codebooks", dev, (torch.float32,), (M, ksub, dsub))
    out = torch.empty((B, M, pq.KSUB), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        rc = _fused_lib().nvdb_adc_query_terms(q_rot.data_ptr(), codebooks.data_ptr(),
                                               out.data_ptr(), B, Dp, M, dsub, stream)
    if rc != 0:
        raise RuntimeError(f"adc_query_terms kernel launch failed: cudaError_t {rc}")
    QTERM_LAUNCHES += 1
    return out


def adc_fused_keys_cuda(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int32 probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32, M * dsub == Dp
    codes: torch.Tensor,       # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,    # [nlist, Lcap] int32, prefix-packed, unique ids
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills), cached by callers
    nq_max: Optional[int] = None,          # the plan's widest chunk (None: by the batch)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused key scan: bit for bit ``adc_topk_keys_cuda(adc_tables_cuda(
    q_rot, probes, centroids, codebooks, fills), probes, codes, slot_ids,
    k, fills=fills)``, with each pair's tables built in shared memory from
    one query-term pass (``adc_query_terms_cuda``'s, a [B, M, 256] f32
    scratch) and no [B, P, M, 256] tensor; bit for bit
    ``adc_fused_keys_reference``. The caller guarantees a
    prefix-packed index with unique ids. Returns (vals [B, k] f32, ids [B,
    k] int32). No host sync: the launches can be captured in a CUDA graph."""
    global FUSED_LAUNCHES, QTERM_LAUNCHES
    from nvdb_tpu_torch.kernels import ivf_scan

    with trace.span("adc_fused_keys_cuda") as sp:
        require_cuda(codes, "adc_fused_keys")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k={k} outside [1, {MAX_K}]")
        if (q_rot.dim() != 2 or probes.dim() != 2 or centroids.dim() != 2
                or codebooks.dim() != 3 or codes.dim() != 3):
            raise ValueError("q_rot [B, Dp], probes [B, P], centroids [nlist, Dp], codebooks "
                             "[M, 256, dsub], codes [nlist, M, Lcap]")
        dev = codes.device
        nlist, M, L = codes.shape
        B, Dp = q_rot.shape
        P = probes.shape[1]
        dsub = codebooks.shape[2]
        if tuple(codebooks.shape[:2]) != (M, pq.KSUB) or M * dsub != Dp:
            raise ValueError(f"codebooks {tuple(codebooks.shape)} do not split dim {Dp} into "
                             f"the codes' {M} subspaces of {pq.KSUB} codewords")
        key_groups(1, P, L)   # raises on a list wider than a 16-bit lane
        if P * L >= 1 << 31:
            raise ValueError(f"P={P} probes of {L} lanes exceed a 31-bit coordinate")
        given = probes, fills
        probes = probes.to(torch.int32).contiguous()
        if fills is None:
            fills = list_fills(slot_ids)
        check_tensor(q_rot, "q_rot", dev, (torch.float32,), (B, Dp))
        check_tensor(probes, "probes", dev, (torch.int32,), (B, P))
        check_tensor(centroids, "centroids", dev, (torch.float32,), (nlist, Dp))
        check_tensor(codebooks, "codebooks", dev, (torch.float32,), (M, pq.KSUB, dsub))
        check_tensor(codes, "codes", dev, (torch.uint8,), (nlist, M, L))
        check_tensor(slot_ids, "slot_ids", dev, (torch.int32,), (nlist, L))
        check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))

        vals = torch.empty((B, k), dtype=torch.float32, device=dev)
        ids = torch.empty((B, k), dtype=torch.int32, device=dev)
        if sp:
            sp.count_alloc(vals, ids, None if probes is given[0] else probes,
                           None if fills is given[1] else fills)
        if B == 0 or P == 0:
            vals.fill_(ops.NEG_INF)
            ids.fill_(-1)
            return vals, ids
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if nq_max is None:
            nq_max = FUSED_NQ_MAX if B >= FUSED_CHUNK_MIN_BATCH else 1
        nq = fused_plan(M, nq_max, index)
        U = ivf_scan.max_items(B * P, nlist, nq)
        scratch = torch.empty(ivf_scan.group_scratch_ints(nlist, B * P, U), dtype=torch.int32,
                              device=dev)
        qterms = torch.empty((B, M, pq.KSUB), dtype=torch.float32, device=dev)
        # the partial lists [B, P, tiles, k] and each one's threshold [B, P, tiles]
        part_keys = torch.empty(B * P * cdiv(L, FUSED_TILE) * (k + 1), dtype=torch.int32,
                                device=dev)
        if sp:
            sp.count_alloc(scratch, qterms, part_keys)
        fn = _fused_lib().nvdb_adc_fused_keys
        with torch.cuda.device(index):
            stream = torch.cuda.current_stream(index).cuda_stream
            with trace.span("launch"):
                rc = fn(q_rot.data_ptr(), probes.data_ptr(), centroids.data_ptr(),
                        codebooks.data_ptr(), codes.data_ptr(), slot_ids.data_ptr(),
                        fills.data_ptr(), scratch.data_ptr(), qterms.data_ptr(),
                        part_keys.data_ptr(), vals.data_ptr(), ids.data_ptr(), B, P, Dp, M, dsub,
                        nlist, L, k, nq, U, stream)
        if rc != 0:
            raise RuntimeError(f"adc_fused_keys kernel launch failed: cudaError_t {rc}")
        FUSED_LAUNCHES += 1
        QTERM_LAUNCHES += 1
        return vals, ids


# -- the fused dma scan ----------------------------------------------------------

# Launches of the fused dma scan; only adc_fused_topk_cuda's launch adds to
# it, and ``index/graphs.py`` keeps it to the kernels that ran: a served
# chain's capture adds nothing, each replay adds its launches.
FUSED_DMA_LAUNCHES = 0
# The widest query chunk the fused dma scan is built for (its instances take
# chunks of 1, 4 and 8 queries).
FUSED_DMA_NQ_MAX = 8
# The plain dma key of no candidate: the kernel's key 0, the least of all.
_EMPTY = -(1 << 63)


def _dma_keys(acc: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys of the dma order (score desc, id desc) of ADC sums ``acc``
    and slot ids (-1: no candidate, ``_EMPTY``): the kernel's 64-bit key
    mono32(-acc) << 32 | (id + 2^31) with its top bit flipped, so that the
    int64 order is the kernel's unsigned order."""
    b = ((-acc) + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF   # -0 -> +0
    mono = torch.where(b >= 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    key = (mono - (1 << 31)) * (1 << 32) + (ids.to(torch.int64) + (1 << 31))
    return torch.where(ids >= 0, key, _EMPTY)


def _dma_decode(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f32 scores, int32 ids) of ``_dma_keys`` keys; (-inf, -1) for ``_EMPTY``."""
    hit = keys != _EMPTY
    mono = (keys >> 32) + (1 << 31)
    bits = torch.where(mono >= 0x80000000, mono - 0x80000000, ~mono & 0xFFFFFFFF)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)
    vals = torch.where(hit, bits.view(torch.float32), ops.NEG_INF)
    ids = torch.where(hit, (keys & 0xFFFFFFFF) - (1 << 31), -1).to(torch.int32)
    return vals, ids


def tile_leads(slot_ids: torch.Tensor, tile: int = FUSED_TILE) -> torch.Tensor:
    """[nlist, Lcap] int32: for each live slot whose id its list holds again
    within the same tile of ``tile`` lanes, the first lane of that tile
    holding the id; else -1. What the fused dma scan reads to keep one copy
    of such an id a tile: nothing in the packer keeps a replicated row's
    copies in distinct lists (a copy spilled to its second list may meet the
    next copy there)."""
    lane = torch.arange(slot_ids.shape[1], device=slot_ids.device)
    ids = slot_ids.to(torch.int64)
    key = torch.where(ids >= 0, (lane // tile) * (1 << 32) + ids, -1 - lane)
    sk, order = torch.sort(key, dim=1, stable=True)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[:, 1:] = sk[:, 1:] != sk[:, :-1]
    run = torch.cumsum(start, dim=1) - 1                          # each position's run
    size = torch.zeros_like(sk).scatter_add_(1, run, torch.ones_like(sk))
    first = torch.cummax(torch.where(start, lane, 0), dim=1).values
    lead = torch.where(torch.gather(size, 1, run) > 1, torch.gather(order, 1, first), -1)
    return torch.empty_like(lead).scatter_(1, order, lead).to(torch.int32)


def _drop_repeated(keys: torch.Tensor, leads: torch.Tensor) -> torch.Tensor:
    """The fused dma scan's repeated-id rule on rows of keys [n, L] whose
    lanes have the ``tile_leads`` ``leads`` [n, L]: of the lanes of a tile
    holding one id, the best key's (of equal keys, the first lane's) stays,
    the others become ``_EMPTY``."""
    lane = torch.arange(keys.shape[1], device=keys.device).expand_as(keys)
    grp = torch.where(leads >= 0, leads.to(torch.int64), lane)
    best = torch.full_like(keys, _EMPTY).scatter_reduce_(1, grp, keys, "amax")
    is_best = keys == torch.gather(best, 1, grp)
    first = torch.full_like(grp, keys.shape[1]).scatter_reduce_(
        1, grp, torch.where(is_best, lane, keys.shape[1]), "amin")
    return torch.where(is_best & (torch.gather(first, 1, grp) == lane), keys, _EMPTY)


def adc_fused_topk_reference(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32
    codes: torch.Tensor,       # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,    # [nlist, Lcap] int32 (-1: no row)
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills)
    dedup: bool = True,        # the index may hold an id twice (replicas > 1)
    q_chunk: int = FUSED_DMA_NQ_MAX,
    wave_pairs: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the fused dma scan, walked as the kernel walks
    it: the plain tables (``adc_tables_reference``); the pairs grouped by
    list into items of at most ``q_chunk`` (``ivf_scan.group_pairs_reference``),
    taken in waves of whole items of about ``wave_pairs`` pairs; each pair
    scoring its list's lanes (the f32 sum over m in order), each (pair, tile
    of ``FUSED_TILE`` lanes) keeping its k best keys of distinct ids (with
    ``dedup``, the kernel's rule for an id its tile holds twice:
    ``tile_leads``); then each query's partials merged, each id's best key
    kept. Bit for bit ``adc_topk_reference(adc_tables_reference(...))``
    where the probes are in range; a probe out of range adds nothing.
    Returns (vals [B, k] f32, ids [B, k] int32), ranked by (score desc, id
    desc), (-inf, -1) after the real candidates."""
    from nvdb_tpu_torch.kernels import ivf_scan

    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    B, P = probes.shape
    L = codes.shape[2]
    dev = codes.device
    if fills is None:
        fills = list_fills(slot_ids)
    lut = adc_tables_reference(q_rot, probes, centroids, codebooks, fills).to(torch.float32)
    order, items = ivf_scan.group_pairs_reference(probes, fills, q_chunk)
    leads = tile_leads(slot_ids) if dedup else None
    T = cdiv(L, FUSED_TILE)
    lane = torch.arange(L, device=dev)
    part = torch.full((B * P, T, k), _EMPTY, dtype=torch.int64, device=dev)
    # waves of whole items: the first position in ``order`` of each wave
    ends = torch.cumsum(items[:, 2].long(), 0).tolist()
    starts, w0 = [0], 0
    for e in ends:
        if e - w0 >= wave_pairs:
            starts.append(e)
            w0 = e
    if starts[-1] != len(order):
        starts.append(len(order))
    for a, z in zip(starts[:-1], starts[1:]):
        pairs = order[a:z].long()
        b, p = pairs // P, pairs % P
        lst = probes.reshape(-1)[pairs].long()
        acc = torch.zeros((z - a, L), dtype=torch.float32, device=dev)
        for m in range(codes.shape[1]):
            acc += torch.gather(lut[b, p, m], 1, codes[lst, m].long())
        sid = torch.where(lane < fills.long()[lst, None], slot_ids[lst], -1)
        key = _dma_keys(acc, sid)
        if dedup:
            key = _drop_repeated(key, leads[lst])
        key = torch.cat([key, key.new_full((z - a, T * FUSED_TILE - L), _EMPTY)], dim=1)
        top = torch.topk(key.reshape(z - a, T, FUSED_TILE), min(k, FUSED_TILE), dim=2).values
        part[pairs, :, :top.shape[2]] = top
    # the merge: each id's best key of the query's P * T partials, the k best
    keys = torch.sort(part.reshape(B, -1), dim=1, descending=True).values
    by_id = torch.argsort(keys & 0xFFFFFFFF, dim=1, stable=True)
    keys = torch.gather(keys, 1, by_id)
    dup = torch.zeros_like(keys, dtype=torch.bool)
    dup[:, 1:] = (keys[:, 1:] & 0xFFFFFFFF) == (keys[:, :-1] & 0xFFFFFFFF)
    keys = torch.where(dup, _EMPTY, keys)
    return _dma_decode(torch.topk(keys, k, dim=1).values)


def adc_fused_topk_cuda(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int32 probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32, M * dsub == Dp
    codes: torch.Tensor,       # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,    # [nlist, Lcap] int32 (-1: no row; holes allowed)
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills), cached by callers
    nq_max: Optional[int] = None,          # the plan's widest chunk (None: by the batch), <= 8
    dedup: bool = True,        # the index may hold an id twice (replicas > 1)
    leads: Optional[torch.Tensor] = None,  # dedup: tile_leads(slot_ids), cached by callers
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused dma scan: bit for bit ``adc_topk_cuda(adc_tables_cuda(q_rot,
    probes, centroids, codebooks, fills), probes, codes, slot_ids, k,
    fills=fills)``, with each pair's tables built in shared memory from one
    query-term pass and no [B, P, M, 256] tensor, each probed list read once
    for a chunk of queries; bit for bit ``adc_fused_topk_reference``.
    ``dedup=False``: the caller guarantees that the
    index holds every id once (replicas 1); no ``leads`` is read and the
    merge skips its duplicate pass. Returns (vals [B, k] f32, ids [B, k]
    int32). No host sync: the launches can be captured in a CUDA graph."""
    global FUSED_DMA_LAUNCHES, QTERM_LAUNCHES
    from nvdb_tpu_torch.kernels import ivf_scan

    with trace.span("adc_fused_topk_cuda") as sp:
        require_cuda(codes, "adc_fused_topk")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k={k} outside [1, {MAX_K}]")
        if (q_rot.dim() != 2 or probes.dim() != 2 or centroids.dim() != 2
                or codebooks.dim() != 3 or codes.dim() != 3):
            raise ValueError("q_rot [B, Dp], probes [B, P], centroids [nlist, Dp], codebooks "
                             "[M, 256, dsub], codes [nlist, M, Lcap]")
        dev = codes.device
        nlist, M, L = codes.shape
        B, Dp = q_rot.shape
        P = probes.shape[1]
        dsub = codebooks.shape[2]
        if tuple(codebooks.shape[:2]) != (M, pq.KSUB) or M * dsub != Dp:
            raise ValueError(f"codebooks {tuple(codebooks.shape)} do not split dim {Dp} into "
                             f"the codes' {M} subspaces of {pq.KSUB} codewords")
        if L % 4 != 0:
            raise ValueError(f"list capacity {L} is not a multiple of 4 (the scan copies code "
                             f"rows in 4-byte pieces)")
        if P * L >= 1 << 31:
            raise ValueError(f"P={P} probes of {L} lanes exceed a 31-bit coordinate")
        given = probes, fills
        probes = probes.to(torch.int32).contiguous()
        if fills is None:
            fills = list_fills(slot_ids)
        if dedup and leads is None:
            leads = tile_leads(slot_ids)
            if sp:
                sp.count_alloc(leads)
        check_tensor(q_rot, "q_rot", dev, (torch.float32,), (B, Dp))
        check_tensor(probes, "probes", dev, (torch.int32,), (B, P))
        check_tensor(centroids, "centroids", dev, (torch.float32,), (nlist, Dp))
        check_tensor(codebooks, "codebooks", dev, (torch.float32,), (M, pq.KSUB, dsub))
        check_tensor(codes, "codes", dev, (torch.uint8,), (nlist, M, L))
        check_tensor(slot_ids, "slot_ids", dev, (torch.int32,), (nlist, L))
        check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))
        if dedup:
            check_tensor(leads, "leads", dev, (torch.int32,), (nlist, L))

        vals = torch.empty((B, k), dtype=torch.float32, device=dev)
        ids = torch.empty((B, k), dtype=torch.int32, device=dev)
        if sp:
            sp.count_alloc(vals, ids, None if probes is given[0] else probes,
                           None if fills is given[1] else fills)
        if B == 0 or P == 0:
            vals.fill_(ops.NEG_INF)
            ids.fill_(-1)
            return vals, ids
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if nq_max is None:
            nq_max = FUSED_NQ_MAX if B >= FUSED_CHUNK_MIN_BATCH else 1
        nq = fused_plan(M, min(nq_max, FUSED_DMA_NQ_MAX), index)
        U = ivf_scan.max_items(B * P, nlist, nq)
        scratch = torch.empty(ivf_scan.group_scratch_ints(nlist, B * P, U), dtype=torch.int32,
                              device=dev)
        qterms = torch.empty((B, M, pq.KSUB), dtype=torch.float32, device=dev)
        # the partial lists [B, P, tiles, k] and each one's threshold [B, P, tiles]
        part_keys = torch.empty(B * P * cdiv(L, FUSED_TILE) * (k + 1), dtype=torch.int64,
                                device=dev)
        if sp:
            sp.count_alloc(scratch, qterms, part_keys)
        fn = _fused_lib().nvdb_adc_fused_topk
        with torch.cuda.device(index):
            stream = torch.cuda.current_stream(index).cuda_stream
            with trace.span("launch"):
                rc = fn(q_rot.data_ptr(), probes.data_ptr(), centroids.data_ptr(),
                        codebooks.data_ptr(), codes.data_ptr(), slot_ids.data_ptr(),
                        leads.data_ptr() if dedup else None, fills.data_ptr(),
                        scratch.data_ptr(), qterms.data_ptr(), part_keys.data_ptr(),
                        vals.data_ptr(), ids.data_ptr(), B, P, Dp, M, dsub, nlist, L, k, nq, U,
                        stream)
        if rc != 0:
            raise RuntimeError(f"adc_fused_topk kernel launch failed: cudaError_t {rc}")
        FUSED_DMA_LAUNCHES += 1
        QTERM_LAUNCHES += 1
        return vals, ids
