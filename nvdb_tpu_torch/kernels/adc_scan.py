"""IVF-PQ ADC candidate top-k: the wrappers of the CUDA kernels in
``csrc/adc_topk.cu`` (the port of ``nvdb_tpu.kernels.adc_scan.pallas_adc_topk``
in its three id modes) and their plain PyTorch versions; and the bf16 ADC
tables they read: the wrapper of ``csrc/adc_tables.cu`` and its plain
version (``pq.adc_lut`` then the bf16 cast, which the JAX package leaves to
XLA).

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
- ``gather`` (``adc_topk_keys_cuda(..., gathered=True)``): the key mode over
  the slab ``gather_codes(codes, probes)`` [B * P, M, Lcap] of the probed
  lists, bit for bit the key mode's result.

The TPU kernel's nibble one-hot matmul works around the TPU's lack of a
fast gather and is not carried over. The ``*_cuda`` wrappers launch their
kernels on CUDA tensors and raise on any other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

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
# Launches of the key and gather kernels; only adc_topk_keys_cuda's launch
# adds to them, to the one of its mode.
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
    """The gather mode's slab: the probed lists' codes [B * P, M, Lcap], row
    b * P + p holding list probes[b, p] (list 0 for a probe out of range,
    which no mode reads). The counterpart of the XLA gather of the TPU
    kernel (``adc_scan.py:699``); at B = 256, P = 64, M = 96, Lcap = 640 it
    is 1.007 GB."""
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


def adc_tables_reference(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32
    fills: torch.Tensor,       # [nlist] int32 (list_fills)
) -> torch.Tensor:
    """The plain PyTorch version of the table kernel: ``pq.adc_lut`` of each
    probe's residual, rounded to bf16; [B, P, M, 256]. Probes of a dead or
    out-of-range list get zeros (the scan reads nothing of them)."""
    B, P = probes.shape
    m = codebooks.shape[0]
    live = live_probes(probes, fills)
    safe = torch.where(live, probes, 0).long()
    residuals = q_rot[:, None, :] - centroids[safe]                  # [B, P, Dp]
    lut = pq.adc_lut(residuals.reshape(B * P, -1), codebooks, m)
    lut = lut.reshape(B, P, m, pq.KSUB).to(torch.bfloat16)
    return torch.where(live[:, :, None, None], lut, 0.0)


@functools.cache
def _tables_lib():
    """The table kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("adc_tables").nvdb_adc_tables
    # 6 pointers, B, P, Dp, M, dsub, nlist, ctas, stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adc_tables_cuda(
    q_rot: torch.Tensor,       # [B, Dp] f32 rotated queries
    probes: torch.Tensor,      # [B, P] int32 probed list ids
    centroids: torch.Tensor,   # [nlist, Dp] f32
    codebooks: torch.Tensor,   # [M, 256, dsub] f32, M * dsub == Dp
    fills: torch.Tensor,       # [nlist] int32 (list_fills)
) -> torch.Tensor:
    """bf16 ADC tables [B, P, M, 256] in one pass; the contract of
    ``adc_tables_reference`` (a rare entry one bf16 step off: the dsub
    products are summed in another order)."""
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q_rot.data_ptr(), probes.data_ptr(), centroids.data_ptr(),
                codebooks.data_ptr(), fills.data_ptr(), lut.data_ptr(), B, P, Dp, M, dsub,
                nlist, _TABLE_CTAS_PER_SM * n_sm, stream)
    if rc != 0:
        raise RuntimeError(f"adc_tables kernel launch failed: cudaError_t {rc}")
    TABLE_LAUNCHES += 1
    return lut
