"""IVF-PQ ADC candidate top-k: the wrapper of the CUDA kernel
``csrc/adc_topk.cu`` (the port of ``nvdb_tpu.kernels.adc_scan.pallas_adc_topk``
with ``ids_mode="dma"``) and its plain PyTorch version; and the bf16 ADC
tables it reads: the wrapper of ``csrc/adc_tables.cu`` and its plain version
(``pq.adc_lut`` then the bf16 cast, which the JAX package leaves to XLA).

Both score slot l of probed list p by -sum_m bf16(lut[b, p, m, code]),
summed in f32 over m in order, mask slots whose id is -1, keep one slot per
id (its best score; replicated indexes) and return the top kk (kk <= 1024)
by (score desc, id desc) with (-inf, -1) fill. The TPU kernel's nibble
one-hot matmul and its ``key``/``gather`` id modes work around TPU limits
and are not ported.

``adc_topk_cuda`` and ``adc_tables_cuda`` launch their kernels on CUDA
tensors and raise on any other.
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


def scan_plan(k: int, M: int, L: int) -> Tuple[int, int]:
    """(stages, tile) of pass 1's ring (``csrc/adc_topk.cu``): a stage holds
    one probe's bf16 table (M x 512 bytes) and a tile of its codes (M rows
    of ``tile`` slots); the key buffer holds pow2(max(1024, k + 512)) keys.
    Two stages of whole lists where a CTA's shared memory allows, else
    narrower tiles (multiples of 128 slots), else one stage. Raises when
    one table and a 128-slot tile do not fit."""
    cap = _pow2_at_least(max(1024, k + 512))
    for stages in (2, 1):
        room = (_SMEM_LIMIT - cap * 8) // stages - M * 512
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
