"""IVF-PQ ADC candidate top-k: the wrapper of the CUDA kernel
``csrc/adc_topk.cu`` (the port of ``nvdb_tpu.kernels.adc_scan.pallas_adc_topk``
with ``ids_mode="dma"``) and its plain PyTorch version.

Both score slot l of probed list p by -sum_m bf16(lut[b, p, m, code]),
summed in f32 over m in order, mask slots whose id is -1, keep one slot per
id (its best score; replicated indexes) and return the top kk (kk <= 1024)
by (score desc, id desc) with (-inf, -1) fill. The TPU kernel's nibble
one-hot matmul and its ``key``/``gather`` id modes work around TPU limits
and are not ported.

``adc_topk_cuda`` launches the kernel on a CUDA tensor and raises on any
other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.kernels import ops
from nvdb_tpu_torch.kernels.flat_scan import check_tensor, require_cuda
from nvdb_tpu_torch.utils import cdiv

MAX_K = 1024
_MAX_CAP = 8192      # longest key buffer of pass 1 (csrc/adc_topk.cu)
_CTAS_PER_SM = 2     # pass-1 CTAs per SM the probe split aims for
_SMEM_LIMIT = 227 * 1024

# Launches of the kernel since the last reset. Only adc_topk_cuda's launch
# adds to it.
LAUNCHES = 0


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


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("adc_topk").nvdb_adc_topk
    # 8 pointers, B, P, M, Lcap, nlist, kk, S, stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    cap = _pow2_at_least(k + max(L, k))
    if cap > _MAX_CAP or cap * 8 + M * 512 > _SMEM_LIMIT:
        raise ValueError(f"k={k} with list capacity {L} and M={M} exceeds the "
                         f"kernel's shared memory")
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
                B, P, M, L, nlist, k, S, stream)
    if rc != 0:
        raise RuntimeError(f"adc_topk kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return vals, ids
