"""IVF probe top-k: the wrapper of the CUDA kernel ``csrc/ivf_probe_topk.cu``
(the port of ``nvdb_tpu.kernels.ivf_scan.pallas_ivf_probe_topk``) and its
plain PyTorch version.

Both score slot l of probed list p = probes[b, p] by dot(q_b, packed[p, l])
(f32 slabs in full f32; bf16 and int8 slabs with the query rounded to bf16
and the slab widened, sums in f32, int8 sums times the slot's scale), mask
slots whose id is -1, and return the top k (k <= 128) by (score desc, id
desc) with (-inf, -1) fill. A probe id outside [0, nlist) is an empty list.

``ivf_probe_topk_cuda`` launches the kernel on a CUDA tensor and raises on
any other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.kernels import ops
from nvdb_tpu_torch.kernels.adc_scan import list_fills
from nvdb_tpu_torch.kernels.flat_scan import check_tensor, require_cuda
from nvdb_tpu_torch.utils import cdiv

MAX_K = 128
_CTAS_PER_SM = 4     # pass-1 CTAs per SM the probe split aims for

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Launches of the kernel since the last reset. Only ivf_probe_topk_cuda's
# launch adds to it.
LAUNCHES = 0


def ivf_probe_topk_reference(
    queries: torch.Tensor,              # [B, Dp] f32
    probes: torch.Tensor,               # [B, P] int list ids
    packed: torch.Tensor,               # [nlist, Lcap, Dp] f32 | bf16 | int8
    slot_ids: torch.Tensor,             # [nlist, Lcap] int32 (-1 padding)
    slot_scales: Optional[torch.Tensor],  # [nlist, Lcap] f32 (int8 slabs)
    k: int,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, chunked over queries so the
    gathered f32 slabs stay near 256 MB (unchunked, B = 256 queries of 64
    probes of 384 x 768 slabs would be 19 GB)."""
    B, P = probes.shape
    nlist, L, Dp = packed.shape
    if q_chunk is None:
        q_chunk = max(1, (256 << 20) // max(1, P * L * Dp * 4))
    ops.no_tf32()
    # f32 slabs take the query as it is, bf16 / int8 slabs a bf16-rounded one
    q_all = queries.to(torch.float32) if packed.dtype == torch.float32 else \
        ops._bf16_round(queries)
    probes = probes.long()
    vals, ids = [], []
    for s in range(0, B, q_chunk):
        pr = probes[s:s + q_chunk]                                # [c, P]
        ok = (pr >= 0) & (pr < nlist)
        pr = torch.where(ok, pr, 0)
        scores = torch.einsum("cd,cpld->cpl", q_all[s:s + q_chunk],
                              packed[pr].to(torch.float32))       # [c, P, L]
        if slot_scales is not None:
            scores = scores * slot_scales[pr]
        sids = torch.where(ok[:, :, None], slot_ids[pr], -1)      # [c, P, L]
        scores = torch.where(sids >= 0, scores, ops.NEG_INF)
        c = pr.shape[0]
        v, i = ops.topk_sorted(scores.reshape(c, -1), sids.reshape(c, -1), k)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("ivf_probe_topk").nvdb_ivf_probe_topk
    # 10 pointers, B, P, nlist, Lcap, Dp, k, S, mode, stream
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _probe_groups(batch: int, P: int, device: torch.device) -> int:
    """Probe groups S of pass 1: about ``_CTAS_PER_SM`` CTAs per SM at any
    batch, no group without a probe."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    s = max(1, min(P, cdiv(_CTAS_PER_SM * n_sm, batch)))
    return cdiv(P, cdiv(P, s))


def ivf_probe_topk_cuda(
    queries: torch.Tensor,              # [B, Dp] f32
    probes: torch.Tensor,               # [B, P] int32 list ids
    packed: torch.Tensor,               # [nlist, Lcap, Dp] f32 | bf16 | int8
    slot_ids: torch.Tensor,             # [nlist, Lcap] int32 (-1 padding)
    slot_scales: Optional[torch.Tensor],  # [nlist, Lcap] f32 (int8 slabs)
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills), cached by callers
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over each query's probed list slabs; the contract of
    ``ivf_probe_topk_reference``. Returns (vals [B, k] f32, ids [B, k]
    int32)."""
    global LAUNCHES
    require_cuda(packed, "ivf_probe_topk")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if packed.dim() != 3 or queries.dim() != 2 or probes.dim() != 2:
        raise ValueError("queries [B, Dp], probes [B, P], packed [nlist, Lcap, Dp]")
    dev = packed.device
    nlist, L, Dp = packed.shape
    B, P = probes.shape
    if Dp % 16 != 0:
        raise ValueError(f"padded dim {Dp} is not a multiple of 16 (16-byte loads)")
    probes = probes.to(torch.int32).contiguous()
    if fills is None:
        fills = list_fills(slot_ids)
    check_tensor(packed, "packed", dev, tuple(_MODES), (nlist, L, Dp))
    check_tensor(queries, "queries", dev, (torch.float32,), (B, Dp))
    check_tensor(probes, "probes", dev, (torch.int32,), (B, P))
    check_tensor(slot_ids, "slot_ids", dev, (torch.int32,), (nlist, L))
    check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))
    if (packed.dtype == torch.int8) != (slot_scales is not None):
        raise ValueError("per-slot scales go with int8 slabs, and only with them")
    if slot_scales is not None:
        check_tensor(slot_scales, "slot_scales", dev, (torch.float32,), (nlist, L))

    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or P == 0:
        vals.fill_(ops.NEG_INF)
        ids.fill_(-1)
        return vals, ids
    S = _probe_groups(B, P, dev)
    part_vals = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    part_ids = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(queries.data_ptr(), probes.data_ptr(), packed.data_ptr(), slot_ids.data_ptr(),
                slot_scales.data_ptr() if slot_scales is not None else None,
                fills.data_ptr(), part_vals.data_ptr(), part_ids.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), B, P, nlist, L, Dp, k, S,
                _MODES[packed.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ivf_probe_topk kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return vals, ids
