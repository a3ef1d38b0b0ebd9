"""Exact flat-scan top-k: the wrapper of the CUDA kernel ``csrc/flat_topk.cu``
(the port of ``nvdb_tpu.kernels.flat_scan.pallas_flat_topk``) and its plain
PyTorch version.

``flat_topk_cuda`` launches the kernel on a CUDA tensor and raises on any
other: the plain version runs only where ``dispatch`` picks it (``auto`` on a
CPU tensor, or ``torch``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.kernels import ops
from nvdb_tpu_torch.utils import cdiv

MAX_K = 128

# the kernel's tiling (csrc/flat_topk.cu): queries per CTA, rows per tile,
# dims per staged chunk
_QB = 64
_TR = 64
_DK = 64
# pass-1 CTAs per SM the slice count aims for (two fit by shared memory at k=128)
_CTAS_PER_SM = 2

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MODE_I8Q8 = 3

# Launches of the kernel since the last reset: a run can show that its main
# path went through the kernel. Only flat_topk_cuda's launch adds to it.
LAUNCHES = 0


def flat_topk_reference(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    scales: Optional[torch.Tensor],
    n_valid: int,
    k: int,
    query_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel (``ops.scan_topk``)."""
    return ops.scan_topk(queries, vectors, scales, n_valid, k,
                         query_scales=query_scales)


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("flat_topk").nvdb_flat_topk
    # 8 pointers, B, Dp, n_eff, k, S, mode, stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def require_cuda(t: torch.Tensor, kernel: str) -> None:
    """A kernel wrapper's first check: the kernel runs on a card only, and
    a wrapper never falls back to the plain version by itself."""
    if not t.is_cuda:
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got one on "
                         f"{t.device}; use dispatch with backend 'auto' or "
                         f"'torch' for the plain version")


def check_tensor(t: torch.Tensor, name: str, device: torch.device, dtypes, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the store on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must start on a 16-byte boundary (16-byte loads)")


def _slice_count(batch: int, n_valid: int, device: torch.device) -> int:
    """Row slices of pass 1: enough CTAs for ``_CTAS_PER_SM`` per SM at any
    batch, but no slice shorter than one tile."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = max(cdiv(n_valid, _TR), 1)
    return max(1, min(tiles, cdiv(_CTAS_PER_SM * n_sm, cdiv(batch, _QB))))


def flat_topk_cuda(
    queries: torch.Tensor,          # [B, Dp] f32 (or int8 with query_scales)
    vectors: torch.Tensor,          # [Np, Dp] f32 | bf16 | int8
    scales: Optional[torch.Tensor],  # [Np] f32 (int8 stores only)
    n_valid: int,
    k: int,
    query_scales: Optional[torch.Tensor] = None,  # [B] f32 (int8 queries only)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k dot-product scan; same contract as ``ops.scan_topk``.
    Returns (vals [B, k] f32, ids [B, k] int32), sorted descending, ties to
    the larger id, (-inf, -1) where fewer than k rows are valid."""
    global LAUNCHES
    require_cuda(vectors, "flat_topk")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if vectors.dim() != 2 or queries.dim() != 2:
        raise ValueError("queries and vectors must be 2-D")
    dev = vectors.device
    Np, Dp = vectors.shape
    B = queries.shape[0]
    if Dp % _DK != 0:
        raise ValueError(f"padded dim {Dp} is not a multiple of {_DK}")
    check_tensor(vectors, "vectors", dev, tuple(_MODES), (Np, Dp))
    mode = _MODES[vectors.dtype]
    if vectors.dtype == torch.int8:
        if scales is None:
            raise ValueError("an int8 store needs its per-row scales")
        check_tensor(scales, "scales", dev, (torch.float32,), (Np,))
    elif scales is not None:
        raise ValueError("per-row scales belong to int8 stores only")
    if query_scales is not None:
        if vectors.dtype != torch.int8:
            raise ValueError("int8 queries need an int8 store")
        check_tensor(queries, "queries", dev, (torch.int8,), (B, Dp))
        check_tensor(query_scales, "query_scales", dev, (torch.float32,), (B,))
        mode = _MODE_I8Q8
    else:
        check_tensor(queries, "queries", dev, (torch.float32,), (B, Dp))

    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, ids
    n_eff = max(0, min(int(n_valid), Np))
    S = _slice_count(B, n_eff, dev)
    part_vals = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    part_ids = torch.empty((B, S, k), dtype=torch.int32, device=dev)

    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(queries.data_ptr(), vectors.data_ptr(),
                scales.data_ptr() if scales is not None else None,
                query_scales.data_ptr() if query_scales is not None else None,
                part_vals.data_ptr(), part_ids.data_ptr(),
                vals.data_ptr(), ids.data_ptr(),
                B, Dp, n_eff, k, S, mode, stream)
    if rc != 0:
        raise RuntimeError(f"flat_topk kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return vals, ids
