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

# The two pass-1 kernels of csrc/flat_topk.cu and their tiling: queries per
# CTA, rows per tile, CTAs per SM that the slice count aims for. The SIMT
# kernel fits two CTAs per SM by shared memory at k = 128; the tensor-core
# kernel is one CTA per SM (its ring and lists fill the SM's shared memory).
SIMT = "simt"
TENSOR_CORE = "tensor_core"
_TILING = {SIMT: (64, 64, 2), TENSOR_CORE: (128, 256, 1)}
_DIM_STEP = 64   # padded dims come in multiples of this

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MODE_I8Q8 = 3

# Launches of the kernel since the last reset: a run can show that its main
# path went through the kernel. Only flat_topk_cuda's launch adds to it.
LAUNCHES = 0


def kernel_for(store_dtype: torch.dtype) -> str:
    """Which pass-1 kernel scores a store: by store type alone. f32 means
    exact f32 FMA, so it keeps the SIMT kernel; bf16 and int8 stores (with
    f32 or int8 queries) are scored on the tensor cores."""
    if store_dtype == torch.float32:
        return SIMT
    if store_dtype in (torch.bfloat16, torch.int8):
        return TENSOR_CORE
    raise TypeError(f"the flat_topk kernel takes f32, bf16 or int8 stores, not {store_dtype}")


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
    # 9 pointers, B, Dp, Np, n_eff, k, S, mode, stream
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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


def check_tma_operand(t: torch.Tensor, name: str) -> None:
    """What a TMA tensor map asks of a [rows, Dp] operand: dims contiguous,
    a base and a row pitch on 16-byte boundaries; and the kernels' own rule
    that Dp is a multiple of 64."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D")
    if t.shape[1] % _DIM_STEP != 0:
        raise ValueError(f"{name}: padded dim {t.shape[1]} is not a multiple of {_DIM_STEP}")
    if t.stride(1) != 1:
        raise ValueError(f"{name}: the dims of a row must be contiguous")
    pitch = t.stride(0) * t.element_size()
    if t.shape[0] > 1 and pitch % 16 != 0:
        raise ValueError(f"{name}: row pitch {pitch} bytes is not a multiple of 16")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def slice_count(batch: int, n_valid: int, n_sm: int, kernel: str) -> int:
    """Row slices of pass 1, one CTA per (slice, query block). SIMT kernel:
    enough slices for two CTAs per SM at any batch. Tensor-core kernel: as
    many as keep the grid within one wave of one CTA per SM (a second,
    partial wave would cost a whole one), so that the query blocks of a
    slice run side by side and share its rows in L2. No slice is shorter
    than one tile."""
    qb, tr, per_sm = _TILING[kernel]
    tiles = max(cdiv(n_valid, tr), 1)
    q_blocks = cdiv(batch, qb)
    want = cdiv(per_sm * n_sm, q_blocks) if kernel == SIMT else (per_sm * n_sm) // q_blocks
    return max(1, min(tiles, want))


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
    kernel = kernel_for(vectors.dtype)
    check_tma_operand(vectors, "vectors")
    check_tma_operand(queries, "queries")
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
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    S = slice_count(B, n_eff, n_sm, kernel)
    # the bf16-rounded queries of a bf16 or int8 store (int8 queries go as they are)
    q16 = (torch.empty((B, Dp), dtype=torch.bfloat16, device=dev)
           if kernel == TENSOR_CORE and mode != _MODE_I8Q8 else None)
    part_vals = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    part_ids = torch.empty((B, S, k), dtype=torch.int32, device=dev)

    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(queries.data_ptr(), vectors.data_ptr(),
                scales.data_ptr() if scales is not None else None,
                query_scales.data_ptr() if query_scales is not None else None,
                q16.data_ptr() if q16 is not None else None,
                part_vals.data_ptr(), part_ids.data_ptr(),
                vals.data_ptr(), ids.data_ptr(),
                B, Dp, Np, n_eff, k, S, mode, stream)
    if rc != 0:
        raise RuntimeError(f"flat_topk kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return vals, ids
