"""Exact flat-scan top-k: the wrapper of the CUDA kernel ``csrc/flat_topk.cu``
(the port of ``nvdb_tpu.kernels.flat_scan.pallas_flat_topk``) and its plain
PyTorch versions.

``flat_topk_cuda`` launches the kernel on a CUDA tensor and raises on any
other: the plain version runs only where ``dispatch`` picks it (``auto`` on a
CPU tensor, or ``torch``). ``ops.scan_topk`` (true f32, TF32 off) is the
plain version the kernel is held against; ``split_bf16x3`` and
``six_pass_scores`` model the f32 instance's decomposition alone, so a test
can tell the split's error from the kernel's order of summation. Nothing on
the search path calls them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.eval import trace
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

# Top-1 buckets a query of the tensor-core kernel has (MAX_BUCKETS in
# csrc/flat_topk.cu).
BOUND_BUCKETS = 16

# The C entry's mode of each kernel instance.
_MODES = {"f32_simt": 0, "bf16": 1, "int8": 2, "int8_int8": 3, "f32_tensor_core": 4}

# Launches of the kernel since the last reset, in all and by instance: a run
# can show that its main path went through the kernel, and which instance
# scored its f32 stores. Only flat_topk_cuda's launch adds to them; a served
# chain's capture adds nothing, each replay adds its launches.
LAUNCHES = 0
LAUNCHES_BY_KERNEL = dict.fromkeys(_MODES, 0)


def kernel_for(store_dtype: torch.dtype) -> str:
    """Which pass-1 kernel scores a store by default: the tensor-core kernel
    for every store type. f32 stores are scored there by the three-way bf16
    split of both operands in six passes, as the TPU's ``Precision.HIGHEST``
    does (``split_bf16x3``); the SIMT kernel of f32 FMA stays reachable only
    by ``flat_topk_cuda(f32_kernel="simt")``, as the A/B."""
    if store_dtype in (torch.float32, torch.bfloat16, torch.int8):
        return TENSOR_CORE
    raise TypeError(f"the flat_topk kernel takes f32, bf16 or int8 stores, not {store_dtype}")


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three-way bf16 split of an f32 tensor, as the kernel makes it:
    h = bf16(x), m = bf16(x - h), l = bf16((x - h) - m), each rounded to
    nearest even, returned as f32 tensors of bf16-exact values. The
    subtractions are exact, and h + m + l == x wherever x's lowest set bit
    is at or above 2^-133 (bf16's least subnormal), so for every |x| >=
    2^-110; below, the split loses at most 2^-133. |x| above bf16's largest
    finite value (about 3.39e38) rounds to infinity, as on the card."""
    x = x.to(torch.float32)
    h = x.to(torch.bfloat16).to(torch.float32)
    r = x - h
    m = r.to(torch.bfloat16).to(torch.float32)
    l = (r - m).to(torch.bfloat16).to(torch.float32)
    return h, m, l


# The six passes of the f32 instance as (query part, row part), in the
# kernel's order, smallest terms first; the three it drops (m l, l m, l l)
# are about 2^-24 of the score or smaller.
SIX_PASSES = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))


def six_pass_scores(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] f32 scores by the split of both operands:
    the sum of the six passes, each an f32 product (TF32 off) of bf16-exact
    values, in the kernel's order."""
    ops.no_tf32()
    qp, rp = split_bf16x3(queries), split_bf16x3(rows)
    s = None
    for a, b in SIX_PASSES:
        p = qp[a] @ rp[b].T
        s = p if s is None else s + p
    return s


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


# The C entry's argument types: q, v, scales, qscales, q16, part_vals,
# part_ids, bounds, out_vals, out_ids; B, Dp, Np, n_eff, k, S, mode; stream.
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("flat_topk").nvdb_flat_topk
    fn.argtypes = ARGTYPES
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
    f32_kernel: str = TENSOR_CORE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k dot-product scan; same contract as ``ops.scan_topk``.
    Returns (vals [B, k] f32, ids [B, k] int32), sorted descending, ties to
    the larger id, (-inf, -1) where fewer than k rows are valid.
    ``f32_kernel="simt"`` scores an f32 store with the SIMT kernel of f32
    FMA instead of the tensor cores: the A/B, never a fallback."""
    global LAUNCHES
    with trace.span("flat_topk_cuda") as sp:
        require_cuda(vectors, "flat_topk")
        if f32_kernel not in (SIMT, TENSOR_CORE):
            raise ValueError(f"f32_kernel is {SIMT!r} or {TENSOR_CORE!r}, not {f32_kernel!r}")
        if f32_kernel == SIMT and vectors.dtype != torch.float32:
            raise ValueError("f32_kernel='simt' scores f32 stores only")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k={k} outside [1, {MAX_K}]")
        if vectors.dim() != 2 or queries.dim() != 2:
            raise ValueError("queries and vectors must be 2-D")
        dev = vectors.device
        Np, Dp = vectors.shape
        B = queries.shape[0]
        kernel = f32_kernel if vectors.dtype == torch.float32 else kernel_for(vectors.dtype)
        check_tma_operand(vectors, "vectors")
        check_tma_operand(queries, "queries")
        check_tensor(vectors, "vectors", dev, (torch.float32, torch.bfloat16, torch.int8),
                     (Np, Dp))
        instance = {torch.float32: f"f32_{kernel}", torch.bfloat16: "bf16",
                    torch.int8: "int8"}[vectors.dtype]
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
            instance = "int8_int8"
        else:
            check_tensor(queries, "queries", dev, (torch.float32,), (B, Dp))

        vals = torch.empty((B, k), dtype=torch.float32, device=dev)
        ids = torch.empty((B, k), dtype=torch.int32, device=dev)
        if sp:
            sp.count_alloc(vals, ids)
        if B == 0:
            return vals, ids
        n_eff = max(0, min(int(n_valid), Np))
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        S = slice_count(B, n_eff, n_sm, kernel)
        # the queries' prologue: bf16-rounded for a bf16 or int8 store, split
        # into three bf16 planes for an f32 store (int8 queries go as they are)
        planes = {"bf16": 1, "int8": 1, "f32_tensor_core": 3}.get(instance)
        q16 = (torch.empty((planes, B, Dp), dtype=torch.bfloat16, device=dev)
               if planes else None)
        part_vals = torch.empty((B, S, k), dtype=torch.float32, device=dev)
        part_ids = torch.empty((B, S, k), dtype=torch.int32, device=dev)
        # the tensor-core kernel's slices share bounds of each query here: the
        # best k-th pair of a slice (8 bytes) and the top-1 buckets (4 bytes
        # each); the prologue zeroes them
        bounds = (torch.empty((B * (2 + BOUND_BUCKETS),), dtype=torch.int32, device=dev)
                  if kernel == TENSOR_CORE else None)
        if sp:
            sp.count_alloc(q16, part_vals, part_ids, bounds)

        fn = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            with trace.span("launch"):
                rc = fn(queries.data_ptr(), vectors.data_ptr(),
                        scales.data_ptr() if scales is not None else None,
                        query_scales.data_ptr() if query_scales is not None else None,
                        q16.data_ptr() if q16 is not None else None,
                        part_vals.data_ptr(), part_ids.data_ptr(),
                        bounds.data_ptr() if bounds is not None else None,
                        vals.data_ptr(), ids.data_ptr(),
                        B, Dp, Np, n_eff, k, S, _MODES[instance], stream)
        if rc != 0:
            raise RuntimeError(f"flat_topk kernel launch failed ({instance}): cudaError_t {rc}")
        LAUNCHES += 1
        LAUNCHES_BY_KERNEL[instance] += 1
        return vals, ids
