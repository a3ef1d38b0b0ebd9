"""HBM stream probes: the wrappers of the CUDA kernels ``csrc/hbm_stream.cu``
(the port of the Pallas stream kernels of ``scripts/hbm_probe.py``) and
their plain PyTorch version.

Each reads a bf16 array once and returns its maximum as a 0-d f32 tensor:
``stream_max_cuda`` by a grid-stride stream of 16-byte loads (``kern`` /
``kern_p``: stream speed with zero compute), ``ring_max_cuda`` through a
cp.async ring in shared memory (``kern_m``: does deeper buffering lift the
rate?), ``stream_max_reference`` by ``torch.amax`` (the vendor-tuned reduce,
as ``xla_max`` is on the TPU). The maximum is exact, so all three agree
bit for bit on arrays without NaN.

Both ``*_cuda`` wrappers launch their kernel on a CUDA tensor and raise on
any other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nvdb_tpu_torch.kernels.flat_scan import require_cuda

_CTAS_PER_SM = {False: 8, True: 3}   # stream / ring: CTAs per SM (ring: 64 KB smem each)

# Launches since the last reset, per kernel. Only the *_cuda wrappers'
# launches add to them.
LAUNCHES = {"stream": 0, "ring": 0}


def stream_max_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.amax`` of the whole array, as f32."""
    return torch.amax(x).to(torch.float32)


@functools.cache
def _lib():
    """The kernels' C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("hbm_stream").nvdb_stream_max
    # x, nvec, partial, out, blocks, ring, stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, ring: bool) -> torch.Tensor:
    require_cuda(x, "hbm_stream")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x has dtype {x.dtype}; the stream kernels take bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("x must be contiguous and start on a 16-byte boundary")
    if x.numel() == 0 or x.numel() % 8 != 0:
        raise ValueError(f"x has {x.numel()} elements; the kernels read whole 16-byte "
                         f"pieces of 8")
    dev = x.device
    blocks = _CTAS_PER_SM[ring] * torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((blocks,), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(x.data_ptr(), x.numel() // 8, partial.data_ptr(), out.data_ptr(),
                    blocks, int(ring), stream)
    if rc != 0:
        raise RuntimeError(f"hbm_stream kernel launch failed: cudaError_t {rc}")
    LAUNCHES["ring" if ring else "stream"] += 1
    return out


def stream_max_cuda(x: torch.Tensor) -> torch.Tensor:
    """Maximum of a bf16 CUDA array by the grid-stride stream kernel."""
    return _launch(x, ring=False)


def ring_max_cuda(x: torch.Tensor) -> torch.Tensor:
    """Maximum of a bf16 CUDA array by the cp.async ring kernel."""
    return _launch(x, ring=True)
