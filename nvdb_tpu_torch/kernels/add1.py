"""The GPU hello-world kernel: the wrapper of ``csrc/add1.cu`` (the port of
the Pallas ``add1`` of ``nvdb_tpu.tools.tpu_sanity``) and its plain
PyTorch version. ``add1_cuda`` launches the kernel on a CUDA tensor and
raises on any other."""

from __future__ import annotations

import ctypes
import functools

import torch

from nvdb_tpu_torch.kernels.flat_scan import check_tensor, require_cuda

# Launches of the kernel since the last reset. Only add1_cuda's launch adds
# to it.
LAUNCHES = 0


def add1_reference(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("add1").nvdb_add1
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def add1_cuda(x: torch.Tensor) -> torch.Tensor:
    """x + 1 of a float32 CUDA tensor, by the kernel."""
    global LAUNCHES
    require_cuda(x, "add1")
    check_tensor(x, "x", x.device, (torch.float32,), tuple(x.shape))
    if not 1 <= x.numel() < 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib()(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"add1 kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return y
