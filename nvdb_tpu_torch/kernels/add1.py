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

THREADS = 256          # a CTA of the kernel
ONE_CTA_MAX = 4096     # one CTA of 16-byte loads covers this many elements
MAX_BLOCKS = 1024      # the grid-stride loop's CTAs above that


def launch_blocks(n: int) -> int:
    """CTAs of the kernel's launch for n elements: one while each of its
    256 threads has at most four 16-byte pieces (n <= 4096), else one per
    1,024 elements up to 1,024 CTAs, which then stride over the rest."""
    if n < 1:
        raise ValueError(f"n = {n}: the kernel takes at least one element")
    if n <= ONE_CTA_MAX:
        return 1
    return min(-(-n // (4 * THREADS)), MAX_BLOCKS)


def add1_reference(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("add1").nvdb_add1
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
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
        rc = _lib()(x.data_ptr(), y.data_ptr(), x.numel(), launch_blocks(x.numel()), stream)
    if rc != 0:
        raise RuntimeError(f"add1 kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return y
