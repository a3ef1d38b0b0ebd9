"""Builds the CUDA sources under ``csrc/`` into a shared library and loads it.

The library has a plain C interface, so ``nvcc`` compiles it in seconds
without PyTorch's headers, and ``ctypes`` binds it. It is built at first use
into ``build/nvdb_tpu_torch/`` at the repository root, keyed by a hash of the
sources, shared headers and flags, so a changed source or header rebuilds
and an unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nvdb_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME/bin): the CUDA "
                       "kernels are built from source and need the CUDA toolkit")


def source_digest(name: str, csrc: Path = CSRC, defines: tuple = ()) -> str:
    """Cache key of ``csrc/<name>.cu``: the flags and defines, the source and
    every other file under ``csrc`` (the headers a source may include), by
    name and content, so an edited header rebuilds every library."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    h.update(name.encode())
    for f in sorted(p for p in csrc.iterdir() if p.is_file()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build(name: str, defines: tuple = ()) -> dict:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources and
    flags exists. ``defines``: preprocessor definitions (``"NAME=VALUE"``)
    of a measurement build; the port's own libraries take none. Returns
    ``{"path", "seconds", "log", "cached"}``; ``log`` holds the compiler's
    output (``-Xptxas -v``: registers, shared memory and spills of each
    kernel). Raises with the compiler's output on failure."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}_{source_digest(name, defines=defines)}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return {"path": str(lib), "seconds": 0.0, "log": log, "cached": True}

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    return {"path": str(lib), "seconds": seconds, "log": log, "cached": False}


@functools.cache
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(build(name, defines)["path"])
