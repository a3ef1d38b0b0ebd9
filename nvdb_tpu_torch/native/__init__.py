"""ctypes binding of the native host runtime (``native/nvdb_host.cpp``), the
port of ``nvdb_tpu.native`` without JAX or ``ml_dtypes``: bf16 comes back as
``np.uint16`` bits.

The library is built from the repository's source at first use, with the
flags of ``native/Makefile``, into ``build/nvdb_tpu_torch/`` (never into
``native/``), keyed by a hash of the source, the flags and the host. The build runs under
a file lock and ends in an atomic rename, so processes that start together
build it once and never load a half-written file. A failed build raises
with the compiler's message. ``NVDB_FORCE_PY_HOST=1`` switches every entry
point to its numpy fallback (the A/B kill switch of the JAX package);
``available()`` says whether the native path is active.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from nvdb_tpu_torch.formats import vecbin

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "nvdb_host.cpp"
BUILD_DIR = _ROOT / "build" / "nvdb_tpu_torch"
# native/Makefile's CXXFLAGS and LDFLAGS
FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
         "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} on PATH: the native host library "
                           f"is built from {SOURCE} (set NVDB_FORCE_PY_HOST=1 for the "
                           f"numpy fallbacks)")
    return found


def library_path() -> Path:
    """Where the library of this source and these flags lives. The key holds
    the host's name too: ``-march=native`` code built on one machine may not
    run on another that shares the checkout."""
    h = hashlib.sha256(" ".join([*FLAGS, platform.node(), platform.machine()]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnvdb_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it exists; returns its path. Safe to call
    from processes that start together: one builds under the lock, the
    others wait and find the file. Raises with the compiler's output."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "nvdb_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.is_file():          # built by another process while this one waited
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_compiler(), *FLAGS[:-2], str(SOURCE), "-o", str(tmp), *FLAGS[-2:]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the native host library failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None under ``NVDB_FORCE_PY_HOST=1``."""
    global _lib
    if os.environ.get("NVDB_FORCE_PY_HOST", "0") == "1":
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.nvdb_convert_f32_to_bf16.argtypes = [
                f32p, ctypes.POINTER(ctypes.c_uint16), i64, ctypes.c_int]
            lib.nvdb_quantize_i8.argtypes = [
                f32p, ctypes.POINTER(ctypes.c_int8), f32p, i64, i64, ctypes.c_int]
            lib.nvdb_topk_dot_f32.argtypes = [
                f32p, i64, i64, f32p, i64, ctypes.c_int, f32p,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
            for fn in (lib.nvdb_convert_f32_to_bf16, lib.nvdb_quantize_i8,
                       lib.nvdb_topk_dot_f32):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """True when the native path is active (False under
    ``NVDB_FORCE_PY_HOST=1``). Builds the library if needed."""
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def convert_f32_to_bf16(src: np.ndarray, threads: int = 0) -> np.ndarray:
    """FP32 array -> bf16 bits (``np.uint16``, round to nearest even),
    threaded natively."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    lib = _load()
    if lib is None:
        return vecbin.to_bf16(src)
    out = np.empty(src.shape, dtype=np.uint16)
    rc = lib.nvdb_convert_f32_to_bf16(_ptr(src, ctypes.c_float), _ptr(out, ctypes.c_uint16),
                                      src.size, threads)
    if rc != 0:
        raise RuntimeError(f"nvdb_convert_f32_to_bf16 rc={rc}")
    return out


def quantize_i8(rows: np.ndarray, threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """FP32 rows -> (int8 rows, per-row scales), max-abs / 127, threaded
    natively."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    lib = _load()
    if lib is None:
        return vecbin.quantize_i8(rows)
    n, d = rows.shape
    out = np.empty((n, d), dtype=np.int8)
    scales = np.empty((n,), dtype=np.float32)
    rc = lib.nvdb_quantize_i8(_ptr(rows, ctypes.c_float), _ptr(out, ctypes.c_int8),
                              _ptr(scales, ctypes.c_float), n, d, threads)
    if rc != 0:
        raise RuntimeError(f"nvdb_quantize_i8 rc={rc}")
    return out, scales


def topk_dot_f32(base: np.ndarray, queries: np.ndarray, k: int,
                 threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host exact top-k by dot product, the independent native oracle:
    (scores [Q, k] f32, ids [Q, k] uint32), rows sorted descending, id
    0xFFFFFFFF with -inf past the end of a short base."""
    base = np.ascontiguousarray(base, dtype=np.float32)
    queries = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
    n, d = base.shape
    q = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"queries have {queries.shape[1]} dims, the base {d}")
    lib = _load()
    if lib is None:
        s = queries @ base.T
        ids = np.argsort(-s, axis=1, kind="stable")[:, :k].astype(np.uint32)
        return np.take_along_axis(s, ids.astype(np.int64), axis=1), ids
    scores = np.empty((q, k), dtype=np.float32)
    ids = np.empty((q, k), dtype=np.uint32)
    rc = lib.nvdb_topk_dot_f32(_ptr(base, ctypes.c_float), n, d,
                               _ptr(queries, ctypes.c_float), q, k,
                               _ptr(scores, ctypes.c_float), _ptr(ids, ctypes.c_uint32),
                               threads)
    if rc != 0:
        raise RuntimeError(f"nvdb_topk_dot_f32 rc={rc}")
    return scores, ids
