"""gtbin cached ground-truth format, bit-compatible with the reference
(gtbin_format.h:18-35): 64-byte packed LE header ``{u64 magic "NVDBGT01",
u32 version, u32 metric, u32 k, u32 dim, u64 Q, u64 N, pad}`` followed by
``uint32 gt_ids[Q * k]``."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

GT_MAGIC = 0x4E56444247543031  # "NVDBGT01"
GT_VERSION = 1
METRIC_DOT_EQUIV_L2 = 1

HEADER_BYTES = 64

_HEADER_NP = np.dtype(
    [
        ("magic", "<u8"),
        ("version", "<u4"),
        ("metric", "<u4"),
        ("k", "<u4"),
        ("dim", "<u4"),
        ("Q", "<u8"),
        ("N", "<u8"),
        ("pad", "V24"),
    ]
)
assert _HEADER_NP.itemsize == HEADER_BYTES


@dataclasses.dataclass(frozen=True)
class GtInfo:
    path: str
    k: int
    dim: int
    Q: int
    N: int
    metric: int = METRIC_DOT_EQUIV_L2


def write_gtbin(path: str, ids: np.ndarray, dim: int, N: int,
                metric: int = METRIC_DOT_EQUIV_L2) -> GtInfo:
    """Write ground-truth ids of shape [Q, k] (the nvdb_gt_build output,
    nvdb_gt_build.cpp:107-124)."""
    ids = np.ascontiguousarray(ids, dtype="<u4")
    if ids.ndim != 2:
        raise ValueError("ids must be [Q, k]")
    Q, k = ids.shape
    h = np.zeros((), dtype=_HEADER_NP)
    h["magic"] = GT_MAGIC
    h["version"] = GT_VERSION
    h["metric"] = metric
    h["k"] = k
    h["dim"] = dim
    h["Q"] = Q
    h["N"] = N
    with open(path, "wb") as f:
        f.write(h.tobytes())
        ids.tofile(f)
    return GtInfo(path, k, dim, Q, N, metric)


def read_gtbin(path: str):
    """Read a gtbin file -> (GtInfo, ids memmap [Q, k]) with strict header/shape
    validation (the nvdb_ivf_eval checks, nvdb_ivf_eval.cpp:362-380)."""
    size = os.path.getsize(path)
    if size < HEADER_BYTES:
        raise ValueError(f"{path}: too small for gtbin")
    with open(path, "rb") as f:
        h = np.frombuffer(f.read(HEADER_BYTES), dtype=_HEADER_NP)[0]
    if int(h["magic"]) != GT_MAGIC:
        raise ValueError(f"{path}: bad gtbin magic")
    if int(h["version"]) != GT_VERSION:
        raise ValueError(f"{path}: unsupported gtbin version {int(h['version'])}")
    Q, k = int(h["Q"]), int(h["k"])
    expect = HEADER_BYTES + Q * k * 4
    if size != expect:
        raise ValueError(f"{path}: size mismatch: have {size}, header implies {expect}")
    info = GtInfo(path, k, int(h["dim"]), Q, int(h["N"]), int(h["metric"]))
    ids = np.memmap(path, mode="r", dtype="<u4", offset=HEADER_BYTES, shape=(Q, k))
    return info, ids
