"""vecbin64 / raw12 embedding-matrix formats, bit-compatible with
``nvdb_tpu.formats.vecbin`` and the reference's on-disk layout.

- vecbin64: 64-byte packed little-endian header ``{u64 magic "NVDBVEC1", u32 version,
  u32 dtype, u32 dim, u32 reserved0, u64 count, pad}`` followed by the row-major
  payload; for Int8 the payload is followed by per-row FP32 scales
  (reference vecbin_format.h:17-29, 52-58; vector_dataset.cpp:61-87).
- raw12 (legacy): ``{u32 count, u32 reserved, u32 dim}`` + FP32 payload.

Dtype code 4 is bfloat16. numpy has no bfloat16, so this module holds bf16
payloads as their raw ``np.uint16`` bits: ``to_bf16`` rounds f32 to nearest
even (the same bits ``ml_dtypes`` gives), ``bf16_to_f32`` widens exactly, and
``bf16_bits_to_torch`` copies the bits into a ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

MAGIC = 0x4E56444256454331  # "NVDBVEC1" read as a big-endian u64 constant
VERSION = 1

DTYPE_F32 = 1
DTYPE_F16 = 2
DTYPE_I8 = 3
DTYPE_BF16 = 4  # nvdb_tpu extension

HEADER_BYTES = 64
RAW12_BYTES = 12

_HEADER_NP = np.dtype(
    [
        ("magic", "<u8"),
        ("version", "<u4"),
        ("dtype", "<u4"),
        ("dim", "<u4"),
        ("reserved0", "<u4"),
        ("count", "<u8"),
        ("pad", "V32"),
    ]
)
assert _HEADER_NP.itemsize == HEADER_BYTES

_NP_BY_CODE = {
    DTYPE_F32: np.dtype("<f4"),
    DTYPE_F16: np.dtype("<f2"),
    DTYPE_I8: np.dtype("i1"),
    DTYPE_BF16: np.dtype("<u2"),  # raw bf16 bits
}
_CODE_BY_NAME = {"f32": DTYPE_F32, "f16": DTYPE_F16, "i8": DTYPE_I8, "bf16": DTYPE_BF16}
_NAME_BY_CODE = {v: k for k, v in _CODE_BY_NAME.items()}


def dtype_name(code: int) -> str:
    return _NAME_BY_CODE.get(code, f"unknown({code})")


def dtype_code(name: str) -> int:
    try:
        return _CODE_BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; expected one of {sorted(_CODE_BY_NAME)}")


def bytes_per_elem(code: int) -> int:
    """Payload bytes per element (vecbin_format.h:38-43, + bf16 extension)."""
    return _NP_BY_CODE[code].itemsize


def payload_and_aux_bytes(count: int, dim: int, code: int) -> int:
    """Total payload + per-row-scale bytes — the reference's ``bytes_per_query``
    notion for bandwidth accounting (vecbin_format.h:52-58, nvdb_bench.cpp:414-421)."""
    total = count * dim * bytes_per_elem(code)
    if code == DTYPE_I8:
        total += count * 4  # per-row fp32 scales
    return total


@dataclasses.dataclass(frozen=True)
class VecbinInfo:
    path: str
    count: int
    dim: int
    dtype: int  # DTYPE_* code
    legacy_raw12: bool
    payload_offset: int

    @property
    def dtype_str(self) -> str:
        return dtype_name(self.dtype)


class VecbinFile:
    """Zero-copy reader for vecbin64 / raw12 files. Vectors and scales are numpy
    memmaps (bf16 as ``uint16`` bits) — nothing is loaded until sliced."""

    def __init__(self, path: str):
        size = os.path.getsize(path)
        if size < RAW12_BYTES:
            raise ValueError(f"{path}: file too small ({size} bytes)")
        with open(path, "rb") as f:
            head = f.read(HEADER_BYTES)

        self.info = self._parse_header(path, head, size)
        info = self.info
        self.vectors = np.memmap(
            path,
            mode="r",
            dtype=_NP_BY_CODE[info.dtype],
            offset=info.payload_offset,
            shape=(info.count, info.dim),
        )
        self.scales: Optional[np.memmap] = None
        if info.dtype == DTYPE_I8:
            scales_off = info.payload_offset + info.count * info.dim
            self.scales = np.memmap(
                path, mode="r", dtype="<f4", offset=scales_off, shape=(info.count,)
            )

    @staticmethod
    def _parse_header(path: str, head: bytes, size: int) -> VecbinInfo:
        if len(head) >= HEADER_BYTES:
            h = np.frombuffer(head[:HEADER_BYTES], dtype=_HEADER_NP)[0]
            if int(h["magic"]) == MAGIC:
                if int(h["version"]) != VERSION:
                    raise ValueError(f"{path}: unsupported vecbin version {int(h['version'])}")
                code = int(h["dtype"])
                if code not in _NP_BY_CODE:
                    raise ValueError(f"{path}: unsupported dtype code {code}")
                count, dim = int(h["count"]), int(h["dim"])
                expect = HEADER_BYTES + payload_and_aux_bytes(count, dim, code)
                if size != expect:
                    raise ValueError(
                        f"{path}: size mismatch: have {size} bytes, header implies {expect}"
                    )
                return VecbinInfo(path, count, dim, code, False, HEADER_BYTES)
        # legacy raw12 fallback: [u32 count][u32 reserved][u32 dim] + f32 payload
        count, _reserved, dim = np.frombuffer(head[:RAW12_BYTES], dtype="<u4")
        count, dim = int(count), int(dim)
        expect = RAW12_BYTES + count * dim * 4
        if count == 0 or dim == 0 or size != expect:
            raise ValueError(f"{path}: not a vecbin64 or raw12 file")
        return VecbinInfo(path, count, dim, DTYPE_F32, True, RAW12_BYTES)

    @property
    def count(self) -> int:
        return self.info.count

    @property
    def dim(self) -> int:
        return self.info.dim

    @property
    def dtype(self) -> int:
        return self.info.dtype

    def rows_f32(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Materialize rows [start, stop) as FP32, applying int8 per-row scales —
        the ``base_row_to_f32`` analogue (to_f32_row.h:10-34)."""
        stop = self.count if stop is None else stop
        rows = np.asarray(self.vectors[start:stop])
        rows = bf16_to_f32(rows) if self.dtype == DTYPE_BF16 else rows.astype(np.float32)
        if self.scales is not None:
            rows = rows * np.asarray(self.scales[start:stop], dtype=np.float32)[:, None]
        return rows


def _header_bytes(count: int, dim: int, code: int) -> bytes:
    h = np.zeros((), dtype=_HEADER_NP)
    h["magic"] = MAGIC
    h["version"] = VERSION
    h["dtype"] = code
    h["dim"] = dim
    h["count"] = count
    return h.tobytes()


def write_vecbin(
    path: str,
    vectors: np.ndarray,
    dtype: Optional[str] = None,
    scales: Optional[np.ndarray] = None,
    legacy_raw12: bool = False,
) -> VecbinInfo:
    """Write a vecbin64 (or raw12) file in one shot.

    ``dtype`` is one of f32/f16/bf16/i8 (default: inferred from ``vectors``;
    ``np.uint16`` rows are bf16 bits). For i8, ``scales`` (per-row fp32) is
    required.
    """
    vectors = np.ascontiguousarray(vectors)
    if vectors.ndim != 2:
        raise ValueError("vectors must be [count, dim]")
    count, dim = vectors.shape
    if dtype is None:
        rev = {np.dtype("<f4"): "f32", np.dtype("<f2"): "f16", np.dtype("i1"): "i8",
               np.dtype("<u2"): "bf16"}
        dtype = rev[vectors.dtype]
    code = dtype_code(dtype)
    if vectors.dtype != _NP_BY_CODE[code]:
        raise ValueError(f"vectors dtype {vectors.dtype} does not match requested {dtype}")

    if legacy_raw12:
        if code != DTYPE_F32:
            raise ValueError("raw12 supports f32 only")
        with open(path, "wb") as f:
            f.write(np.asarray([count, 0, dim], dtype="<u4").tobytes())
            vectors.tofile(f)
        return VecbinInfo(path, count, dim, code, True, RAW12_BYTES)

    if code == DTYPE_I8:
        if scales is None or scales.shape != (count,):
            raise ValueError("i8 vecbin requires per-row scales of shape [count]")
    with open(path, "wb") as f:
        f.write(_header_bytes(count, dim, code))
        vectors.tofile(f)
        if code == DTYPE_I8:
            np.ascontiguousarray(scales, dtype="<f4").tofile(f)
    return VecbinInfo(path, count, dim, code, False, HEADER_BYTES)


class StreamingVecbinWriter:
    """Chunked vecbin64 writer whose header is patched at close (the
    streamed-write pattern of ``nvdb_tpu.formats.vecbin``; i8 scales are
    buffered and appended at the end, as nvdb_quantize_i8.cpp:49-85 does).
    bf16 rows are ``np.uint16`` bits."""

    def __init__(self, path: str, dim: int, dtype: str = "f32", resume_rows: int = 0):
        """``resume_rows > 0`` reopens an interrupted write (its header still
        says count 0) and continues after that many payload rows, which the
        caller counts (e.g. down to a chunk boundary). i8 streams are not
        resumable: their scales live in memory until close."""
        self.path = path
        self.dim = dim
        self.code = dtype_code(dtype)
        self._np_dt = _NP_BY_CODE[self.code]
        self._count = 0
        self._scales: list[np.ndarray] = []
        if resume_rows > 0:
            if self.code == DTYPE_I8:
                raise ValueError("i8 streams are not resumable (scales are buffered "
                                 "in memory and appended at close)")
            end = HEADER_BYTES + resume_rows * dim * self._np_dt.itemsize
            if os.path.getsize(path) < end:
                raise ValueError(f"{path} has fewer than {resume_rows} rows")
            self._f = open(path, "r+b")
            self._f.truncate(end)
            self._f.seek(end)
            self._count = resume_rows
        else:
            self._f = open(path, "wb")
            self._f.write(_header_bytes(0, dim, self.code))  # patched on close

    def append(self, rows: np.ndarray, scales: Optional[np.ndarray] = None) -> None:
        rows = np.ascontiguousarray(rows, dtype=self._np_dt)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"rows must be [n, {self.dim}]")
        rows.tofile(self._f)
        self._count += rows.shape[0]
        if self.code == DTYPE_I8:
            if scales is None or scales.shape != (rows.shape[0],):
                raise ValueError("i8 rows require matching per-row scales")
            self._scales.append(np.ascontiguousarray(scales, dtype="<f4"))

    def close(self) -> VecbinInfo:
        for s in self._scales:
            s.tofile(self._f)
        self._f.seek(0)
        self._f.write(_header_bytes(self._count, self.dim, self.code))
        self._f.close()
        return VecbinInfo(self.path, self._count, self.dim, self.code, False, HEADER_BYTES)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- dtype conversion -------------------------------------------------------------


def quantize_i8(rows_f32: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """FP32 rows -> (int8 rows, per-row fp32 scales) with symmetric max-abs
    scaling ``scale = max|x| / 127``, round-half-even, clamp to ±127 — the
    same arithmetic as ``nvdb_tpu.formats.vecbin.quantize_i8``."""
    rows_f32 = np.asarray(rows_f32, dtype=np.float32)
    max_abs = np.max(np.abs(rows_f32), axis=1)
    scales = np.where(max_abs > 0, max_abs / 127.0, 1.0).astype(np.float32)
    q = np.rint(rows_f32 / scales[:, None])
    q = np.clip(q, -127, 127).astype(np.int8)
    return q, scales


def dequantize_i8(rows_i8: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return rows_i8.astype(np.float32) * np.asarray(scales, dtype=np.float32)[:, None]


def to_bf16(rows: np.ndarray) -> np.ndarray:
    """FP32 -> bf16 bits (``np.uint16``), round to nearest even. A NaN becomes
    the quiet NaN of its sign, as ``ml_dtypes.bfloat16`` does."""
    f = np.ascontiguousarray(rows, dtype=np.float32)
    u = f.view(np.uint32)
    nan = np.isnan(f)
    # the add cannot wrap for non-NaN inputs: the largest is -inf, 0xFF800000
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    out = ((np.where(nan, np.uint32(0), u) + bias) >> np.uint32(16)).astype(np.uint16)
    if nan.any():
        out[nan] = (((u[nan] >> np.uint32(16)) & np.uint32(0x8000))
                    | np.uint32(0x7FC0)).astype(np.uint16)
    return out


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (``np.uint16``) -> FP32, exact."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def bf16_bits_to_torch(bits: np.ndarray):
    """bf16 bits (``np.uint16``) -> a CPU ``torch.bfloat16`` tensor holding a
    copy of the same bits (no rounding)."""
    import torch

    bits = np.array(bits, dtype=np.uint16)  # writable and contiguous
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
