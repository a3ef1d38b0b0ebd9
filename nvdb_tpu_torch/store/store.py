"""Device-resident embedding store (the port of ``nvdb_tpu.store.store``).

Rows live on one torch device as a single padded dense tensor, dtype-aware
(f32 / bf16 / int8 + per-row f32 scales). Padding policy as in the reference
package: rows are padded up to a multiple of ``row_block`` and dims up to a
multiple of 128. Padding rows and dims are zero; padding rows get scale 1.0
and are masked out of every scan by ``n`` (the valid-row count).

``norms2`` caches the squared row norms the l2 rerank folds in. A
residual-int8 store (``attach_residual``) holds int8 codes of each row's
residual against a coarse centroid: row i = res_cents[res_ids[i]] +
scales[i] * vectors[i].

A row-sharded store (``ShardedVectorStore``, the port of a ``VectorStore``
whose arrays carry a row sharding) holds one ``VectorStore`` per row shard
of a ``dist.mesh.Mesh``; ``n_shards`` pads the rows to a multiple of
``row_block * n_shards`` as the JAX package does, so the shards are equal.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.utils import round_up

# dtype-code -> torch dtype of the device payload
_TORCH_BY_CODE = {
    vecbin.DTYPE_F32: torch.float32,
    vecbin.DTYPE_BF16: torch.bfloat16,
    vecbin.DTYPE_F16: torch.bfloat16,  # f16 files are re-encoded to bf16
    vecbin.DTYPE_I8: torch.int8,
}

DEFAULT_ROW_BLOCK = 4096

# rows per host block when streaming a file to the device
_UPLOAD_ROWS = 65536


def _store_code(code: int) -> int:
    return vecbin.DTYPE_BF16 if code == vecbin.DTYPE_F16 else code


def _encode_host(rows: np.ndarray, store_code: int) -> torch.Tensor:
    """Host rows in a file encoding -> a CPU tensor in the store encoding
    (bf16 via round-to-nearest-even bits; bf16 bits pass through)."""
    if store_code == vecbin.DTYPE_BF16:
        bits = rows if rows.dtype == np.uint16 else vecbin.to_bf16(rows)
        return vecbin.bf16_bits_to_torch(bits)
    if store_code == vecbin.DTYPE_I8:
        return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int8))
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32))


def _scales_tensor(scales: np.ndarray, n: int, np_pad: int, device) -> torch.Tensor:
    s_host = np.ones((np_pad,), dtype=np.float32)
    s_host[:n] = scales
    return torch.from_numpy(s_host).to(device)


def _residual_norms2(vectors: torch.Tensor, scales: torch.Tensor, res_cents: torch.Tensor,
                     res_ids: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
    """[Np] f32 squared norms of the dequantized residual rows, chunked so
    the f32 dequantized slab stays bounded."""
    out = []
    for s in range(0, vectors.shape[0], chunk):
        row = (res_cents[res_ids[s:s + chunk].long()]
               + vectors[s:s + chunk].to(torch.float32) * scales[s:s + chunk, None])
        out.append(torch.sum(row * row, dim=1))
    return torch.cat(out)


@dataclasses.dataclass
class VectorStore:
    """Device-resident base matrix.

    vectors: [Np, Dp] (padded), dtype float32 | bfloat16 | int8
    scales:  [Np] float32 per-row scales (int8 only; padding rows get 1.0)
    n, d:    valid row / dim counts
    dtype_code: vecbin DTYPE_* describing the *store* encoding
    src_dtype_code: dtype of the file it came from (for bytes-per-query parity)
    """

    vectors: torch.Tensor
    scales: Optional[torch.Tensor]
    n: int
    d: int
    dtype_code: int
    src_dtype_code: int
    _norms2: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    # residual-int8 stores: the centroids [nlist, Dp] f32 (in the space of
    # the quantizer they came from; queries scoring the store live there
    # too) and each row's centroid id [Np] int32
    res_cents: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    res_ids: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def is_residual(self) -> bool:
        return self.res_cents is not None

    def attach_residual(self, cents: np.ndarray, list_of: np.ndarray) -> "VectorStore":
        """Mark an int8 store as residual codes against ``cents`` (host
        arrays: the coarse centroids [nlist, >= d] and each row's list id
        [n]). Padding rows map to centroid 0 with scale 1; candidate ids are
        always valid rows, so they are never gathered."""
        if self.dtype_code != vecbin.DTYPE_I8:
            raise ValueError("residual stores are int8")
        dp = self.d_padded
        c = np.zeros((cents.shape[0], dp), np.float32)
        c[:, :min(cents.shape[1], dp)] = cents[:, :dp]
        ids = np.zeros((self.n_padded,), np.int32)
        ids[:self.n] = list_of[:self.n]
        self.res_cents = torch.from_numpy(c).to(self.device)
        self.res_ids = torch.from_numpy(ids).to(self.device)
        self._norms2 = None
        return self

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_numpy(
        cls,
        x: np.ndarray,
        dtype: str = "f32",
        scales: Optional[np.ndarray] = None,
        row_block: int = DEFAULT_ROW_BLOCK,
        src_dtype_code: Optional[int] = None,
        n_shards: int = 1,
        *,
        device,
    ) -> "VectorStore":
        """Build a store on ``device`` from host rows.

        ``x`` is either raw f32 rows (converted per ``dtype``) or rows already
        in the target encoding (int8 with ``scales``, or bf16 as ``np.uint16``
        bits). Rows are padded to a multiple of ``row_block * n_shards``.
        """
        code = vecbin.dtype_code(dtype)
        n, d = x.shape
        if code == vecbin.DTYPE_I8 and x.dtype != np.int8:
            x, scales = vecbin.quantize_i8(x)
        if code == vecbin.DTYPE_I8 and scales is None:
            raise ValueError("int8 rows need their per-row scales")
        store_code = _store_code(code)

        np_pad = round_up(max(n, 1), row_block * max(n_shards, 1))
        dp = round_up(d, 128)
        # filled block by block: no padded copy of the rows on the host
        vecs = torch.zeros((np_pad, dp), dtype=_TORCH_BY_CODE[store_code], device=device)
        for b0 in range(0, n, _UPLOAD_ROWS):
            b1 = min(b0 + _UPLOAD_ROWS, n)
            vecs[b0:b1, :d].copy_(_encode_host(x[b0:b1], store_code))

        sc = None
        if code == vecbin.DTYPE_I8:
            sc = _scales_tensor(scales, n, np_pad, device)
        return cls(vecs, sc, n, d, store_code,
                   src_dtype_code if src_dtype_code is not None else code)

    @classmethod
    def from_vecbin(
        cls,
        path: str,
        row_block: int = DEFAULT_ROW_BLOCK,
        n_shards: int = 1,
        row_range: Optional[Tuple[int, int]] = None,
        *,
        device,
    ) -> "VectorStore":
        """Streamed load: the padded device tensor is filled block by block
        straight from the mmap'd file, so peak host memory is one block of
        ``_UPLOAD_ROWS`` rows, not a padded copy of the file. Rows are padded
        to a multiple of ``row_block * n_shards``. ``row_range=(r0, r1)``
        loads rows [r0, r1) of that padded layout alone (one shard's, read
        from the file and nothing else of it); the store's ``n`` is then the
        valid rows among them."""
        f = vecbin.VecbinFile(path)
        code = f.dtype
        store_code = _store_code(code)
        n, d = f.count, f.dim
        np_pad = round_up(max(n, 1), row_block * max(n_shards, 1))
        dp = round_up(d, 128)
        r0, r1 = row_range if row_range is not None else (0, np_pad)
        if not 0 <= r0 <= r1 <= np_pad:
            raise ValueError(f"row range [{r0}, {r1}) outside the {np_pad} padded rows")
        v0, v1 = min(r0, n), min(r1, n)

        vecs = torch.zeros((r1 - r0, dp), dtype=_TORCH_BY_CODE[code], device=device)
        for b0 in range(v0, v1, _UPLOAD_ROWS):
            b1 = min(b0 + _UPLOAD_ROWS, v1)
            rows = np.array(f.vectors[b0:b1])  # a writable host copy of the block
            vecs[b0 - r0:b1 - r0, :d].copy_(_encode_host(rows, store_code))

        sc = None
        if store_code == vecbin.DTYPE_I8:
            sc = _scales_tensor(np.asarray(f.scales[v0:v1]), v1 - v0, r1 - r0, device)
        return cls(vecs, sc, v1 - v0, d, store_code, code)

    @classmethod
    def from_reference(
        cls,
        vectors: np.ndarray,
        scales: Optional[np.ndarray],
        n: int,
        d: int,
        dtype_code: int,
        src_dtype_code: int,
        *,
        device,
    ) -> "VectorStore":
        """Carry a store across from ``nvdb_tpu``: ``vectors`` and ``scales``
        are ``np.asarray`` of its padded payload and scales (bf16 in any
        2-byte dtype, read as raw bits). The payload is bit-identical."""
        if dtype_code == vecbin.DTYPE_BF16:
            vecs = vecbin.bf16_bits_to_torch(np.asarray(vectors).view(np.uint16))
        else:
            vecs = _encode_host(np.array(vectors), dtype_code)
        sc = None
        if scales is not None:
            sc = torch.from_numpy(np.array(scales, dtype=np.float32)).to(device)
        return cls(vecs.to(device), sc, n, d, dtype_code, src_dtype_code)

    # -- properties -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def n_padded(self) -> int:
        return self.vectors.shape[0]

    @property
    def d_padded(self) -> int:
        return self.vectors.shape[1]

    @property
    def payload_bytes(self) -> int:
        """Reference ``bytes_per_query`` semantics: valid payload + aux bytes of
        the store encoding (nvdb_bench.cpp:414-421)."""
        return vecbin.payload_and_aux_bytes(self.n, self.d, self.dtype_code)

    @property
    def hbm_bytes(self) -> int:
        """Device bytes streamed per full scan (padded shapes)."""
        b = self.n_padded * self.d_padded * self.vectors.element_size()
        if self.scales is not None:
            b += self.n_padded * 4
        return b

    def norms2(self) -> torch.Tensor:
        """[Np] f32 squared norms of the raw rows (int8: of the codes; a
        residual store: of the dequantized rows cent + s * codes, which the
        l2 rerank needs), computed once on the store's device and cached."""
        if self._norms2 is None:
            from nvdb_tpu_torch.kernels.rerank import store_norms2

            if self.is_residual:
                self._norms2 = _residual_norms2(self.vectors, self.scales,
                                                self.res_cents, self.res_ids)
            else:
                self._norms2 = store_norms2(self.vectors)
        return self._norms2

    def pad_queries(self, q: np.ndarray) -> np.ndarray:
        """Zero-pad query dims to the store's padded dim."""
        q = np.asarray(q, dtype=np.float32)
        if q.shape[1] == self.d_padded:
            return q
        out = np.zeros((q.shape[0], self.d_padded), dtype=np.float32)
        out[:, : q.shape[1]] = q[:, : self.d]
        return out


@dataclasses.dataclass
class ShardedVectorStore:
    """A store row-sharded over the ``rows`` axis of a ``dist.mesh.Mesh``:
    one ``VectorStore`` per row shard this process holds, on that row's
    device. Shard ``s`` holds padded rows [s * rows_per_shard, (s + 1) *
    rows_per_shard) of the global layout, its ``n`` the valid rows among
    them; ``n`` is the global count. Each shard caches its own ``norms2``
    (a residual store's: of its dequantized rows); a residual store's
    ``res_ids`` are sliced with the rows and its ``res_cents`` are whole on
    every shard's device, as the JAX package places them."""

    mesh: object
    shards: List[VectorStore]
    n: int
    rows_per_shard: int

    @classmethod
    def from_store(cls, store: VectorStore, mesh) -> "ShardedVectorStore":
        """Split a store into the mesh's row shards (``dist.mesh.shard_rows``:
        views of the store's own tensors when every shard is on its device,
        copies otherwise). Its padded rows must divide into equal shards."""
        from nvdb_tpu_torch.dist.mesh import shard_rows

        n_rows = mesh.shape["rows"]
        if store.n_padded % n_rows != 0:
            raise ValueError(f"{store.n_padded} padded rows do not split into {n_rows} "
                             f"equal shards; build the store with n_shards={n_rows}")
        rps = store.n_padded // n_rows
        parts = lambda t: [None] * len(mesh.local_rows) if t is None else shard_rows(t, mesh)
        shards = []
        for s, v, sc, ri in zip(mesh.local_rows, parts(store.vectors), parts(store.scales),
                                parts(store.res_ids)):
            shard = VectorStore(v, sc, min(max(store.n - s * rps, 0), rps), store.d,
                                store.dtype_code, store.src_dtype_code)
            if store.is_residual:
                shard.res_cents = store.res_cents.to(v.device)
                shard.res_ids = ri
            shards.append(shard)
        return cls(mesh, shards, store.n, rps)

    @classmethod
    def from_numpy(cls, x: np.ndarray, mesh, dtype: str = "f32",
                   scales: Optional[np.ndarray] = None, row_block: int = DEFAULT_ROW_BLOCK,
                   src_dtype_code: Optional[int] = None) -> "ShardedVectorStore":
        """``VectorStore.from_numpy`` padded for the mesh's row shards, built
        on the host and each shard moved to its device."""
        store = VectorStore.from_numpy(x, dtype, scales, row_block, src_dtype_code,
                                       n_shards=mesh.shape["rows"], device="cpu")
        return cls.from_store(store, mesh)

    @classmethod
    def from_vecbin(cls, path: str, mesh, row_block: int = DEFAULT_ROW_BLOCK
                    ) -> "ShardedVectorStore":
        """Streamed load of the shards this process holds, each straight from
        its rows of the mmap'd file onto its device: no process reads
        another's rows or holds the whole matrix."""
        n_rows = mesh.shape["rows"]
        f = vecbin.VecbinFile(path)
        rps = round_up(max(f.count, 1), row_block * n_rows) // n_rows
        shards = [VectorStore.from_vecbin(path, row_block, n_rows, (s * rps, (s + 1) * rps),
                                          device=mesh.row_device(s))
                  for s in mesh.local_rows]
        return cls(mesh, shards, f.count, rps)

    # -- the VectorStore surface ----------------------------------------------

    @property
    def vectors(self) -> List[torch.Tensor]:
        return [s.vectors for s in self.shards]

    @property
    def scales(self) -> Optional[List[torch.Tensor]]:
        return None if self.shards[0].scales is None else [s.scales for s in self.shards]

    @property
    def res_cents(self) -> Optional[List[torch.Tensor]]:
        return None if not self.is_residual else [s.res_cents for s in self.shards]

    @property
    def res_ids(self) -> Optional[List[torch.Tensor]]:
        return None if not self.is_residual else [s.res_ids for s in self.shards]

    @property
    def is_residual(self) -> bool:
        return self.shards[0].is_residual

    @property
    def d(self) -> int:
        return self.shards[0].d

    @property
    def dtype_code(self) -> int:
        return self.shards[0].dtype_code

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.mesh.shape["rows"]

    @property
    def d_padded(self) -> int:
        return self.shards[0].d_padded

    @property
    def payload_bytes(self) -> int:
        return vecbin.payload_and_aux_bytes(self.n, self.d, self.dtype_code)

    def norms2(self) -> List[torch.Tensor]:
        """Each shard's cached ``VectorStore.norms2``."""
        return [s.norms2() for s in self.shards]

    def attach_residual(self, cents: np.ndarray, list_of: np.ndarray) -> "ShardedVectorStore":
        """``VectorStore.attach_residual`` on every shard, with its slice of
        the rows' list ids."""
        for s, shard in zip(self.mesh.local_rows, self.shards):
            r0 = s * self.rows_per_shard
            shard.attach_residual(cents, list_of[r0:r0 + shard.n])
        return self

    def pad_queries(self, q: np.ndarray) -> np.ndarray:
        return self.shards[0].pad_queries(q)
