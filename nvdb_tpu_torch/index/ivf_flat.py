"""IVF-Flat index (the port of ``nvdb_tpu.index.ivf_flat``) and the IVF
helpers the IVF-PQ index shares: list packing, the coarse probe ranking and
the top-S centroid assignment.

Layout as in the JAX package: fixed-capacity packed lists ``[nlist, Lcap,
Dp]`` (f32, bf16, or int8 with per-slot scales), rows assigned to their
nearest centroid with spill to the next-nearest list with room, padding
slots id -1 and zero. Probing is the coarse ranking (one full-f32 product
with the centroids, empty lists masked) and then the exact top-k over the
probed slabs: the ``ivf_probe_topk`` kernel on a CUDA index
(``dispatch.ivf_probe_topk``). ``.npz`` files are plain numpy and
byte-compatible with the JAX package's (a bf16 pack is stored as its uint8
view), so an index built by either package loads in the other.

The build trains the coarse quantizer on a subsample, optionally refines it
over the whole corpus (``corpus_refine_iters``), and packs; ``repack``
packs an index's rows again at another capacity and spill depth with its
centroids kept, as the JAX package's does, bit for bit on the same
centroids.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.kernels import adc_scan, dispatch, kmeans, ops
from nvdb_tpu_torch.utils import round_up


def _pack_lists(
    rows_enc: np.ndarray,          # [N, D] encoded payload (f32/bf16/i8)
    scales: Optional[np.ndarray],  # [N] f32 for i8
    assign: np.ndarray,            # [N] int32 nearest-centroid
    dists: Optional[np.ndarray],   # [N, S] distances to top-S centroids for spill
    alts: Optional[np.ndarray],    # [N, S] the top-S centroid ids
    nlist: int,
    lcap: int,
    d_padded: int,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]:
    """Pack rows into fixed-capacity lists at the slots ``place_rows`` gives
    them. Returns (packed [nlist, lcap, Dp], slot_ids [nlist, lcap],
    slot_scales, n_spilled)."""
    n, d = rows_enc.shape
    if alts is None:
        alts = assign[:, None]
    list_of, slot_of, spilled = place_rows(torch.from_numpy(np.asarray(alts, np.int64)),
                                           nlist, lcap)
    list_of, slot_of = list_of.numpy(), slot_of.numpy()

    packed = np.zeros((nlist, lcap, d_padded), dtype=rows_enc.dtype)
    slot_ids = np.full((nlist, lcap), -1, dtype=np.int32)
    packed[list_of, slot_of, :d] = rows_enc
    slot_ids[list_of, slot_of] = np.arange(n, dtype=np.int32)
    slot_scales = None
    if scales is not None:
        slot_scales = np.ones((nlist, lcap), dtype=np.float32)
        slot_scales[list_of, slot_of] = scales
    return packed, slot_ids, slot_scales, spilled


def _group_ranks(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its key group, in stable order."""
    m = keys.shape[0]
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    is_start = torch.ones(m, dtype=torch.bool, device=keys.device)
    is_start[1:] = sk[1:] != sk[:-1]
    pos = torch.arange(m, device=keys.device)
    start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    ranks = torch.empty(m, dtype=torch.int64, device=keys.device)
    ranks[order] = pos - start
    return ranks


def place_rows(alts: torch.Tensor, nlist: int, lcap: int
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The list and slot of every row, on the device of ``alts`` [N, S]
    (each row's S nearest lists, nearest first): each row goes to its
    nearest list with a free slot, in row order among the rows that want
    one list, one vectorized pass per candidate; rows left over pour into
    whatever lists still have room (the last resort). Returns (list_of [N],
    slot_of [N] int64, rows placed past their first candidate)."""
    dev = alts.device
    n = alts.shape[0]
    fill = torch.zeros(nlist, dtype=torch.int64, device=dev)
    list_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    spilled = 0
    unplaced = torch.arange(n, device=dev)
    for s in range(alts.shape[1]):
        if unplaced.numel() == 0:
            break
        cand = alts[unplaced, s].long()
        slots = fill[cand] + _group_ranks(cand)
        ok = slots < lcap
        rows_ok = unplaced[ok]
        list_of[rows_ok] = cand[ok]
        slot_of[rows_ok] = slots[ok]
        fill += torch.bincount(cand[ok], minlength=nlist)
        if s > 0:
            spilled += int(rows_ok.numel())
        unplaced = unplaced[~ok]
    if unplaced.numel():
        dest = torch.repeat_interleave(torch.arange(nlist, device=dev),
                                       lcap - fill)[:unplaced.numel()]
        if dest.numel() < unplaced.numel():
            raise ValueError("total list capacity too small for all rows")
        list_of[unplaced] = dest
        slot_of[unplaced] = fill[dest] + _group_ranks(dest)
        spilled += int(unplaced.numel())
    return list_of, slot_of, spilled


def coarse_terms(centroids: torch.Tensor, slot_ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parts of the coarse ranking that depend on the index alone:
    (||c||^2 [1, nlist] f32, the live-list mask [1, nlist] bool). The index
    classes cache them (``coarse_terms()``), as they cache ``fills()``."""
    return (torch.sum(centroids * centroids, dim=1)[None, :],
            (slot_ids >= 0).any(dim=1)[None, :])


def _coarse_probes(queries: torch.Tensor, centroids: torch.Tensor,
                   slot_ids: torch.Tensor, nprobe: int,
                   terms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Coarse top-nprobe lists by L2 (argmax 2 q.c - ||c||^2), full-f32
    products, with EMPTY lists masked out of the ranking: a dead k-means
    centroid keeps its init position, a corpus row, and near the query it
    would outrank the real cell means and burn probe slots on lists with
    no candidate. ``terms``: the index's cached ``coarse_terms``. Returns
    [B, nprobe] int64."""
    with trace.span("coarse"):
        ops.no_tf32()
        qc = queries @ centroids.T
        c2, live = terms if terms is not None else coarse_terms(centroids, slot_ids)
        return torch.topk(torch.where(live, 2.0 * qc - c2, ops.NEG_INF), nprobe,
                          dim=1).indices


def _topS_centroids(data: torch.Tensor, cents: torch.Tensor, s: int,
                    chunk: int = 65536) -> torch.Tensor:
    """[N, Dp] x [K, Dp] -> [N, S] int64 ids of the S nearest centroids (L2),
    chunked over rows, full-f32 products."""
    ops.no_tf32()
    c2 = torch.sum(cents * cents, dim=1)[None, :]
    return torch.cat([torch.topk(2.0 * (data[r:r + chunk] @ cents.T) - c2, s, dim=1).indices
                      for r in range(0, data.shape[0], chunk)])


def _stage_logger(n: int):
    """Stage timestamps on stderr for corpus-scale builds (n >= 1M rows);
    small builds stay silent."""
    if n < 1_000_000:
        return lambda msg: None
    t0 = time.perf_counter()

    def log(msg):
        print(f"[build +{time.perf_counter() - t0:7.1f}s] {msg}", file=sys.stderr,
              flush=True)
    return log


def _pad_rows(rows_f32: np.ndarray, dp: int) -> np.ndarray:
    """[N, d] f32 rows zero-padded to [N, dp] (the rows themselves when
    d == dp)."""
    n, d = rows_f32.shape
    if d == dp:
        return rows_f32
    out = np.zeros((n, dp), np.float32)
    out[:, :d] = rows_f32
    return out


def _host_chunked(fn, rows_np: np.ndarray, device, chunk: int = 1_000_000) -> np.ndarray:
    """Apply a device function over host rows in chunks and reassemble on
    the host: one chunk (<= ~3 GB at 768 dims) is on the device at a time."""
    outs = []
    for s in range(0, rows_np.shape[0], chunk):
        outs.append(fn(torch.from_numpy(rows_np[s:s + chunk]).to(device)).cpu().numpy())
    return np.concatenate(outs, axis=0)


def _ivf_search_block(
    queries: torch.Tensor,                # [B, Dp] f32
    centroids: torch.Tensor,              # [nlist, Dp] f32
    packed: torch.Tensor,                 # [nlist, Lcap, Dp]
    slot_ids: torch.Tensor,               # [nlist, Lcap] int32
    slot_scales: Optional[torch.Tensor],  # [nlist, Lcap] f32 | None
    k: int,
    nprobe: int,
    backend: str = "auto",
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (kernel path)
    terms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cached coarse_terms
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse probes, then the exact top-k over the probed slabs."""
    probes = _coarse_probes(queries, centroids, slot_ids, nprobe, terms=terms)  # [B, P]
    return dispatch.ivf_probe_topk(queries, probes, packed, slot_ids, slot_scales, k,
                                   backend=backend, fills=fills)


def _payload_tensor(enc: np.ndarray, code: int) -> torch.Tensor:
    """A host payload in its file encoding (bf16 as raw 2-byte bits) -> a
    CPU tensor of the index dtype."""
    if code == vecbin.DTYPE_BF16:
        return vecbin.bf16_bits_to_torch(np.asarray(enc).view(np.uint16))
    dt = np.int8 if code == vecbin.DTYPE_I8 else np.float32
    return torch.from_numpy(np.array(enc, dtype=dt))


@dataclasses.dataclass
class IVFFlatIndex:
    centroids: torch.Tensor               # [nlist, Dp] f32
    packed: torch.Tensor                  # [nlist, Lcap, Dp] f32 | bf16 | int8
    slot_ids: torch.Tensor                # [nlist, Lcap] int32
    slot_scales: Optional[torch.Tensor]   # [nlist, Lcap] f32 (int8 payloads)
    n: int
    d: int
    dtype_code: int
    n_spilled: int = 0
    _fills: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    _coarse: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def lcap(self) -> int:
        return self.packed.shape[1]

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def index_bytes(self) -> int:
        b = self.packed.numel() * self.packed.element_size()
        b += self.slot_ids.numel() * 4 + self.centroids.numel() * 4
        if self.slot_scales is not None:
            b += self.slot_scales.numel() * 4
        return b

    def fills(self) -> torch.Tensor:
        """[nlist] live-slot counts (1 + last live slot), cached: the probe
        kernel reads no row past them."""
        if self._fills is None:
            self._fills = adc_scan.list_fills(self.slot_ids)
        return self._fills

    def coarse_terms(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(||c||^2, live-list mask) of the coarse ranking, cached."""
        if self._coarse is None:
            self._coarse = coarse_terms(self.centroids, self.slot_ids)
        return self._coarse

    # -- build -----------------------------------------------------------------

    @classmethod
    def build(
        cls,
        rows_f32: np.ndarray,
        nlist: int,
        dtype: str = "f32",
        train_size: int = 50_000,      # IVF_TRAIN analogue
        n_iters: int = 10,
        pad_factor: float = 1.5,
        spill_candidates: int = 4,
        seed: int = 0,
        corpus_refine_iters: int = 0,
        *,
        device,
    ) -> "IVFFlatIndex":
        """Train and pack an index on ``device``, the stages of
        ``nvdb_tpu.index.ivf_flat.IVFFlatIndex.build``: k-means on the
        first ``train_size`` rows, top-S coarse assignment, list packing
        with spill, payload encoding. Random draws come from a
        ``torch.Generator`` seeded from ``seed`` (not the JAX package's
        numbers); the steps after k-means are deterministic.
        ``corpus_refine_iters`` > 0 refines the quantizer with that many
        corpus passes (``kmeans.corpus_refine``, seeded ``seed + 1``)."""
        rows_f32 = np.ascontiguousarray(rows_f32, dtype=np.float32)
        device = torch.device(device)
        n, d = rows_f32.shape
        dp = round_up(d, 128)
        gen = torch.Generator(device=device).manual_seed(seed)
        stage = _stage_logger(n)

        data_p = _pad_rows(rows_f32, dp)
        t = min(train_size, n)
        stage(f"k-means coarse quantizer (t={t}, nlist={nlist})")
        cents, _ = kmeans.kmeans_fit(gen, torch.from_numpy(data_p[:t]).to(device), nlist,
                                     n_iters=n_iters)
        if corpus_refine_iters > 0:
            # full-corpus Lloyd passes reclaim the lists that the subsample
            # quantizer leaves dead on the corpus
            stage(f"corpus-scale Lloyd refinement ({corpus_refine_iters} passes)")
            cents = kmeans.corpus_refine(data_p, cents, n_iters=corpus_refine_iters,
                                         seed=seed + 1, log=stage)
        return cls._pack(cents, rows_f32, data_p, vecbin.dtype_code(dtype),
                         spill_candidates, pad_factor, stage)

    @classmethod
    def repack(cls, idx: "IVFFlatIndex", rows_f32: np.ndarray, pad_factor: float = 2.5,
               spill_candidates: int = 8) -> "IVFFlatIndex":
        """Pack the rows again at a new capacity and spill depth with the
        index's centroids kept (``nvdb_tpu.index.ivf_flat.IVFFlatIndex.repack``):
        on a skewed corpus tight packing sends overflow rows to far lists,
        where probing misses them. Re-encodes in the index's own dtype, on
        the index's device."""
        rows_f32 = np.ascontiguousarray(rows_f32, dtype=np.float32)
        stage = _stage_logger(rows_f32.shape[0])
        data_p = _pad_rows(rows_f32, idx.packed.shape[2])
        return cls._pack(idx.centroids, rows_f32, data_p, idx.dtype_code,
                         spill_candidates, pad_factor, stage)

    @classmethod
    def _pack(cls, cents: torch.Tensor, rows_f32: np.ndarray, data_p: np.ndarray,
              code: int, spill_candidates: int, pad_factor: float, stage
              ) -> "IVFFlatIndex":
        """Top-S coarse assignment against ``cents`` (on their device), list
        packing with spill at ``lcap = round_up(ceil(n / nlist * pad), 32)``,
        payload encoding in ``code``; the stages build and repack share."""
        device = cents.device
        n, d = rows_f32.shape
        nlist, dp = cents.shape
        stage("coarse assignment (top-S centroids, device-chunked)")
        S = min(spill_candidates, nlist)
        alts = _host_chunked(lambda x: _topS_centroids(x, cents, S), data_p, device)
        # 32 = the strictest sublane tile of the JAX layout, kept for equal shapes
        lcap = round_up(int(np.ceil(n / nlist * pad_factor)), 32)

        stage("encode payload")
        scales = None
        if code == vecbin.DTYPE_I8:
            enc, scales = vecbin.quantize_i8(rows_f32)
        elif code == vecbin.DTYPE_BF16:
            enc = vecbin.to_bf16(rows_f32)
        else:
            enc = rows_f32

        stage(f"pack lists (lcap={lcap})")
        packed, slot_ids, slot_scales, spilled = _pack_lists(
            enc, scales, alts[:, 0], None, alts, nlist, lcap, dp)
        del enc
        stage("upload index arrays")
        return cls(
            centroids=cents,
            packed=_payload_tensor(packed, code).to(device),
            slot_ids=torch.from_numpy(slot_ids).to(device),
            slot_scales=(torch.from_numpy(slot_scales).to(device)
                         if slot_scales is not None else None),
            n=n, d=d, dtype_code=code, n_spilled=spilled)

    @classmethod
    def from_reference(cls, centroids, packed, slot_ids, slot_scales, n: int, d: int,
                       dtype_code: int, n_spilled: int = 0, *, device) -> "IVFFlatIndex":
        """Carry an index across from ``nvdb_tpu``: each array is
        ``np.asarray`` of the JAX index's field (a bf16 pack in any 2-byte
        dtype, read as raw bits; ``slot_scales`` may be None)."""
        code = int(dtype_code)
        return cls(
            centroids=torch.from_numpy(np.array(centroids, dtype=np.float32)).to(device),
            packed=_payload_tensor(packed, code).to(device),
            slot_ids=torch.from_numpy(np.array(slot_ids, dtype=np.int32)).to(device),
            slot_scales=(None if slot_scales is None else
                         torch.from_numpy(np.array(slot_scales, dtype=np.float32)).to(device)),
            n=int(n), d=int(d), dtype_code=code, n_spilled=int(n_spilled))

    # -- search ----------------------------------------------------------------

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int,
                      backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded on-device queries [B, Dp] in, device tensors out (scores
        [B, k] f32, ids [B, k] int32).

        ``backend``: ``auto`` takes the probe kernel on a CUDA index and the
        JAX package's jnp path on the CPU; ``cuda`` the kernel (raising on
        the CPU); ``torch`` the kernel's plain version."""
        with trace.span("ivfflat.search", b=queries.shape[0], k=k, nprobe=nprobe):
            nprobe = min(nprobe, self.nlist)
            return _ivf_search_block(queries, self.centroids, self.packed, self.slot_ids,
                                     self.slot_scales, k, nprobe, backend=backend,
                                     fills=self.fills(), terms=self.coarse_terms())

    def search(self, queries: np.ndarray, k: int, nprobe: int, q_chunk: int = 32,
               backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Host path: numpy queries [Q, d] in, (scores [Q, k] f32, ids [Q, k]
        int64) out, one ``search_device`` per ``q_chunk`` queries."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        qn = queries.shape[0]
        dp = self.packed.shape[2]
        qp = np.zeros((qn, dp), np.float32)
        qp[:, :self.d] = queries[:, :self.d]
        vals_out = np.empty((qn, k), np.float32)
        ids_out = np.empty((qn, k), np.int64)
        for s in range(0, qn, q_chunk):
            e = min(s + q_chunk, qn)
            v, i = self.search_device(torch.from_numpy(qp[s:e]).to(self.device), k, nprobe,
                                      backend=backend)
            vals_out[s:e] = v.cpu().numpy()
            ids_out[s:e] = i.cpu().numpy()
        return vals_out, ids_out

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` layout, byte for byte (a bf16 pack as
        its uint8 view)."""
        packed = self.packed.cpu()
        if packed.dtype == torch.bfloat16:
            packed = packed.view(torch.int16).numpy().view(np.uint8)
        else:
            packed = packed.numpy()
        np.savez(
            path,
            centroids=self.centroids.cpu().numpy(),
            packed=packed,
            packed_dtype=np.array(self.dtype_code),
            slot_ids=self.slot_ids.cpu().numpy(),
            slot_scales=(self.slot_scales.cpu().numpy() if self.slot_scales is not None
                         else np.zeros(0, np.float32)),
            meta=np.array([self.n, self.d, self.n_spilled], dtype=np.int64),
        )

    @classmethod
    def load(cls, path: str, *, device) -> "IVFFlatIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        code = int(z["packed_dtype"])
        packed = z["packed"]
        if code == vecbin.DTYPE_BF16:
            packed = np.ascontiguousarray(packed).view(np.uint16)
        n, d, spilled = (int(x) for x in z["meta"])
        sc = z["slot_scales"]
        return cls.from_reference(z["centroids"], packed, z["slot_ids"],
                                  sc if sc.size else None, n, d, code, n_spilled=spilled,
                                  device=device)
