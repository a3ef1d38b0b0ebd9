"""IVF-PQ / IVF-OPQ-PQ index with exact refine (the port of
``nvdb_tpu.index.ivf_pq``).

Layout as in the JAX package: fixed-capacity packed lists, PQ codes
``[nlist, M, Lcap]`` uint8 (list-major, subspace rows, slot lanes), slot
ids ``[nlist, Lcap]`` int32 (-1 padding). All geometry lives in the OPQ-
rotated space; queries are rotated once at search time. Codes encode the
rotated residual against the list each row is packed in.

Search is coarse probe -> ADC candidate top-kk in the id mode the JAX
package picks (the key and gather modes: the fused key scan of
``adc_topk``; dma: its fused dma scan; both build the bf16 ADC tables in
shared memory and read the probed lists in place) -> exact refine
against the flat store or a residual-int8 store (the ``rerank_topk``
kernel), all on one device. ``.npz`` files are plain numpy
and byte-compatible with the JAX package's, so an index built by either
package loads in the other.

The build may refine the coarse quantizer over the whole corpus
(``corpus_refine_iters``); ``repack`` packs and encodes the rows again at
another capacity and spill depth, optionally in each row's top-R lists
(``replicas``), with the rotation, centroids and codebooks kept, bit for
bit the JAX package's on the same index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.index import graphs
from nvdb_tpu_torch.index.ivf_flat import (_coarse_probes, _host_chunked, _pack_lists,
                                           _stage_logger, _topS_centroids, coarse_terms)
from nvdb_tpu_torch.kernels import adc_scan, dispatch, kmeans, ops, pq
from nvdb_tpu_torch.utils import round_up

# The candidate generators of every id mode on the kernel path: the fused scan
# (the default; the key scan in the key and gather modes, the dma scan in the
# dma mode) and the table kernel followed by the scan of the tables (the
# key scan, the scan of the gathered code slab or the staged dma scan: the A/B).
KEY_SCANS = ("fused", "tables")


def _ivfpq_search_block(
    q_rot: torch.Tensor,       # [B, Dp] rotated queries
    centroids: torch.Tensor,   # [nlist, Dp]
    codebooks: torch.Tensor,   # [M, 256, dsub]
    codes: torch.Tensor,       # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor,    # [nlist, Lcap] int32
    k: int,
    nprobe: int,
    m: int,
    backend: str = "auto",
    dedup: int = 0,            # replica count of the index (<= 1: ids unique)
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (kernel path)
    terms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cached coarse_terms
    ids_mode: str = "dma",     # "key" / "gather": prefix-packed, replicas == 1 only
    key_scan: str = "fused",   # "fused", or "tables" (the two-kernel A/B)
    leads: Optional[torch.Tensor] = None,  # dma, dedup > 1: cached adc_scan.tile_leads
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse probes, ADC tables and the ADC candidate top-k of one batch.
    The kernel path runs the fused scans, which build each pair's bf16
    tables in shared memory (none in device memory; each query's share of
    every entry comes from one query-term pass) and read each probed
    list's codes in place from ``codes``, once for a chunk of queries: the
    key and gather modes the fused key scan (``adc_fused_keys_cuda``; the
    gather mode's result is the key mode's bit for bit, so no code slab is
    made), the dma mode the fused dma scan (``adc_fused_topk_cuda``, which
    keeps a replicated row once). With ``key_scan="tables"`` each mode
    writes the bf16 tables in one pass (``adc_tables_cuda``) and scans them
    (``adc_topk_cuda``, or ``adc_topk_keys_cuda``, over ``gather_codes``'
    slab in the gather mode): the A/B, the same candidates; no f32 table
    exists on it. A shape the fused scans cannot plan raises
    (``adc_scan.fused_plan``). The ``torch`` path runs the same routes'
    plain versions; the oracle path, the JAX package's jnp block, ignores
    ``ids_mode`` as that block does."""
    if key_scan not in KEY_SCANS:
        raise ValueError(f"key_scan must be one of {KEY_SCANS}, got {key_scan!r}")
    B = q_rot.shape[0]
    probes = _coarse_probes(q_rot, centroids, slot_ids, nprobe, terms=terms)  # [B, P]
    with trace.span("adc"):
        path = dispatch.refine_backend(backend, codes)
        keyed = ids_mode in ("key", "gather")
        fused = key_scan == "fused"
        if path == "cuda":
            probes = probes.to(torch.int32)       # once, for every kernel
            if fills is None:
                fills = adc_scan.list_fills(slot_ids)
            if fused and keyed:
                return adc_scan.adc_fused_keys_cuda(q_rot.contiguous(), probes, centroids,
                                                    codebooks, codes, slot_ids, k, fills=fills)
            if fused:
                return adc_scan.adc_fused_topk_cuda(q_rot.contiguous(), probes, centroids,
                                                    codebooks, codes, slot_ids, k, fills=fills,
                                                    dedup=dedup > 1, leads=leads)
            lut = adc_scan.adc_tables_cuda(q_rot.contiguous(), probes, centroids, codebooks,
                                           fills)
            if keyed:
                return adc_scan.adc_topk_keys_cuda(lut, probes, codes, slot_ids, k, fills=fills,
                                                   gathered=ids_mode == "gather")
            return adc_scan.adc_topk_cuda(lut, probes, codes, slot_ids, k, fills=fills)
        if path == "torch" and fused and keyed:
            return adc_scan.adc_fused_keys_reference(q_rot, probes, centroids, codebooks, codes,
                                                     slot_ids, k, fills=fills)
        if path == "torch" and fused:
            return adc_scan.adc_fused_topk_reference(q_rot, probes, centroids, codebooks, codes,
                                                     slot_ids, k, fills=fills, dedup=dedup > 1)
        if path == "torch":
            if fills is None:
                fills = adc_scan.list_fills(slot_ids)
            lut = adc_scan.adc_tables_reference(q_rot, probes, centroids, codebooks, fills)
            if ids_mode == "gather":
                return adc_scan.adc_topk_keys_reference(
                    lut, probes, adc_scan.gather_codes(codes, probes), slot_ids, k,
                    fills=fills, gathered=True)
            if keyed:
                return adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, k,
                                                        fills=fills)
            return adc_scan.adc_topk_reference(lut, probes, codes, slot_ids, k)
        # the JAX package's jnp path: f32 tables, gathered code slabs
        residuals = q_rot[:, None, :] - centroids[probes]                # [B, P, Dp]
        lut = pq.adc_lut(residuals.reshape(B * nprobe, -1), codebooks, m)
        lut = lut.reshape(B, nprobe, m, pq.KSUB)                         # [B, P, M, 256]
        code_slab = codes[probes].transpose(-1, -2)                      # [B, P, L, M]
        sids = slot_ids[probes]                                          # [B, P, L]
        scores = torch.where(sids >= 0, pq.adc_scores(lut, code_slab), ops.NEG_INF)
        if dedup > 1:
            return ops.dedup_topk(scores.reshape(B, -1), sids.reshape(B, -1), k)
        return ops.topk_sorted(scores.reshape(B, -1), sids.reshape(B, -1), k)


@dataclasses.dataclass
class IVFPQIndex:
    rotation: Optional[torch.Tensor]  # [Dp, Dp] f32 (OPQ) or None
    centroids: torch.Tensor           # [nlist, Dp] f32 (rotated space)
    codebooks: torch.Tensor           # [M, 256, dsub] f32
    codes: torch.Tensor               # [nlist, M, Lcap] uint8
    slot_ids: torch.Tensor            # [nlist, Lcap] int32
    n: int
    d: int
    m: int
    n_spilled: int = 0
    replicas: int = 1                 # > 1: each row encoded in its top-R lists
    _fills: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    _ids_mode: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)
    _coarse: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _leads: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    _graphs: graphs.GraphCache = dataclasses.field(
        default_factory=graphs.GraphCache, init=False, repr=False, compare=False)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def lcap(self) -> int:
        return self.codes.shape[2]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def fills(self) -> torch.Tensor:
        """[nlist] live-slot counts (1 + last live slot), cached: the ADC
        kernel reads no lane past them."""
        if self._fills is None:
            self._fills = adc_scan.list_fills(self.slot_ids)
        return self._fills

    def tile_leads(self) -> torch.Tensor:
        """[nlist, Lcap] the fused dma scan's repeated-id map
        (``adc_scan.tile_leads``) of a replicated index, cached."""
        if self._leads is None:
            self._leads = adc_scan.tile_leads(self.slot_ids)
        return self._leads

    def coarse_terms(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(||c||^2, live-list mask) of the coarse ranking, cached."""
        if self._coarse is None:
            self._coarse = coarse_terms(self.centroids, self.slot_ids)
        return self._coarse

    def ids_mode(self) -> str:
        """The id strategy of refine candidates, as the JAX package picks it:
        'key' (ids derived from list and lane) when the lists are
        prefix-packed and replicas == 1, else 'dma'. Checked once, cached."""
        if self._ids_mode is None:
            ok = self.replicas <= 1 and adc_scan.is_prefix_packed(self.slot_ids)
            self._ids_mode = "key" if ok else "dma"
        return self._ids_mode

    @property
    def index_bytes(self) -> int:
        b = self.codes.numel() + self.slot_ids.numel() * 4
        b += self.centroids.numel() * 4 + self.codebooks.numel() * 4
        if self.rotation is not None:
            b += self.rotation.numel() * 4
        return b

    # -- build -----------------------------------------------------------------

    @classmethod
    def build(
        cls,
        rows_f32: np.ndarray,
        nlist: int,
        m: int = 64,                   # PQ_M analogue (must divide Dp)
        use_opq: bool = True,          # USE_OPQ
        train_size: int = 50_000,      # IVF_TRAIN
        n_iters: int = 10,
        opq_iters: int = 4,            # OPQ_NITER
        pad_factor: float = 2.5,
        spill_candidates: int = 4,
        seed: int = 0,
        cb_train_size: Optional[int] = None,   # None -> min(n, 262144)
        cb_iters: int = 12,
        corpus_refine_iters: int = 0,
        *,
        device,
    ) -> "IVFPQIndex":
        """Train and pack an index on ``device``, the stages of
        ``nvdb_tpu.index.ivf_pq.IVFPQIndex.build``: OPQ rotation, coarse
        k-means in rotated space, top-S coarse assignment, list packing,
        PQ codebooks on the residuals, encoding. Random draws come from
        ``torch.Generator``s seeded from ``seed`` (not the JAX package's
        numbers). ``corpus_refine_iters`` > 0 refines the coarse quantizer
        with that many corpus passes (``kmeans.corpus_refine``, seeded
        ``seed + 1``)."""
        device = torch.device(device)
        n, d = rows_f32.shape
        dp = round_up(d, 128)
        if dp % m != 0:
            raise ValueError(f"m={m} must divide the padded dim {dp}")
        gen = torch.Generator(device=device).manual_seed(seed)
        stage = _stage_logger(n)

        stage("pad corpus")
        data_p = np.zeros((n, dp), np.float32)
        data_p[:, :d] = rows_f32
        t = min(train_size, n)

        rot = None
        if use_opq:
            # rotation quality saturates far below coarse-quantizer train sizes
            t_opq = min(t, 131072)
            stage(f"train OPQ rotation (t={t_opq})")
            rot_np, _ = pq.train_opq(gen, data_p[:t_opq], m, n_opq_iters=opq_iters,
                                     device=device)
            rot = torch.from_numpy(rot_np).to(device)
            stage("apply rotation")
            data_rot = _rotate(data_p, rot)
            del data_p
        else:
            data_rot = data_p

        stage(f"k-means coarse quantizer (t={t}, nlist={nlist})")
        cents, _ = kmeans.kmeans_fit(gen, torch.from_numpy(data_rot[:t]).to(device),
                                     nlist, n_iters=n_iters)
        if corpus_refine_iters > 0:
            stage(f"corpus-scale Lloyd refinement ({corpus_refine_iters} passes)")
            cents = kmeans.corpus_refine(data_rot, cents, n_iters=corpus_refine_iters,
                                         seed=seed + 1, log=stage)

        stage("coarse assignment (top-S centroids, device-chunked)")
        S = min(spill_candidates, nlist)
        alts = _host_chunked(lambda x: _topS_centroids(x, cents, S), data_rot, device)
        # Lcap is the lane dim of the transposed code layout
        lcap = round_up(int(np.ceil(n / nlist * pad_factor)), 128)

        # pack row ids first (codes depend on the packed list's centroid)
        stage(f"pack lists (lcap={lcap})")
        dummy = np.zeros((n, 1), np.float32)
        _, slot_ids, _, spilled = _pack_lists(dummy, None, alts[:, 0], None, alts,
                                              nlist, lcap, 1)

        # residuals against the packed list's centroid, in place
        cents_np = cents.cpu().numpy()
        list_of = np.zeros(n, np.int64)  # spilled rows: centroid 0, unused
        li, si = np.nonzero(slot_ids >= 0)
        list_of[slot_ids[li, si]] = li
        stage("residual subtraction")
        for s in range(0, n, 1_000_000):
            data_rot[s:s + 1_000_000] -= cents_np[list_of[s:s + 1_000_000]]
        residuals = data_rot

        tcb = min(n, cb_train_size or 262144)
        stage(f"train PQ codebooks (t={tcb})")
        cb = pq.train_codebooks(gen, torch.from_numpy(residuals[:tcb]).to(device), m,
                                n_iters=cb_iters)

        stage("PQ encode")
        codes_rows = _encode(residuals, cb, m, host=n >= _HOST_BUILD_ROWS)
        stage("scatter codes into list slabs")
        codes = np.zeros((nlist, m, lcap), np.uint8)
        codes[li, :, si] = codes_rows[slot_ids[li, si]]

        stage("upload index arrays")
        return cls(rotation=rot, centroids=cents, codebooks=cb,
                   codes=torch.from_numpy(codes).to(device),
                   slot_ids=torch.from_numpy(slot_ids).to(device),
                   n=n, d=d, m=m, n_spilled=spilled)

    @classmethod
    def repack(cls, idx: "IVFPQIndex", rows_f32: np.ndarray, pad_factor: float = 4.0,
               spill_candidates: int = 8, replicas: int = 1) -> "IVFPQIndex":
        """Pack and encode the rows again at a new capacity and spill depth,
        with the index's rotation, centroids and codebooks kept
        (``nvdb_tpu.index.ivf_pq.IVFPQIndex.repack``): minutes instead of the
        k-means and OPQ build. ``replicas`` R > 1 encodes each row in its
        top-R lists: copy r of a row (virtual row ``r * n + i``) prefers its
        (r+1)-th nearest list, ``S = min(max(S, R), nlist)``, and slot ids
        are ``vid % n``, so search returns each id once (the ``dma`` mode
        with its duplicate pass). Runs on the index's device; the stages
        whose output is corpus-sized run on the host from ``_HOST_BUILD_ROWS``
        corpus rows, as in ``build``."""
        device = idx.device
        n, d = rows_f32.shape
        nlist, dp = idx.centroids.shape
        m = idx.m
        stage = _stage_logger(n)
        stage("pad corpus")
        data_rot = np.zeros((n, dp), np.float32)
        data_rot[:, :d] = rows_f32
        if idx.rotation is not None:
            stage("apply rotation")
            data_rot = _rotate(data_rot, idx.rotation)

        R = max(1, min(replicas, nlist))
        S = min(max(spill_candidates, R), nlist)
        stage("coarse assignment (top-S centroids, device-chunked)")
        alts = _host_chunked(lambda x: _topS_centroids(x, idx.centroids, S), data_rot,
                             device)
        if R > 1:
            # virtual rows: copy r of row i prefers the (r+1)-th nearest list
            alts = np.concatenate(
                [np.concatenate([alts[:, r:], np.repeat(alts[:, -1:], r, axis=1)], axis=1)
                 for r in range(R)], axis=0)
        n_v = n * R
        lcap = round_up(int(np.ceil(n_v / nlist * pad_factor)), 128)

        stage(f"pack lists (lcap={lcap}, replicas={R})")
        _, slot_vids, _, spilled = _pack_lists(np.zeros((n_v, 1), np.float32), None,
                                               alts[:, 0], None, alts, nlist, lcap, 1)

        # the residual of each placed virtual row against its list's
        # centroid, encoded in virtual-id order
        cents_np = idx.centroids.cpu().numpy()
        li, si = np.nonzero(slot_vids >= 0)
        vids = slot_vids[li, si]
        order = np.argsort(vids)
        ro, lo = vids[order] % n, li[order]
        stage("residual gather/subtract")
        residuals = np.empty((ro.shape[0], dp), np.float32)
        for s in range(0, ro.shape[0], 1_000_000):
            residuals[s:s + 1_000_000] = (data_rot[ro[s:s + 1_000_000]]
                                          - cents_np[lo[s:s + 1_000_000]])
        del data_rot

        stage("PQ encode")
        codes_rows = _encode(residuals, idx.codebooks, m, host=n >= _HOST_BUILD_ROWS)
        stage("scatter codes into list slabs")
        codes = np.zeros((nlist, m, lcap), np.uint8)
        codes[li[order], :, si[order]] = codes_rows
        slot_ids = np.where(slot_vids >= 0, slot_vids % n, -1).astype(np.int32)
        stage("upload index arrays")
        return cls(rotation=idx.rotation, centroids=idx.centroids, codebooks=idx.codebooks,
                   codes=torch.from_numpy(codes).to(device),
                   slot_ids=torch.from_numpy(slot_ids).to(device),
                   n=n, d=d, m=m, n_spilled=spilled, replicas=R)

    @classmethod
    def from_reference(cls, rotation, centroids, codebooks, codes, slot_ids, n: int,
                       d: int, m: int, n_spilled: int = 0, replicas: int = 1, *,
                       device) -> "IVFPQIndex":
        """Carry an index across from ``nvdb_tpu``: each array is ``np.asarray``
        of the JAX index's field (``rotation`` may be None)."""
        t = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt)).to(device)
        return cls(rotation=None if rotation is None else t(rotation, np.float32),
                   centroids=t(centroids, np.float32),
                   codebooks=t(codebooks, np.float32), codes=t(codes, np.uint8),
                   slot_ids=t(slot_ids, np.int32), n=int(n), d=int(d), m=int(m),
                   n_spilled=int(n_spilled), replicas=int(replicas))

    # -- search ----------------------------------------------------------------

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int,
                      refine_k: int = 0, refine_store=None, backend: str = "auto",
                      for_refine: bool = False, refine_metric: str = "l2",
                      ids_mode: Optional[str] = None, key_scan: str = "fused",
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded on-device queries [B, Dp] in, device tensors out: coarse ->
        ADC -> optional exact refine against ``refine_store`` (a
        ``VectorStore`` of the original rows, or a residual-int8 store of
        this index's rotated space, which is scored with the rotated
        queries and the dequantized rows' norms).

        ``backend``: ``auto`` takes the CUDA kernels on a CUDA index and the
        JAX package's jnp path on the CPU; ``cuda`` the kernels (raising on
        the CPU); ``torch`` the kernels' plain versions. ``refine_metric``:
        "l2" (2 q.r - ||r||^2) or "dot".

        ``ids_mode`` overrides the candidate generator (None: ``self.ids_mode()``
        when the results are refine candidates, ``refine_k > 0`` or
        ``for_refine`` as for ``tools.ivf_eval``'s staged stage A, else
        'dma', whose ranking is exact f32). 'key' and 'gather' rank at bf16
        granularity and need a prefix-packed index with replicas == 1. The
        cuda and torch paths run the mode; the oracle path keeps the jnp
        semantics, as the JAX package's jnp backend does. ``key_scan``: the
        candidate generator of every mode, ``fused`` (one fused kernel that
        builds the tables in shared memory and reads each probed list in
        place: the fused key scan, the gather mode then being the key mode,
        or the fused dma scan) or ``tables`` (the table kernel, then the key
        kernel, in the gather mode the kernel over the gathered code slab, in
        the dma mode the staged dma scan: the A/B arm, bit for bit the same
        candidates).

        On the card, with the fused scan and every stage on its kernel, the
        chain is captured once a shape in a CUDA graph and replayed, bit for
        bit the eager call (``index/graphs.py``); every other call runs
        eagerly. A replayed index serves one CUDA stream at a time."""
        with trace.span("ivfpq.search", b=queries.shape[0], k=k, nprobe=nprobe,
                        refine_k=refine_k) as root:
            if ids_mode not in (None, "dma", "key", "gather"):
                raise ValueError(f"ids_mode must be 'dma', 'key' or 'gather', got {ids_mode!r}")
            # the key modes derive ids from list and lane, right only on a
            # prefix-packed index with unique ids
            if ids_mode in ("key", "gather") and self.ids_mode() != "key":
                raise ValueError(
                    f"ids_mode={ids_mode!r} requires a prefix-packed index with "
                    f"replicas == 1 (this index: replicas={self.replicas}, "
                    f"auto mode {self.ids_mode()!r}); use ids_mode='dma' or None")
            nprobe = min(nprobe, self.nlist)
            if refine_k > 0:
                if refine_store is None:
                    raise ValueError("refine_k > 0 requires refine_store")
                # refining fewer than k candidates cannot give k results
                refine_k = max(refine_k, k)
            mode = ids_mode or (self.ids_mode() if (refine_k > 0 or for_refine) else "dma")
            chain = lambda q: self._search_chain(q, k, nprobe, refine_k, refine_store, backend,
                                                 refine_metric, mode, key_scan)
            paths = [dispatch.refine_backend(backend, self.codes)]
            if refine_k > 0:
                paths.append(dispatch.refine_path(backend, refine_store.vectors))
            if key_scan == "fused" and graphs.engages(queries, paths):
                return self._graphs.run(
                    root, self._graph_parts(k, nprobe, refine_k, refine_store, refine_metric,
                                            mode, key_scan), queries, chain)
            return graphs.eager(root, chain, queries)

    def _graph_parts(self, k: int, nprobe: int, refine_k: int, refine_store,
                     refine_metric: str, mode: str, key_scan: str) -> tuple:
        """What a served call's chain depends on besides its batch and the
        index's own tensors, as ``search_device`` resolved it (``nprobe`` at
        most nlist, ``refine_k`` at least k, ``mode`` the id mode taken):
        its scalars, and the refine store with its tensors."""
        store = ()
        if refine_k > 0:
            st = refine_store
            store = (st, st.vectors, st.scales, st.res_cents, st.res_ids)
        return (k, nprobe, refine_k, refine_metric, mode, key_scan) + store

    def _search_chain(self, queries: torch.Tensor, k: int, nprobe: int, refine_k: int,
                      refine_store, backend: str, refine_metric: str, mode: str,
                      key_scan: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device work of ``search_device`` on its resolved arguments:
        rotation, coarse ranking and ADC candidates, then the refine."""
        kk = max(k, refine_k)
        q_rot = queries
        if self.rotation is not None:
            with trace.span("rotate"):
                q_rot = _matmul(queries, self.rotation)
        path = dispatch.refine_backend(backend, self.codes)
        dispatch.check_finite("IVF-PQ queries", q_rot)
        cuda = path == "cuda"
        v, i = _ivfpq_search_block(q_rot, self.centroids, self.codebooks, self.codes,
                                   self.slot_ids, kk, nprobe, self.m, backend=backend,
                                   dedup=self.replicas,
                                   fills=self.fills() if cuda else None,
                                   terms=self.coarse_terms(), ids_mode=mode,
                                   key_scan=key_scan,
                                   leads=(self.tile_leads() if cuda and mode == "dma"
                                          and self.replicas > 1 and key_scan == "fused"
                                          else None))
        dispatch.check_finite("IVF-PQ ADC candidate scores", v, i)
        if refine_k > 0:
            # a residual-int8 store dequantizes against the index's rotated
            # centroids: score it with q_rot (the dot is rotation-invariant)
            residual = refine_store.is_residual
            v, i = dispatch.exact_refine(
                q_rot if residual else queries, i[:, :refine_k], refine_store.vectors,
                refine_store.scales, k, metric=refine_metric, backend=backend,
                norms2=(refine_store.norms2()
                        if refine_metric == "l2"
                        and dispatch.refine_path(backend, refine_store.vectors) != "oracle"
                        else None),
                res_cents=refine_store.res_cents if residual else None,
                res_ids=refine_store.res_ids if residual else None)
        return v[:, :k], i[:, :k]

    def search(self, queries: np.ndarray, k: int, nprobe: int, refine_k: int = 0,
               refine_store=None, q_chunk: int = 256, backend: str = "auto",
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Host path: numpy queries [Q, d] in, (scores [Q, k] f32, ids [Q, k]
        int64) out, one ``search_device`` per ``q_chunk`` queries."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        qn = queries.shape[0]
        dp = self.centroids.shape[1]
        qp = np.zeros((qn, dp), np.float32)
        qp[:, :self.d] = queries[:, :self.d]
        vals_out = np.empty((qn, k), np.float32)
        ids_out = np.empty((qn, k), np.int64)
        for s in range(0, qn, q_chunk):
            e = min(s + q_chunk, qn)
            v, i = self.search_device(torch.from_numpy(qp[s:e]).to(self.device), k,
                                      nprobe, refine_k=refine_k,
                                      refine_store=refine_store, backend=backend)
            vals_out[s:e] = v.cpu().numpy()
            ids_out[s:e] = i.cpu().numpy()
        return vals_out, ids_out

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` layout, byte for byte."""
        np.savez(
            path,
            rotation=(self.rotation.cpu().numpy() if self.rotation is not None
                      else np.zeros(0, np.float32)),
            centroids=self.centroids.cpu().numpy(),
            codebooks=self.codebooks.cpu().numpy(),
            codes=self.codes.cpu().numpy(),
            slot_ids=self.slot_ids.cpu().numpy(),
            # 5th field = codes-layout version: 2 -> [nlist, M, Lcap];
            # 6th = replicas (absent on v1 files -> 1)
            meta=np.array([self.n, self.d, self.m, self.n_spilled, 2, self.replicas],
                          np.int64),
        )

    @classmethod
    def load(cls, path: str, *, device) -> "IVFPQIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        rot = z["rotation"]
        meta = [int(x) for x in z["meta"]]
        n, d, m, spilled = meta[:4]
        codes = z["codes"]
        if len(meta) < 5 or meta[4] < 2:
            codes = np.ascontiguousarray(codes.transpose(0, 2, 1))  # v1 layout
        return cls.from_reference(rot if rot.size else None, z["centroids"],
                                  z["codebooks"], codes, z["slot_ids"], n, d, m,
                                  n_spilled=spilled,
                                  replicas=meta[5] if len(meta) > 5 else 1,
                                  device=device)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    ops.no_tf32()
    return x @ w


# Above this row count the build stages whose output is corpus-sized (the
# rotation, the encoding) run on the host, as in the JAX package.
_HOST_BUILD_ROWS = 2_000_000


def _rotate_inplace_host(data_p: np.ndarray, rot_np: np.ndarray,
                         chunk: int = 1_000_000) -> np.ndarray:
    """data_p @ rot, chunked in place on the host (BLAS)."""
    rot_np = np.asarray(rot_np, np.float32)
    for s in range(0, data_p.shape[0], chunk):
        data_p[s:s + chunk] = data_p[s:s + chunk] @ rot_np
    return data_p


def _rotate(data_p: np.ndarray, rot: torch.Tensor) -> np.ndarray:
    """Host rows times the rotation: in place on the host from
    ``_HOST_BUILD_ROWS`` rows, else in row chunks on the rotation's device."""
    if data_p.shape[0] >= _HOST_BUILD_ROWS:
        return _rotate_inplace_host(data_p, rot.cpu().numpy())
    return _host_chunked(lambda x: _matmul(x, rot), data_p, rot.device)


def _encode(residuals: np.ndarray, cb: torch.Tensor, m: int, host: bool) -> np.ndarray:
    """PQ codes [N, M] uint8 of host residual rows: on the host
    (``_encode_host``) or in row chunks on the codebooks' device."""
    if host:
        return _encode_host(residuals, cb.cpu().numpy(), m)
    return _host_chunked(lambda x: pq.encode(x, cb, m), residuals, cb.device)


def _encode_host(residuals: np.ndarray, cb_np: np.ndarray, m: int,
                 chunk: int = 262_144) -> np.ndarray:
    """Host PQ encode: per-subspace argmax of x.c - ||c||^2 / 2 (argmin L2,
    first index on ties), as ``pq.encode``; [N, M] uint8 on the host."""
    cb_np = np.asarray(cb_np, np.float32)          # [M, 256, dsub]
    dsub = cb_np.shape[2]
    half_norms = 0.5 * np.sum(cb_np * cb_np, axis=2)
    out = np.empty((residuals.shape[0], m), np.uint8)
    for s in range(0, residuals.shape[0], chunk):
        x = residuals[s:s + chunk]
        for j in range(m):
            xj = x[:, j * dsub:(j + 1) * dsub]
            out[s:s + chunk, j] = np.argmax(xj @ cb_np[j].T - half_norms[j],
                                            axis=1).astype(np.uint8)
    return out
