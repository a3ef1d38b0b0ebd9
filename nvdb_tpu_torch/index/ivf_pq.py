"""IVF-PQ / IVF-OPQ-PQ index with exact refine (the port of
``nvdb_tpu.index.ivf_pq``).

Layout as in the JAX package: fixed-capacity packed lists, PQ codes
``[nlist, M, Lcap]`` uint8 (list-major, subspace rows, slot lanes), slot
ids ``[nlist, Lcap]`` int32 (-1 padding). All geometry lives in the OPQ-
rotated space; queries are rotated once at search time. Codes encode the
rotated residual against the list each row is packed in.

Search is coarse probe -> ADC candidate top-kk in the id mode the JAX
package picks, one candidate generator a mode (the key and gather modes:
the fused key scan of ``adc_topk``; dma: its fused dma scan; both build
the bf16 ADC tables in shared memory and read the probed lists in place)
-> exact refine against the flat store or a residual-int8 store (the
``rerank_topk`` kernel), all on one device. The staged ADC kernels (the
table kernel, then a scan of the tables) take tables as the JAX
package's ``pallas_adc_topk`` does; they stay in ``kernels/adc_scan.py``
for the A/B tools and run on no search path. ``.npz`` files are plain numpy
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
from nvdb_tpu_torch.index.ivf_flat import (_coarse_probes, _stage_logger, _topS_centroids,
                                           coarse_terms, place_rows)
from nvdb_tpu_torch.kernels import adc_scan, dispatch, kmeans, ops, pq
from nvdb_tpu_torch.utils import round_up


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
    leads: Optional[torch.Tensor] = None,  # dma, dedup > 1: cached adc_scan.tile_leads
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse probes and the ADC candidate top-k of one batch, one candidate
    generator an id mode. The kernel path runs the fused scans, which build
    each pair's bf16 tables in shared memory (none in device memory; each
    query's share of every entry comes from one query-term pass) and read
    each probed list's codes in place from ``codes``, once for a chunk of
    queries: the key and gather modes the fused key scan
    (``adc_fused_keys_cuda``; the gather mode's result is the key mode's bit
    for bit, so no code slab is made), the dma mode the fused dma scan
    (``adc_fused_topk_cuda``, which keeps a replicated row once). A shape
    the fused scans cannot plan raises (``adc_scan.fused_plan``). The
    ``torch`` path runs their plain versions; the oracle path, the JAX
    package's jnp block, ignores ``ids_mode`` as that block does. The
    staged kernels, which take tables as ``pallas_adc_topk`` does, stay in
    ``kernels/adc_scan.py`` for the A/B tools."""
    B = q_rot.shape[0]
    probes = _coarse_probes(q_rot, centroids, slot_ids, nprobe, terms=terms)  # [B, P]
    with trace.span("adc"):
        path = dispatch.refine_backend(backend, codes)
        keyed = ids_mode in ("key", "gather")
        if path == "cuda":
            probes = probes.to(torch.int32)       # once, for every kernel
            if fills is None:
                fills = adc_scan.list_fills(slot_ids)
            if keyed:
                return adc_scan.adc_fused_keys_cuda(q_rot.contiguous(), probes, centroids,
                                                    codebooks, codes, slot_ids, k, fills=fills)
            return adc_scan.adc_fused_topk_cuda(q_rot.contiguous(), probes, centroids,
                                                codebooks, codes, slot_ids, k, fills=fills,
                                                dedup=dedup > 1, leads=leads)
        if path == "torch" and keyed:
            return adc_scan.adc_fused_keys_reference(q_rot, probes, centroids, codebooks, codes,
                                                     slot_ids, k, fills=fills)
        if path == "torch":
            return adc_scan.adc_fused_topk_reference(q_rot, probes, centroids, codebooks, codes,
                                                     slot_ids, k, fills=fills, dedup=dedup > 1)
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
        ``seed + 1``). The padded corpus stays on ``device`` where it fits
        (``_Stages``), and every stage runs there; each stage is a
        ``build.*`` span."""
        device = torch.device(device)
        n, d = rows_f32.shape
        dp = round_up(d, 128)
        if dp % m != 0:
            raise ValueError(f"m={m} must divide the padded dim {dp}")
        gen = torch.Generator(device=device).manual_seed(seed)
        st = _Stages(n, dp, device)
        t = min(train_size, n)

        work = st.upload(rows_f32, dp)
        rot = None
        if use_opq:
            # rotation quality saturates far below coarse-quantizer train sizes
            t_opq = min(t, 131072)
            with st("build.opq", t_opq, h2d=st.moved(t_opq * dp * 4)):
                rot_np, _ = pq.train_opq(gen, work[:t_opq], m, n_opq_iters=opq_iters,
                                         device=device)
                rot = torch.from_numpy(rot_np).to(device)
            with st("build.rotate", n, h2d=st.moved(n * dp * 4), d2h=st.moved(n * dp * 4)):
                _rotate_rows(work, rot, device)

        with st("build.kmeans", t, h2d=st.moved(t * dp * 4)):
            cents, _ = kmeans.kmeans_fit(gen, work[:t].to(device), nlist, n_iters=n_iters)
            if corpus_refine_iters > 0:
                cents = kmeans.corpus_refine(work, cents, n_iters=corpus_refine_iters,
                                             seed=seed + 1, log=st.log)

        S = min(spill_candidates, nlist)
        with st("build.assign", n, h2d=st.moved(n * dp * 4)):
            alts = torch.cat([_topS_centroids(x, cents, S) for x in _chunks(work, device)])
        # Lcap is the lane dim of the transposed code layout
        lcap = round_up(int(np.ceil(n / nlist * pad_factor)), 128)
        with st("build.pack", n):
            list_of, slot_of, spilled = place_rows(alts, nlist, lcap)
            del alts
            slot_ids = _slot_ids(list_of, slot_of, nlist, lcap)

        tcb = min(n, cb_train_size or 262144)
        with st("build.codebooks", tcb, h2d=st.moved(tcb * dp * 4)):
            res = work[:tcb].to(device) - cents[list_of[:tcb]]
            cb = pq.train_codebooks(gen, res, m, n_iters=cb_iters)
            del res
        with st("build.encode", n, h2d=st.moved(n * dp * 4)):
            codes = _encode_lists(work, torch.arange(n, device=device), list_of, slot_of,
                                  cents, cb, nlist, lcap)
        del work
        st.release()
        return cls(rotation=rot, centroids=cents, codebooks=cb, codes=codes,
                   slot_ids=slot_ids.to(torch.int32), n=n, d=d, m=m, n_spilled=spilled)

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
        with its duplicate pass). Runs on the index's device, with the
        padded corpus there where it fits, as in ``build``."""
        device = idx.device
        n, d = rows_f32.shape
        nlist, dp = idx.centroids.shape
        st = _Stages(n, dp, device)
        work = st.upload(rows_f32, dp)
        if idx.rotation is not None:
            with st("build.rotate", n, h2d=st.moved(n * dp * 4), d2h=st.moved(n * dp * 4)):
                _rotate_rows(work, idx.rotation, device)

        R = max(1, min(replicas, nlist))
        S = min(max(spill_candidates, R), nlist)
        with st("build.assign", n, h2d=st.moved(n * dp * 4)):
            alts = torch.cat([_topS_centroids(x, idx.centroids, S)
                              for x in _chunks(work, device)])
        if R > 1:
            # virtual rows: copy r of row i prefers the (r+1)-th nearest list
            alts = torch.cat([torch.cat([alts[:, r:], alts[:, -1:].repeat(1, r)], dim=1)
                              for r in range(R)])
        n_v = n * R
        lcap = round_up(int(np.ceil(n_v / nlist * pad_factor)), 128)
        with st("build.pack", n_v):
            list_of, slot_of, spilled = place_rows(alts, nlist, lcap)
            del alts
            slot_vids = _slot_ids(list_of, slot_of, nlist, lcap)
            slot_ids = torch.where(slot_vids >= 0, slot_vids % n, -1).to(torch.int32)
        # the residual of each virtual row against its list's centroid
        with st("build.encode", n_v, h2d=st.moved(n_v * dp * 4)):
            codes = _encode_lists(work, torch.arange(n_v, device=device) % n, list_of,
                                  slot_of, idx.centroids, idx.codebooks, nlist, lcap)
        del work
        st.release()
        return cls(rotation=idx.rotation, centroids=idx.centroids, codebooks=idx.codebooks,
                   codes=codes, slot_ids=slot_ids, n=n, d=d, m=idx.m, n_spilled=spilled,
                   replicas=R)

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
                      ids_mode: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
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
        semantics, as the JAX package's jnp backend does. Each mode has one
        candidate generator on the kernel path, a fused kernel that builds
        the tables in shared memory and reads each probed list in place: the
        fused key scan in the key and gather modes (the gather mode then
        being the key mode), the fused dma scan in the dma mode.

        On the card, with every stage on its kernel, the
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
                                                 refine_metric, mode)
            paths = [dispatch.refine_backend(backend, self.codes)]
            if refine_k > 0:
                paths.append(dispatch.refine_path(backend, refine_store.vectors))
            if graphs.engages(queries, paths):
                return self._graphs.run(
                    root, self._graph_parts(k, nprobe, refine_k, refine_store, refine_metric,
                                            mode), queries, chain)
            return graphs.eager(root, chain, queries)

    def _graph_parts(self, k: int, nprobe: int, refine_k: int, refine_store,
                     refine_metric: str, mode: str) -> tuple:
        """What a served call's chain depends on besides its batch and the
        index's own tensors, as ``search_device`` resolved it (``nprobe`` at
        most nlist, ``refine_k`` at least k, ``mode`` the id mode taken):
        its scalars, and the refine store with its tensors."""
        store = ()
        if refine_k > 0:
            st = refine_store
            store = (st, st.vectors, st.scales, st.res_cents, st.res_ids)
        return (k, nprobe, refine_k, refine_metric, mode) + store

    def _search_chain(self, queries: torch.Tensor, k: int, nprobe: int, refine_k: int,
                      refine_store, backend: str, refine_metric: str,
                      mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
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
                                   leads=(self.tile_leads() if cuda and mode == "dma"
                                          and self.replicas > 1 else None))
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


# Rows a build stage moves or computes at a time.
_BUILD_CHUNK = 262_144
# Device memory the build leaves beside the padded corpus: the k-means and
# codebook workspaces and the encode's score slabs (under 8 GB at 1536 dims
# and nlist 8192).
_BUILD_WORKSPACE_BYTES = 12 << 30
# The device memory the padded corpus may take; None: the device's free
# memory (with what torch's allocator holds unused) less the workspace, and
# no limit on a CPU device. Tests set it to 0 to take the host-streamed path.
_DEVICE_BUILD_BYTES: Optional[int] = None


class _Stages:
    """The stages of a build: a line each on stderr (corpus-scale builds)
    and a ``build.*`` span each (``eval/trace.py``; it syncs the device
    before it ends) with the attrs ``rows`` (the rows the stage took),
    ``where`` (``device`` or ``host``: where the padded corpus lives) and
    ``h2d_bytes`` / ``d2h_bytes`` (what the stage copied between the two).
    The padded corpus (``home``) lives on the device where its bytes fit
    ``_DEVICE_BUILD_BYTES``; else on the host, from which each stage streams
    it through the device in chunks."""

    def __init__(self, n: int, dp: int, device: torch.device):
        self._cuda = device.type == "cuda"
        self.release()
        budget = _DEVICE_BUILD_BYTES
        if budget is None and self._cuda:
            free, _ = torch.cuda.mem_get_info(device)
            unused = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
            budget = free + unused - _BUILD_WORKSPACE_BYTES
        self.on_device = budget is None or n * dp * 4 <= budget
        self.home = device if self.on_device else torch.device("cpu")
        self.where = "device" if self.on_device else "host"
        self.log = _stage_logger(n)
        self._crosses = self.home.type != device.type
        self._sync = torch.cuda.synchronize if self._cuda else None

    def moved(self, nbytes: int) -> int:
        """``nbytes`` where the corpus crosses between host and device, else 0."""
        return nbytes if self._crosses else 0

    def __call__(self, name: str, rows: int, h2d: int = 0, d2h: int = 0):
        self.log(f"{name} ({rows} rows, corpus on the {self.where})")
        return trace.span(name, sync=self._sync, rows=rows, where=self.where,
                          h2d_bytes=h2d, d2h_bytes=d2h)

    def release(self) -> None:
        """Gives the device memory torch's allocator holds unused back to
        the device, at a build's start and end: left cached, a corpus-sized
        block (a caller's corpus, the build's padded copy) is carved up by
        later small tensors, and one of them still alive pins the whole
        block when a later corpus-sized tensor needs the memory."""
        if self._cuda:
            torch.cuda.empty_cache()

    def upload(self, rows_f32: np.ndarray, dp: int) -> torch.Tensor:
        """The stage ``build.upload``: [N, dp] f32 on ``home``, the rows
        zero-padded, copied in chunks (no padded host copy)."""
        n, d = rows_f32.shape
        with self("build.upload", n, h2d=n * d * 4 if self.home.type == "cuda" else 0):
            out = torch.empty((n, dp), dtype=torch.float32, device=self.home)
            if dp > d:
                out[:, d:].zero_()
            for s in range(0, n, _BUILD_CHUNK):
                out[s:s + _BUILD_CHUNK, :d].copy_(torch.from_numpy(
                    np.ascontiguousarray(rows_f32[s:s + _BUILD_CHUNK], dtype=np.float32)))
        return out


def _chunks(work: torch.Tensor, device: torch.device):
    """Row chunks of ``work`` on ``device`` (views where it lives there)."""
    for s in range(0, work.shape[0], _BUILD_CHUNK):
        yield work[s:s + _BUILD_CHUNK].to(device)


def _rotate_rows(work: torch.Tensor, rot: torch.Tensor, device: torch.device) -> None:
    """``work`` times the rotation, in place, a chunk at a time on ``device``."""
    for s, x in zip(range(0, work.shape[0], _BUILD_CHUNK), _chunks(work, device)):
        work[s:s + _BUILD_CHUNK].copy_(_matmul(x, rot))


def _slot_ids(list_of: torch.Tensor, slot_of: torch.Tensor, nlist: int, lcap: int
              ) -> torch.Tensor:
    """[nlist, lcap] int64: each slot's row (its position in ``list_of``), -1 empty."""
    out = torch.full((nlist, lcap), -1, dtype=torch.int64, device=list_of.device)
    out[list_of, slot_of] = torch.arange(list_of.shape[0], device=list_of.device)
    return out


def _encode_lists(work: torch.Tensor, rows: torch.Tensor, list_of: torch.Tensor,
                  slot_of: torch.Tensor, cents: torch.Tensor, cb: torch.Tensor, nlist: int,
                  lcap: int) -> torch.Tensor:
    """[nlist, M, lcap] uint8 codes: entry j (row ``rows[j]`` of ``work``,
    placed at ``list_of[j]``, ``slot_of[j]``) encoded as its residual
    against its list's centroid, a chunk of entries at a time on the
    codebooks' device."""
    device = cb.device
    m = cb.shape[0]
    codes = torch.zeros((nlist, m, lcap), dtype=torch.uint8, device=device)
    for s in range(0, rows.shape[0], _BUILD_CHUNK):
        e = min(s + _BUILD_CHUNK, rows.shape[0])
        lst = list_of[s:e]
        x = work[rows[s:e].to(work.device)].to(device)
        codes[lst, :, slot_of[s:e]] = pq.encode(x - cents[lst], cb, m)
    return codes
