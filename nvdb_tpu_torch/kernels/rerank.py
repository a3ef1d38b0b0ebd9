"""Exact rerank top-k: the wrapper of the CUDA kernel ``csrc/rerank_topk.cu``
(the port of ``nvdb_tpu.kernels.rerank.pallas_rerank``) and its plain
PyTorch version.

Both fold the metric, the int8 row scale and the cached row norms into two
per-candidate coefficients, score = amul * dot(q, raw_row) - boff (the fold
of ``rerank.py:245-281``): the plain version with ``fold_coefficients``,
the kernel itself from ``scales`` / ``norms2`` / ``qcent`` and a metric
flag, with the same products in the same order. Residual-int8 stores (row =
cent + s * codes, ``VectorStore.attach_residual``) fold into the same form
through q.cent, one [B, nlist] product gathered per candidate
(``residual_qcent``, plain torch on both paths).

``rerank_topk_cuda`` launches the kernel on a CUDA tensor and raises on any
other. With ``norms2`` given (or metric dot) and no residual store, that one
launch is all the device work of a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.kernels import ops
from nvdb_tpu_torch.kernels.flat_scan import check_tensor, require_cuda

MAX_K = 128
# the kernel keeps the query, the R scores and ids and the top-k list in
# shared memory; this bounds R at the store widths the repo uses
_SMEM_LIMIT = 200 * 1024

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Launches of the kernel since the last reset. Only rerank_topk_cuda's launch
# adds to it, and ``index/graphs.py`` keeps it to the kernels that ran: a
# served chain's capture adds nothing, each replay adds its launches.
LAUNCHES = 0
# rows a block of store_norms2 takes
_NORM_ROWS = 1 << 18


def store_norms2(vectors: torch.Tensor) -> torch.Tensor:
    """[Np] f32 squared row norms of the raw store payload (int8: norms of
    the integer codes; the row scale enters at score time as s^2 ||r||^2).
    Cache it per store (``VectorStore.norms2``). A block of rows at a time,
    so no store-sized temporary is made."""
    out = torch.empty(vectors.shape[0], dtype=torch.float32, device=vectors.device)
    for s in range(0, vectors.shape[0], _NORM_ROWS):
        v = vectors[s:s + _NORM_ROWS].to(torch.float32)
        out[s:s + _NORM_ROWS] = torch.sum(v * v, dim=1)
    return out


def residual_qcent(
    queries: torch.Tensor,            # [B, Dp] f32
    cand_ids: torch.Tensor,           # [B, R] int32 (-1 padded)
    res_cents: torch.Tensor,          # [nlist, Dp] f32
    res_ids: torch.Tensor,            # [Np] int32 list of each row
) -> torch.Tensor:
    """[B, R] f32 q.cent of each candidate's centroid (full f32, TF32 off)."""
    ops.no_tf32()
    qc = queries.to(torch.float32) @ res_cents.T                    # [B, nlist]
    rid = res_ids[torch.clamp(cand_ids, min=0).long()].long()       # [B, R]
    return torch.gather(qc, 1, rid)


def fold_coefficients(
    cand_ids: torch.Tensor,           # [B, R] int32 (-1 padded)
    scales: Optional[torch.Tensor],   # [Np] f32 (int8 stores)
    norms2: Optional[torch.Tensor],   # [Np] f32 (metric l2)
    metric: str,
    qcent: Optional[torch.Tensor] = None,  # [B, R] f32 (residual stores)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-candidate (amul, boff), [B, R] f32, with score = amul * dot - boff:
    dot: amul = s, boff = 0; l2 (2 q.row - ||row||^2): amul = 2 s,
    boff = s^2 ||codes||^2 (s = 1 for f32 / bf16 stores). Residual stores
    (row = cent + s codes, ``norms2`` the dequantized norms): dot: amul = s,
    boff = -q.cent; l2: amul = 2 s, boff = ||row||^2 - 2 q.cent."""
    safe = torch.clamp(cand_ids, min=0).long()
    sc = scales[safe] if scales is not None else None
    if metric == "dot":
        amul = sc if sc is not None else torch.ones(cand_ids.shape, device=cand_ids.device)
        if qcent is not None:
            return amul.contiguous(), (-qcent).contiguous()
        return amul.contiguous(), torch.zeros(cand_ids.shape, device=cand_ids.device)
    if metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    if norms2 is None:
        raise ValueError("metric='l2' needs the store's norms2")
    n2 = norms2[safe]
    if qcent is not None:
        return (2.0 * sc).contiguous(), (n2 - 2.0 * qcent).contiguous()
    if sc is not None:
        return (2.0 * sc).contiguous(), (sc * sc * n2).contiguous()
    return torch.full(cand_ids.shape, 2.0, device=cand_ids.device), n2.contiguous()


def _fold_inputs(queries, cand_ids, vectors, scales, norms2, metric, res_cents,
                 res_ids) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(norms2, qcent) as the fold takes them, with the residual checks of
    ``pallas_rerank`` (``rerank.py:237-243``): the store's norms where
    metric l2 was given none, q.cent per candidate for a residual store."""
    if metric not in ("l2", "dot"):
        raise ValueError(f"unknown metric {metric!r}")
    if res_cents is not None and (scales is None or res_ids is None):
        raise ValueError("residual stores need scales and res_ids")
    if metric == "l2" and norms2 is None:
        if res_cents is not None:
            raise ValueError("residual + metric='l2' requires the store's "
                             "DEQUANTIZED norms2 (VectorStore.norms2())")
        norms2 = store_norms2(vectors)
    qcent = (residual_qcent(queries, cand_ids, res_cents, res_ids)
             if res_cents is not None else None)
    return (norms2 if metric == "l2" else None), qcent


def rerank_topk_reference(
    queries: torch.Tensor,            # [B, Dp] f32
    cand_ids: torch.Tensor,           # [B, R] int32 (-1 padded)
    vectors: torch.Tensor,            # [Np, Dp] f32 | bf16 | int8
    scales: Optional[torch.Tensor],   # [Np] f32 (int8 stores)
    k: int,
    norms2: Optional[torch.Tensor] = None,
    metric: str = "l2",
    res_cents: Optional[torch.Tensor] = None,  # [nlist, Dp] f32 (residual stores)
    res_ids: Optional[torch.Tensor] = None,    # [Np] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: the same fold, the rows
    gathered and widened to f32, full-f32 dots (TF32 off), ids outside
    [0, Np) never ranked, a repeated id taken once, (score desc, id desc)."""
    norms2, qcent = _fold_inputs(queries, cand_ids, vectors, scales, norms2, metric,
                                 res_cents, res_ids)
    amul, boff = fold_coefficients(cand_ids, scales, norms2, metric, qcent)
    valid = (cand_ids >= 0) & (cand_ids < vectors.shape[0])
    safe = torch.where(valid, cand_ids, 0).long()
    ops.no_tf32()
    rows = vectors[safe].to(torch.float32)                          # [B, R, Dp]
    dots = torch.einsum("bd,brd->br", queries.to(torch.float32), rows)
    scores = torch.where(valid, amul * dots - boff, ops.NEG_INF)
    return ops.dedup_topk(scores, torch.where(valid, cand_ids, -1).to(torch.int32), k)


@functools.cache
def _lib():
    """The kernel's C entry point, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    fn = _build.load("rerank_topk").nvdb_rerank_topk
    # 8 pointers, B, R, Dp, n_rows, k, mode, l2, stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rerank_topk_cuda(
    queries: torch.Tensor,            # [B, Dp] f32
    cand_ids: torch.Tensor,           # [B, R] int32 (-1 padded)
    vectors: torch.Tensor,            # [Np, Dp] f32 | bf16 | int8
    scales: Optional[torch.Tensor],   # [Np] f32 (int8 stores)
    k: int,
    norms2: Optional[torch.Tensor] = None,  # [Np] f32 (VectorStore.norms2)
    metric: str = "l2",
    res_cents: Optional[torch.Tensor] = None,  # [nlist, Dp] f32 (residual stores)
    res_ids: Optional[torch.Tensor] = None,    # [Np] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over each query's candidate rows; the contract of
    ``rerank_topk_reference``. Returns (vals [B, k] f32, ids [B, k] int32).
    Pass ``norms2`` in serving loops: without it, metric l2 reads the whole
    store once per call. No host sync: the launches (the residual fold's
    too) can be captured in a CUDA graph."""
    global LAUNCHES
    with trace.span("rerank_topk_cuda") as sp:
        require_cuda(vectors, "rerank_topk")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k={k} outside [1, {MAX_K}]")
        if vectors.dim() != 2 or queries.dim() != 2 or cand_ids.dim() != 2:
            raise ValueError("queries, cand_ids and vectors must be 2-D")
        dev = vectors.device
        Np, Dp = vectors.shape
        B, R = cand_ids.shape
        if Dp % 16 != 0:
            raise ValueError(f"padded dim {Dp} is not a multiple of 16 (16-byte loads)")
        check_tensor(vectors, "vectors", dev, tuple(_MODES), (Np, Dp))
        check_tensor(queries, "queries", dev, (torch.float32,), (B, Dp))
        check_tensor(cand_ids, "cand_ids", dev, (torch.int32,), (B, R))
        if (vectors.dtype == torch.int8) != (scales is not None):
            raise ValueError("per-row scales go with int8 stores, and only with them")
        if scales is not None:
            check_tensor(scales, "scales", dev, (torch.float32,), (Np,))
        if R < 1:
            raise ValueError("no candidates")
        if Dp * 4 + R * 8 + k * 8 > _SMEM_LIMIT:
            raise ValueError(f"R={R} candidates of dim {Dp} exceed the kernel's "
                             f"shared memory")
        norms2_in = norms2
        norms2, qcent = _fold_inputs(queries, cand_ids, vectors, scales, norms2, metric,
                                     res_cents, res_ids)
        if norms2 is not None:
            check_tensor(norms2, "norms2", dev, (torch.float32,), (Np,))
        if qcent is not None:
            qcent = qcent.contiguous()
            check_tensor(qcent, "qcent", dev, (torch.float32,), (B, R))

        vals = torch.empty((B, k), dtype=torch.float32, device=dev)
        ids = torch.empty((B, k), dtype=torch.int32, device=dev)
        if sp:
            sp.count_alloc(vals, ids, qcent, None if norms2 is norms2_in else norms2)
        if B == 0:
            return vals, ids
        fn = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            ptr = lambda t: None if t is None else t.data_ptr()
            with trace.span("launch"):
                rc = fn(queries.data_ptr(), cand_ids.data_ptr(), vectors.data_ptr(),
                        ptr(scales), ptr(norms2), ptr(qcent), vals.data_ptr(), ids.data_ptr(),
                        B, R, Dp, Np, k, _MODES[vectors.dtype], int(metric == "l2"), stream)
        if rc != 0:
            raise RuntimeError(f"rerank_topk kernel launch failed: cudaError_t {rc}")
        LAUNCHES += 1
        return vals, ids
