"""Backend dispatch for the flat-scan top-k, the exact refine and the IVF
probe top-k (the port of ``nvdb_tpu.kernels.dispatch``).

``backend="auto"`` sends CUDA tensors to the CUDA kernel and CPU tensors to
the plain PyTorch ops; ``"torch"`` forces the plain ops on any device (the
A/B switch); ``"cuda"`` calls the kernel's wrapper, which launches the
kernel on a CUDA tensor or raises. ``NVDB_FORCE_TORCH=1`` (or the JAX
package's name for it, ``NVDB_FORCE_JNP=1``) makes ``auto`` resolve to
``torch`` everywhere: ``refine_backend`` is the one place that resolves it.
The kernel takes any batch size, so the TPU-tuned 512-query split of the JAX
dispatch is not carried over, nor is the refine crossover ``B*R <= 3200``,
which is about TPU block DMAs: on a CUDA tensor the refine takes its kernel
at every size."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.kernels import flat_scan, ivf_scan, ops, rerank

BACKENDS = ("auto", "cuda", "torch")
FORCE_ENV = ("NVDB_FORCE_TORCH", "NVDB_FORCE_JNP")


def forced_torch() -> bool:
    """Whether ``NVDB_FORCE_TORCH=1`` or its alias ``NVDB_FORCE_JNP=1`` is set."""
    return any(os.environ.get(name, "0") == "1" for name in FORCE_ENV)


def flat_topk(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    scales: Optional[torch.Tensor],
    n_valid: int,
    k: int,
    backend: str = "auto",
    row_block: int = 1024,
    query_scales: Optional[torch.Tensor] = None,
    metric: str = "dot",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k scan of ``queries`` against the padded store.

    ``metric="l2"`` ranks by 2 q.r - ||r||^2 and always runs the plain ops,
    as it runs plain jnp in the JAX package: it serves exact ground truth on
    un-normalized corpora, not the serving scan."""
    path = refine_backend(backend, vectors)
    if metric == "l2" or path != "cuda":
        return ops.scan_topk(queries, vectors, scales, n_valid, k,
                             row_block=row_block, query_scales=query_scales,
                             metric=metric)
    if metric != "dot":
        raise ValueError(f"unknown metric {metric!r}")
    return flat_scan.flat_topk_cuda(queries, vectors, scales, n_valid, k,
                                    query_scales=query_scales)


def refine_backend(backend: str, tensor: torch.Tensor) -> str:
    """The path a backend resolves to for ``tensor``, for the refine, the
    IVF-PQ ADC and the IVF probe alike: ``"cuda"`` (the kernel), ``"torch"``
    (the kernel's plain version) or ``"oracle"`` (the JAX package's jnp
    path, which ``auto`` runs on the CPU: for the refine, gathered rows and
    ``ops.exact_rerank``). Under ``forced_torch()`` ``auto`` is ``"torch"``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        if forced_torch():
            return "torch"
        return "cuda" if tensor.is_cuda else "oracle"
    return backend


def exact_refine(
    queries: torch.Tensor,            # [B, Dp] f32
    cand_ids: torch.Tensor,           # [B, R] int32 (-1 padded)
    vectors: torch.Tensor,            # [Np, Dp] store payload
    scales: Optional[torch.Tensor],   # [Np] f32 | None
    k: int,
    metric: str = "dot",
    norms2: Optional[torch.Tensor] = None,
    backend: str = "auto",
    res_cents: Optional[torch.Tensor] = None,  # residual-int8 store (see rerank)
    res_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank of candidate ids against the full store: the one seam of
    every refine call (the exact-i8 flat mode, the IVF-PQ refine, the
    partition index's rerank). Residual-int8 stores: pass res_cents /
    res_ids, and queries in the space of the store's centroids."""
    rb = refine_backend(backend, vectors)
    cand_ids = cand_ids.to(torch.int32).contiguous()
    res = dict(res_cents=res_cents, res_ids=res_ids)
    if rb == "cuda":
        return rerank.rerank_topk_cuda(queries.contiguous(), cand_ids, vectors, scales,
                                       k, norms2=norms2, metric=metric, **res)
    if rb == "torch":
        return rerank.rerank_topk_reference(queries, cand_ids, vectors, scales, k,
                                            norms2=norms2, metric=metric, **res)
    return oracle_refine(queries, cand_ids, vectors, scales, k, metric=metric, **res)


def oracle_refine(
    queries: torch.Tensor,            # [B, Dp] f32
    cand_ids: torch.Tensor,           # [B, R] int32 (-1 padded)
    vectors: torch.Tensor,            # [Np, Dp] store payload
    scales: Optional[torch.Tensor],   # [Np] f32 | None
    k: int,
    metric: str = "dot",
    res_cents: Optional[torch.Tensor] = None,
    res_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's jnp refine (``_refine_block(backend="jnp")``): the
    candidate rows gathered into a [B, R, Dp] f32 slab, dequantized, and
    ``ops.exact_rerank``. ``exact_refine`` takes it for CPU tensors under
    ``auto``; ``tools.refine_ab`` times it on the card's tensors."""
    safe = torch.clamp(cand_ids, min=0).long()
    rows = vectors[safe].to(torch.float32)
    if scales is not None:
        rows = rows * scales[safe][:, :, None]
    if res_cents is not None:
        rows = rows + res_cents[res_ids[safe].long()]
    return ops.exact_rerank(queries, rows, cand_ids, k, metric=metric)


def ivf_probe_topk(
    queries: torch.Tensor,                # [B, Dp] f32
    probes: torch.Tensor,                 # [B, P] int list ids
    packed: torch.Tensor,                 # [nlist, Lcap, Dp] f32 | bf16 | int8
    slot_ids: torch.Tensor,               # [nlist, Lcap] int32 (-1 padding)
    slot_scales: Optional[torch.Tensor],  # [nlist, Lcap] f32 (int8 slabs)
    k: int,
    backend: str = "auto",
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (kernel path)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over each query's probed list slabs: the seam of the
    IVF-Flat and partition searches. The oracle is the slab part of the JAX
    package's ``_ivf_search_block``: the plain version in one unchunked
    gather of the probed slabs [B, P, Lcap, Dp] and one batched product."""
    path = refine_backend(backend, packed)
    if path == "cuda":
        return ivf_scan.ivf_probe_topk_cuda(queries.contiguous(), probes, packed, slot_ids,
                                            slot_scales, k, fills=fills)
    q_chunk = None if path == "torch" else max(1, queries.shape[0])
    return ivf_scan.ivf_probe_topk_reference(queries, probes, packed, slot_ids, slot_scales,
                                             k, q_chunk=q_chunk)
