"""Backend dispatch for the flat-scan top-k (the port of
``nvdb_tpu.kernels.dispatch.flat_topk``).

``backend="auto"`` sends CUDA tensors to the CUDA kernel and CPU tensors to
the plain PyTorch ops; ``"torch"`` forces the plain ops on any device (the
A/B switch, as ``NVDB_FORCE_JNP`` is for the JAX package); ``"cuda"`` calls
the kernel's wrapper, which launches the kernel on a CUDA tensor or raises.
The kernel takes any batch size, so the TPU-tuned 512-query split of the JAX
dispatch is not carried over."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nvdb_tpu_torch.kernels import flat_scan, ops

BACKENDS = ("auto", "cuda", "torch")


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
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if metric == "l2" or backend == "torch" or (backend == "auto" and not vectors.is_cuda):
        return ops.scan_topk(queries, vectors, scales, n_valid, k,
                             row_block=row_block, query_scales=query_scales,
                             metric=metric)
    if metric != "dot":
        raise ValueError(f"unknown metric {metric!r}")
    return flat_scan.flat_topk_cuda(queries, vectors, scales, n_valid, k,
                                    query_scales=query_scales)
