"""Compute kernels: plain PyTorch ops (the oracle and the CPU path) and the
hand-written CUDA kernels under ``csrc/``, built at first use.

It exports the names of ``nvdb_tpu.kernels`` except ``default_backend``,
which picks a JAX platform and has no torch meaning: the port's
``dispatch`` resolves ``backend="auto"`` per tensor
(``dispatch.refine_backend``)."""

from nvdb_tpu_torch.kernels.ops import scan_topk, merge_topk, exact_rerank  # noqa: F401
from nvdb_tpu_torch.kernels.dispatch import flat_topk  # noqa: F401
