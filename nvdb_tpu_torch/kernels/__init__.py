"""Compute kernels: plain PyTorch ops (the oracle and the CPU path) and the
hand-written CUDA kernels under ``csrc/``, built at first use."""

from nvdb_tpu_torch.kernels.ops import scan_topk, merge_topk  # noqa: F401
from nvdb_tpu_torch.kernels.dispatch import flat_topk  # noqa: F401
