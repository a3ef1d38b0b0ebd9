"""Environment-driven evaluation settings, honoring the reference's variable
names (``WARMUP``, ``EVAL_MODE``, ``GT_PATH``, ``GT_MODE``, ``EXACT_METRIC``)
so run scripts translate 1:1. The scan, IVF, PQ and partition configs of
``nvdb_tpu.config`` arrive with the slices that use them."""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


@dataclasses.dataclass
class EvalConfig:
    warmup: int = 2                # WARMUP
    batch_q: int = 1
    k: int = 10
    ann_only: bool = False         # EVAL_MODE=ann_only
    gt_path: str | None = None     # GT_PATH
    gt_host: bool = False          # GT_MODE analogue: native host GT builder
    exact_metric: str = "dot"      # EXACT_METRIC=DOT|L2 (nvdb_ivf_eval.cpp:353)

    @classmethod
    def from_env(cls) -> "EvalConfig":
        return cls(warmup=_env_int("WARMUP", 2),
                   ann_only=os.environ.get("EVAL_MODE") == "ann_only",
                   gt_path=os.environ.get("GT_PATH"),
                   gt_host=os.environ.get("GT_MODE") == "host",
                   exact_metric=os.environ.get("EXACT_METRIC", "dot").lower())
