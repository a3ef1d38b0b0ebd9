"""Environment-driven evaluation settings, honoring the reference's variable
names (``WARMUP``, ``EVAL_MODE``, ``GT_PATH``, ``GT_MODE``, ``EXACT_METRIC``)
so run scripts translate 1:1, with the IVF (``IVF_NLIST``, ``IVF_NPROBE``,
``IVF_TRAIN``) and PQ (``PQ_M``, ``USE_OPQ``, ``OPQ_NITER``, ``REFINE_K``)
knobs, the scan backend (``EXACT_MODE``, ``NVDB_FORCE_TORCH`` or its alias
``NVDB_FORCE_JNP``) and the partition index (``HNSW_EF_SEARCH``)."""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    return default if v is None else v not in ("0", "", "false", "False")


@dataclasses.dataclass
class ScanConfig:
    backend: str = "auto"          # auto | cuda | torch  (EXACT_MODE analogue)
    native_threads: int = 0        # 0 = all cores (EXACT_THREADS analogue)
    row_block: int = 1024

    @classmethod
    def from_env(cls) -> "ScanConfig":
        forced = _env_flag("NVDB_FORCE_TORCH", False) or _env_flag("NVDB_FORCE_JNP", False)
        return cls(backend="torch" if forced else os.environ.get("EXACT_MODE", "auto"),
                   native_threads=_env_int("EXACT_THREADS", 0))


@dataclasses.dataclass
class IVFConfig:
    nlist: int = 1024              # IVF_NLIST
    nprobe: int = 32               # IVF_NPROBE
    train_size: int = 50_000       # IVF_TRAIN
    n_iters: int = 10
    pad_factor: float = 1.5
    dtype: str = "f32"

    @classmethod
    def from_env(cls) -> "IVFConfig":
        return cls(nlist=_env_int("IVF_NLIST", 1024),
                   nprobe=_env_int("IVF_NPROBE", 32),
                   train_size=_env_int("IVF_TRAIN", 50_000))


@dataclasses.dataclass
class PQConfig:
    m: int = 48                    # PQ_M (PQ_BITS fixed at 8)
    use_opq: bool = True           # USE_OPQ
    opq_iters: int = 4             # OPQ_NITER
    refine_k: int = 0              # REFINE_K

    @classmethod
    def from_env(cls) -> "PQConfig":
        return cls(m=_env_int("PQ_M", 48),
                   use_opq=_env_flag("USE_OPQ", True),
                   opq_iters=_env_int("OPQ_NITER", 4),
                   refine_k=_env_int("REFINE_K", 0))


@dataclasses.dataclass
class PartitionConfig:
    nlist: int | None = None       # None = sqrt-auto (HNSW_M analogue knob)
    nprobe: int = 64               # HNSW_EF_SEARCH analogue
    rerank_k: int = 0
    dtype: str = "bf16"

    @classmethod
    def from_env(cls) -> "PartitionConfig":
        return cls(nprobe=_env_int("HNSW_EF_SEARCH", 64))


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
