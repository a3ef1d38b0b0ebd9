"""The port's environment switches against the JAX package's: the config
classes read the same variable names (tests/test_trace_config.py's cases),
and ``NVDB_FORCE_TORCH=1``, or the JAX package's ``NVDB_FORCE_JNP=1``, makes
``backend="auto"`` resolve to the kernels' plain versions everywhere."""

import numpy as np
import pytest
import torch

from nvdb_tpu import config as jconfig
from nvdb_tpu_torch import config
from nvdb_tpu_torch.kernels import adc_scan, dispatch, ops

_VARS = ("IVF_NLIST", "IVF_NPROBE", "PQ_M", "USE_OPQ", "REFINE_K", "WARMUP", "EVAL_MODE",
         "NVDB_FORCE_JNP", "NVDB_FORCE_TORCH", "EXACT_MODE", "HNSW_EF_SEARCH")


@pytest.fixture
def clean_env(monkeypatch):
    for name in _VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_config_from_env(clean_env):
    for name, value in (("IVF_NLIST", "4096"), ("IVF_NPROBE", "64"), ("PQ_M", "64"),
                        ("USE_OPQ", "0"), ("REFINE_K", "50"), ("WARMUP", "5"),
                        ("EVAL_MODE", "ann_only"), ("HNSW_EF_SEARCH", "96"),
                        ("EXACT_MODE", "cuda")):
        clean_env.setenv(name, value)
    assert config.IVFConfig.from_env().nlist == 4096
    assert config.IVFConfig.from_env().nprobe == 64
    pqc = config.PQConfig.from_env()
    assert pqc.m == 64 and not pqc.use_opq and pqc.refine_k == 50
    ev = config.EvalConfig.from_env()
    assert ev.warmup == 5 and ev.ann_only
    assert config.PartitionConfig.from_env().nprobe == 96
    assert config.ScanConfig.from_env().backend == "cuda"


def test_config_defaults(clean_env):
    assert config.IVFConfig.from_env().nlist == 1024
    assert config.PQConfig.from_env().m == 48
    assert config.ScanConfig.from_env().backend == "auto"
    for ours, theirs in ((config.ScanConfig, jconfig.ScanConfig),
                         (config.PartitionConfig, jconfig.PartitionConfig)):
        mine = {f: getattr(ours(), f) for f in ours.__dataclass_fields__}
        ref = {f: getattr(theirs(), f) for f in theirs.__dataclass_fields__}
        assert mine == ref


@pytest.mark.parametrize("name", ["NVDB_FORCE_TORCH", "NVDB_FORCE_JNP"])
def test_force_torch_resolves_auto(clean_env, name):
    """Under the switch ``auto`` is the plain path on any device: the
    config's backend, ``refine_backend``, and the IVF-PQ search, which then
    runs the key mode's plain version (the JAX package's jnp path does not
    have it) for refine candidates."""
    t = torch.zeros(2)
    assert dispatch.refine_backend("auto", t) == "oracle"
    clean_env.setenv(name, "1")
    assert config.ScanConfig.from_env().backend == "torch"
    assert dispatch.refine_backend("auto", t) == "torch"
    assert dispatch.refine_backend("cuda", t) == "cuda"        # an explicit backend stands
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 128)).astype(np.float32))
    rows = torch.from_numpy(np.random.default_rng(2).standard_normal((300, 128))
                            .astype(np.float32))
    got = dispatch.flat_topk(q, rows, None, 300, 5)
    want = ops.scan_topk(q, rows, None, 300, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    clean_env.setenv(name, "0")
    assert dispatch.refine_backend("auto", t) == "oracle"


def test_force_torch_search_takes_the_plain_key_path(clean_env):
    from nvdb_tpu.formats import synth as jsynth
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.store import VectorStore

    base = jsynth.clustered(1500, 64, n_clusters=8, seed=3)
    idx = IVFPQIndex.build(base, nlist=4, m=16, use_opq=False, train_size=1500, seed=0,
                           device="cpu")
    store = VectorStore.from_numpy(base, device="cpu")
    q = torch.zeros((2, 128))
    q[:, :64] = torch.from_numpy(base[:2])
    calls = []
    real = adc_scan.adc_topk_keys_reference
    clean_env.setattr(adc_scan, "adc_topk_keys_reference",
                      lambda *a, **kw: calls.append(1) or real(*a, **kw))
    idx.search_device(q, 5, 2, refine_k=20, refine_store=store)
    assert calls == []
    clean_env.setenv("NVDB_FORCE_TORCH", "1")
    v, i = idx.search_device(q, 5, 2, refine_k=20, refine_store=store)
    assert calls == [1]
    assert i[:, 0].tolist() == [0, 1]
