"""The port's multi-process scaffolding (``nvdb_tpu_torch.dist.multihost``)
beside the JAX package's: ``init_from_env`` is a no-op without the env
knobs, the backend rule, the global row mesh, ``load_sharded`` reading
disjoint row ranges whose union is the file, and one real two-rank run on
localhost over ``gloo`` (each rank bounded by a 120 s timeout): both ranks
return the same ids, and they match the float64 oracle (score regret <=
1e-5, the ids of ``tests/test_multiprocess.py``'s check)."""

import numpy as np
import pytest
import torch

from nvdb_tpu.dist import multihost as jmultihost
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu_torch.dist import _worker, multihost
from nvdb_tpu_torch.dist import mesh as meshmod
from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.store import VectorStore

CPU = torch.device("cpu")


@pytest.fixture
def no_env(monkeypatch):
    for k in multihost.ENV + ("NVDB_MULTIHOST", "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


def test_init_noop_without_env(no_env):
    assert multihost.init_from_env() is False
    assert multihost.init_from_env() is False   # a second call is harmless
    assert jmultihost.init_from_env() is False
    summary = multihost.process_summary()
    assert summary.startswith("process 0/1") and "backend=none" in summary
    assert "process 0/1" in jmultihost.process_summary()


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.choose_backend(4) == "nccl"
    assert multihost.choose_backend(2) == "nccl"
    assert multihost.choose_backend(8) == "gloo"   # ranks would share a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.choose_backend(1) == "gloo"


def test_global_row_mesh_one_process(no_env, monkeypatch):
    m = multihost.global_row_mesh(devices=[CPU] * 4)
    assert m.shape == {meshmod.ROWS: 4, meshmod.QUERIES: 1} and m.backend is None
    m2 = multihost.global_row_mesh(n_q=2, devices=[CPU] * 8)
    assert m2.shape == {meshmod.ROWS: 4, meshmod.QUERIES: 2}
    assert "local_devices=8 global_devices=8" in multihost.process_summary(m2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="CUDA devices visible"):
        multihost.global_row_mesh()   # no card: no silent CPU mesh


@pytest.mark.parametrize("dtype", ["f32", "i8"])
def test_load_sharded_reads_disjoint_ranges(tmp_path, dtype):
    """Two processes' halves of a 4-row mesh, each loading only its rows:
    disjoint, and together the whole padded file."""
    base = jsynth.clustered(3000, 48, n_clusters=12, seed=7)
    path = str(tmp_path / "base.vecbin")
    if dtype == "i8":
        codes, sc = vecbin.quantize_i8(base)
        vecbin.write_vecbin(path, codes, scales=sc)
    else:
        vecbin.write_vecbin(path, base)
    whole = VectorStore.from_vecbin(path, 64, n_shards=4, device=CPU)
    halves = []
    for rank in range(2):
        m = meshmod.Mesh(((CPU,), (CPU,)), row_offset=2 * rank, n_rows=4)
        halves.append(multihost.load_sharded(path, m, row_block=64))
    rps = halves[0].rows_per_shard
    assert [len(h.shards) for h in halves] == [2, 2] and rps * 4 == whole.n_padded
    assert sum(s.n for h in halves for s in h.shards) == 3000
    assert torch.equal(torch.cat([v for h in halves for v in h.vectors]), whole.vectors)
    if dtype == "i8":
        assert torch.equal(torch.cat([s for h in halves for s in h.scales]), whole.scales)
    store = multihost.load_sharded(path, meshmod.row_mesh(4, devices=[CPU] * 4), row_block=64)
    queries, _ = jsynth.sample_queries(base, 8, seed=9, perturb=0.05)
    _, ids = ShardedFlatIndex(store).search(queries, 10)
    assert ((ids >= 0) & (ids < 3000)).all()


def test_two_rank_gloo_search(tmp_path):
    """Two OS processes, two CPU shards each, joined over gloo on
    localhost: each loads its half of the file, and the sharded search
    all-gathers the partials, so both return the same ids."""
    n, d, k = 4096, 64, 10
    base = jsynth.clustered(n, d, n_clusters=16, seed=3)
    base_path = str(tmp_path / "base.vecbin")
    vecbin.write_vecbin(base_path, base)
    queries, _ = jsynth.sample_queries(base, 8, seed=5, perturb=0.05)
    q_path = str(tmp_path / "q.npy")
    np.save(q_path, queries)
    runs = _worker.run_ranks([base_path, q_path, str(k), str(tmp_path), "--device", "cpu",
                              "--shards-per-rank", "2", "--row-block", "64"],
                             nproc=2, timeout=120)
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {rank}:\n{out}"
        assert f"OK rank={rank}" in out and f"process {rank}/2" in out
        assert "global_devices=4" in out and "backend=gloo" in out
    ids0, ids1 = (np.load(tmp_path / f"ids_{r}.npy") for r in range(2))
    np.testing.assert_array_equal(ids0, ids1)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    ref = -np.sort(-s64, axis=1)[:, :k]
    got = -np.sort(-np.take_along_axis(s64, ids0.astype(np.int64), axis=1), axis=1)
    assert float(np.max(ref - got)) <= 1e-5
