"""The port's row-sharded flat path against the JAX package's on the same
inputs: meshes, the padded and row-sharded store, ``sharded_flat_topk``
(f32 / bf16 / int8, a ragged row count, shards of padding alone, the 4 x 2
rows-by-q mesh), ``ShardedFlatIndex``, ``sharded_lloyd_step``, the dry run
and ``tools.bench --shards``. The port runs on a mesh of CPU shards
(``[torch.device("cpu")] * S``) through its kernels' plain versions; JAX on
the 8 virtual CPU devices of ``tests/conftest.py``, backend ``jnp`` as its
own tests run it.

Tolerances: values within 1e-5 of JAX's (atol and rtol, as
``test_torch_flat.py``); ids judged by float64 regret <= 1e-5 against the
effective inputs (the port prefers the larger id at a tie, JAX's
``lax.top_k`` the lower shard); centroids within 1e-4 of JAX's and the
objective within 1e-5 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nvdb_tpu.dist import mesh as jmeshmod
from nvdb_tpu.dist.sharded import ShardedFlatIndex as JShardedFlatIndex
from nvdb_tpu.dist.sharded import sharded_flat_topk as j_sharded_flat_topk
from nvdb_tpu.dist.sharded import sharded_lloyd_step as j_sharded_lloyd_step
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.store import VectorStore as JVectorStore
from nvdb_tpu_torch.dist import mesh as meshmod
from nvdb_tpu_torch.dist.dryrun import dryrun_multichip
from nvdb_tpu_torch.dist.sharded import (ShardedFlatIndex, sharded_flat_topk,
                                         sharded_lloyd_step)
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index.flat import FlatIndex
from nvdb_tpu_torch.store import ShardedVectorStore, VectorStore

CPU = torch.device("cpu")
N, D, B, K, RB = 4000, 64, 16, 10, 128
TOL = 1e-5


def cpu_mesh(rows, n_q=1):
    return meshmod.row_mesh(rows, n_q=n_q, devices=[CPU] * (rows * n_q))


@pytest.fixture(scope="module")
def data():
    base = jsynth.clustered(N, D, n_clusters=16, seed=31)
    queries, _ = jsynth.sample_queries(base, B, seed=32, perturb=0.05)
    return base, queries


def _encode(base, dtype):
    """(rows in the store encoding, scales): the same host input for both packages."""
    if dtype == "i8":
        return vecbin.quantize_i8(base)
    return base, None


def _effective(rows, scales, dtype):
    """float64 rows as the scan scores them (the dequantized int8 store; bf16 rounded)."""
    if dtype == "i8":
        return rows.astype(np.float64) * scales[:, None]
    if dtype == "bf16":
        return vecbin.bf16_to_f32(vecbin.to_bf16(rows)).astype(np.float64)
    return rows.astype(np.float64)


def _eff_queries(queries, dtype):
    if dtype == "f32":
        return queries.astype(np.float64)
    return vecbin.bf16_to_f32(vecbin.to_bf16(queries)).astype(np.float64)


def _regret(q64, rows64, ids, k):
    s = q64 @ rows64.T
    ref = -np.sort(-s, axis=1)[:, :k]
    got = -np.sort(-np.take_along_axis(s, np.asarray(ids, np.int64), axis=1), axis=1)
    return float(np.max(ref - got))


def _jax_store(rows, scales, dtype, n_shards, mesh):
    return JVectorStore.from_numpy(rows, dtype, scales=scales, row_block=RB,
                                   sharding=jmeshmod.row_sharding(mesh), n_shards=n_shards)


def test_row_mesh_shape_and_devices():
    m = cpu_mesh(4, n_q=2)
    assert m.shape == {meshmod.ROWS: 4, meshmod.QUERIES: 2}
    assert m.first == CPU and list(m.local_rows) == [0, 1, 2, 3]
    assert m.row_device(3) == CPU and m.backend is None
    assert cpu_mesh(8).shape == jmeshmod.row_mesh(8).shape


def test_row_mesh_fails_by_name(monkeypatch):
    with pytest.raises(ValueError, match="needs 4 devices; 3 devices given"):
        meshmod.row_mesh(4, devices=[CPU] * 3)
    # never the CPU in place of missing cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 devices; 1 CUDA devices visible"):
        meshmod.row_mesh(4)


def test_shard_rows_views_and_replicate():
    t = torch.arange(48, dtype=torch.float32).reshape(12, 4)
    m = cpu_mesh(3)
    parts = meshmod.shard_rows(t, m)
    assert [p.data_ptr() for p in parts] == [t[4 * i:].data_ptr() for i in range(3)]
    assert torch.equal(torch.cat(parts), t)
    assert all(r is t for r in meshmod.replicate(t, m))
    with pytest.raises(ValueError, match="equal shards"):
        meshmod.shard_rows(t, cpu_mesh(5))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_store_padding_matches_jax(data, dtype, n_shards):
    base, _ = data
    rows, sc = _encode(base, dtype)
    ours = VectorStore.from_numpy(rows, dtype, scales=sc, row_block=RB, n_shards=n_shards,
                                  device=CPU)
    theirs = JVectorStore.from_numpy(rows, dtype, scales=sc, row_block=RB, n_shards=n_shards)
    assert ours.n_padded == theirs.n_padded and ours.n_padded % (RB * n_shards) == 0
    if dtype == "bf16":
        got = ours.vectors.view(torch.int16).numpy()
        want = np.asarray(theirs.vectors).view(np.int16)
    else:
        got, want = ours.vectors.numpy(), np.asarray(theirs.vectors)
    np.testing.assert_array_equal(got, want)
    if sc is not None:
        np.testing.assert_array_equal(ours.scales.numpy(), np.asarray(theirs.scales))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_sharded_vecbin_rows_tile_the_file(data, tmp_path, dtype):
    """Each shard reads only its row range; together they are the whole
    padded store, bit for bit, with every valid row counted once."""
    base, _ = data
    rows, sc = _encode(base, dtype)
    path = str(tmp_path / "b.vecbin")
    if dtype == "bf16":
        vecbin.write_vecbin(path, vecbin.to_bf16(rows))
    else:
        vecbin.write_vecbin(path, rows, scales=sc)
    m = cpu_mesh(8)
    sh = ShardedVectorStore.from_vecbin(path, m, row_block=RB)
    whole = VectorStore.from_vecbin(path, RB, n_shards=8, device=CPU)
    assert sh.n == N and sh.n_padded == whole.n_padded
    assert sum(s.n for s in sh.shards) == N and sh.shards[-1].n < sh.rows_per_shard
    assert torch.equal(torch.cat(sh.vectors), whole.vectors)
    if sc is not None:
        assert torch.equal(torch.cat(sh.scales), whole.scales)


def test_from_store_makes_views(data):
    base, _ = data
    store = VectorStore.from_numpy(base, "f32", row_block=RB, n_shards=4, device=CPU)
    sh = ShardedVectorStore.from_store(store, cpu_mesh(4))
    rps = store.n_padded // 4
    assert [v.data_ptr() for v in sh.vectors] == [store.vectors[s * rps:].data_ptr()
                                                  for s in range(4)]
    assert [s.n for s in sh.shards] == [min(max(N - s * rps, 0), rps) for s in range(4)]
    with pytest.raises(ValueError, match="n_shards=3"):
        ShardedVectorStore.from_store(store, cpu_mesh(3))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("n", [N, 300])   # ragged; 300 rows leave shards 3-7 all padding
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_sharded_flat_topk_matches_jax(data, dtype, n, backend):
    base, queries = data
    rows, sc = _encode(base[:n], dtype)
    mesh = cpu_mesh(8)
    store = ShardedVectorStore.from_numpy(rows, mesh, dtype, scales=sc, row_block=RB)
    if n == 300:
        assert [s.n for s in store.shards][3:] == [0] * 5
    qp = torch.from_numpy(store.pad_queries(queries))
    v, i = sharded_flat_topk(mesh, qp, store.vectors, store.scales, store.n, K,
                             backend=backend)
    jmesh = jmeshmod.row_mesh(8)
    js = _jax_store(rows, sc, dtype, 8, jmesh)
    jv, _ = j_sharded_flat_topk(jmesh, jnp.asarray(qp.numpy()), js.vectors, js.scales,
                                js.n, K, backend="jnp")
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    ids = i.numpy()
    assert ((ids >= 0) & (ids < n)).all()
    assert _regret(_eff_queries(queries, dtype), _effective(rows, sc, dtype), ids, K) <= TOL


def test_query_sharded_axis_matches_jax(data):
    """The 4 x 2 rows-by-q mesh: the batch split over q."""
    base, queries = data
    mesh = cpu_mesh(4, n_q=2)
    store = ShardedVectorStore.from_numpy(base, mesh, "f32", row_block=RB)
    qp = store.pad_queries(queries)
    v, i = sharded_flat_topk(mesh, torch.from_numpy(qp), store.vectors, None, store.n, K,
                             shard_queries=True)
    jmesh = jmeshmod.row_mesh(4, n_q=2)
    js = JVectorStore.from_numpy(base, "f32", row_block=RB, n_shards=4,
                                 sharding=jax.NamedSharding(jmesh, jax.P(jmeshmod.ROWS, None)))
    jv, _ = j_sharded_flat_topk(jmesh, jnp.asarray(qp), js.vectors, None, js.n, K,
                                backend="jnp", shard_queries=True)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    assert _regret(queries.astype(np.float64), base.astype(np.float64), i.numpy(), K) <= TOL


@pytest.mark.parametrize("dtype", ["f32", "i8"])
def test_sharded_flat_index_matches_jax_and_single(data, dtype):
    base, queries = data
    rows, sc = _encode(base, dtype)
    mesh = cpu_mesh(8)
    sv, si = ShardedFlatIndex(ShardedVectorStore.from_numpy(rows, mesh, dtype, scales=sc,
                                                            row_block=RB)).search(queries, K)
    fv, _ = FlatIndex(VectorStore.from_numpy(rows, dtype, scales=sc, row_block=RB,
                                             device=CPU)).search(queries, K)
    jmesh = jmeshmod.row_mesh(8)
    jv, _ = JShardedFlatIndex(_jax_store(rows, sc, dtype, 8, jmesh), mesh=jmesh,
                              backend="jnp").search(queries, K)
    np.testing.assert_allclose(sv, jv, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(sv, fv, atol=TOL, rtol=TOL)
    assert _regret(_eff_queries(queries, dtype), _effective(rows, sc, dtype), si, K) <= TOL


@pytest.mark.parametrize("n", [N, 4096])   # with padding rows; none (4096 = 8 x 512)
def test_sharded_lloyd_step_matches_jax(data, n):
    base = np.concatenate([data[0], data[0][:96]])[:n]
    mesh = cpu_mesh(8)
    store = ShardedVectorStore.from_numpy(base, mesh, "f32", row_block=RB)
    cents0 = store.pad_queries(base[:16])
    new, obj = sharded_lloyd_step(mesh, store.vectors, torch.from_numpy(cents0), store.n)

    jmesh = jmeshmod.row_mesh(8)
    js = _jax_store(base, None, "f32", 8, jmesh)
    jnew, jobj = j_sharded_lloyd_step(jmesh, js.vectors, jnp.asarray(cents0), js.n)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=1e-4, rtol=0)
    # JAX keeps each padding row's squared distance to its nearest centroid
    # (a zero row: the smallest ||c||^2) in its objective; the port does not
    n_pad = store.n_padded - n
    c2 = np.sum(cents0.astype(np.float64) ** 2, axis=1)
    want = float(jobj) - n_pad * float(c2.min()) / n
    assert abs(float(obj) - want) <= 1e-5 * abs(want)
    assert (n_pad == 0) == (n == 4096)


def test_dryrun_multichip_on_cpu_shards():
    out = dryrun_multichip(8, devices=[CPU] * 8)
    assert out["mesh"] == {meshmod.ROWS: 4, meshmod.QUERIES: 2}
    assert out["search"] == (16, 5) and out["ivfpq"] == (16, 5)
    assert out["ivfpq_mesh"][meshmod.ROWS] == 8 and np.isfinite(out["obj"])


def test_dryrun_without_cards_fails_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="CUDA devices visible"):
        dryrun_multichip(4)


@pytest.fixture(scope="module")
def bench_files(data, tmp_path_factory):
    from nvdb_tpu.formats import gtbin as jgtbin
    from nvdb_tpu.formats import vecbin as jvecbin

    base, queries = data
    d = tmp_path_factory.mktemp("dist_bench")
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    paths = {"base": str(d / "b.vecbin"), "q": str(d / "q.vecbin"), "gt": str(d / "gt.gtbin")}
    jvecbin.write_vecbin(paths["base"], base)
    jvecbin.write_vecbin(paths["q"], queries)
    jgtbin.write_gtbin(paths["gt"], np.argsort(-s64, axis=1, kind="stable")[:, :K],
                       dim=D, N=N)
    return paths


@pytest.mark.parametrize("shards", [2, 8])
def test_bench_shards_result_keys_and_recall_match_jax(bench_files, capsys, shards):
    """``bench --shards`` on CPU shards: the JAX tool's RESULT keys (the
    port's add the device) and its recall."""
    from nvdb_tpu.tools import bench as jbench
    from nvdb_tpu_torch.tools import bench

    args = [bench_files["base"], bench_files["q"], str(K), "--gt", bench_files["gt"],
            "--batch-q", "8", "--shards", str(shards), "--warmup", "1"]
    got = bench.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    jbench.main(args + ["--cpu", "--backend", "jnp"])
    jout = capsys.readouterr().out
    ours = [line for line in out.splitlines() if line.startswith("RESULT ")]
    theirs = [line for line in jout.splitlines() if line.startswith("RESULT ")]
    keys = lambda line: {kv.split("=", 1)[0] for kv in line.split()[1:]}
    assert len(ours) == len(theirs) == 1
    assert keys(ours[0]) - {"device"} == keys(theirs[0])
    assert f"shards={shards}" in ours[0] and "device=cpu" in ours[0]
    assert got == float(jout.split("recall@10=")[1].split()[0]) == 1.0
