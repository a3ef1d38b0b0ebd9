"""The port's sharded IVF paths against the JAX package's on the same
inputs: list padding, ``ShardedIVFFlatIndex`` (per-shard probes, merged
values, full probing), ``ShardedIVFPQIndex`` (ADC candidates, the refine
with a single-device and a row-sharded store, l2 and dot, int8 and
residual-int8, replicas 2, ``ids_mode``), ``sharded_refine`` alone, and
``ShardedPartitionIndex``; then ``ivf_eval --shards / --force-sharded`` and
``pr_eval --shards`` on CPU shards. JAX-built indexes are carried across
with ``from_reference``. The port runs on meshes of CPU shards
(``[torch.device("cpu")] * 8``), JAX on the 8 virtual CPU devices of
``tests/conftest.py``, backend ``jnp``.

Tolerances: values within 1e-5 of JAX's (atol and rtol; 1e-4 where a
residual store dequantizes, as ``test_torch_residual.py``); ids by float64
regret against the oracle, 1e-5 (1e-4 through PQ candidates, as JAX's own
tests); per-shard probe ids equal to JAX's except where the coarse scores
tie at the last probe."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdb_tpu.dist import mesh as jmeshmod
from nvdb_tpu.dist import sharded_ivf as jsharded_ivf
from nvdb_tpu.formats import gtbin as jgtbin
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex
from nvdb_tpu.index.ivf_flat import _coarse_probes as j_coarse_probes
from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from nvdb_tpu.index.partition import PartitionRerankIndex as JPartition
from nvdb_tpu.store import VectorStore as JVectorStore
from nvdb_tpu_torch.dist import mesh as meshmod
from nvdb_tpu_torch.dist import sharded_ivf
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex, _coarse_probes
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.index.partition import PartitionRerankIndex
from nvdb_tpu_torch.store import ShardedVectorStore, VectorStore
from nvdb_tpu_torch.tools import ivf_eval, pr_eval

CPU = torch.device("cpu")
N, D, DP, B, K, NLIST, RB = 4000, 64, 128, 16, 10, 42, 128   # 42 lists pad to 48
TOL = 1e-5


def cpu_mesh(rows):
    return meshmod.row_mesh(rows, devices=[CPU] * rows)


def _flat_of(j):
    return IVFFlatIndex.from_reference(
        np.asarray(j.centroids), np.asarray(j.packed), np.asarray(j.slot_ids),
        None if j.slot_scales is None else np.asarray(j.slot_scales), j.n, j.d,
        j.dtype_code, device="cpu")


def _pq_of(j):
    return IVFPQIndex.from_reference(
        None if j.rotation is None else np.asarray(j.rotation), np.asarray(j.centroids),
        np.asarray(j.codebooks), np.asarray(j.codes), np.asarray(j.slot_ids), j.n, j.d,
        j.m, replicas=j.replicas, device="cpu")


@pytest.fixture(scope="module")
def world():
    base = jsynth.clustered(N, D, n_clusters=16, seed=31)
    queries, _ = jsynth.sample_queries(base, B, seed=32, perturb=0.05)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    jflat = {dt: JIVFFlatIndex.build(base, nlist=NLIST, dtype=dt, n_iters=6, seed=4)
             for dt in ("f32", "i8")}
    jpq = JIVFPQIndex.build(base, nlist=NLIST, m=16, use_opq=True, train_size=N, seed=4)
    qp = np.zeros((B, DP), np.float32)
    qp[:, :D] = queries
    return dict(base=base, q=queries, qp=qp, s64=s64,
                gt=np.argsort(-s64, axis=1, kind="stable")[:, :K],
                jflat=jflat, flat={dt: _flat_of(j) for dt, j in jflat.items()},
                jpq=jpq, pq=_pq_of(jpq), mesh=cpu_mesh(8), jmesh=jmeshmod.row_mesh(8))


def _regret(s64, ids, k):
    ref = -np.sort(-s64, axis=1)[:, :k]
    got = -np.sort(-np.take_along_axis(s64, np.asarray(ids, np.int64), axis=1), axis=1)
    return float(np.max(ref - got))


def _recall(ids, gt):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(np.asarray(ids), gt)]))


def test_pad_lists_match_jax(world):
    j = world["jpq"]
    arrays = [("centroids", j.centroids), ("codes", j.codes), ("slot_ids", j.slot_ids)]
    want = dict(jsharded_ivf._pad_lists([(n, np.asarray(a)) for n, a in arrays], NLIST, 8,
                                        True))
    got = dict(sharded_ivf._pad_lists(
        [(n, torch.from_numpy(np.array(a))) for n, a in arrays], NLIST, 8))
    assert want["centroids"].shape[0] == 48
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    # the IVF-Flat scales pad with ones, as the JAX from_index pads them
    sc = world["flat"]["i8"].slot_scales
    padded = dict(sharded_ivf._pad_lists([("slot_scales", sc)], NLIST, 8))["slot_scales"]
    assert torch.equal(padded[NLIST:], torch.ones((48 - NLIST, sc.shape[1])))


@pytest.mark.parametrize("nprobe", [1, 5, 16])
def test_sharded_ivfflat_matches_jax(world, nprobe):
    """Each shard probes ceil(nprobe / 8) of its own six lists (the last
    shard's all padding): its probe ids equal JAX's on the same shard except
    at a tie of the coarse scores at the last probe; merged values equal."""
    sh = sharded_ivf.ShardedIVFFlatIndex.from_index(world["flat"]["f32"], world["mesh"])
    jsh = jsharded_ivf.ShardedIVFFlatIndex.from_index(world["jflat"]["f32"], world["jmesh"])
    assert sh.nlist == jsh.nlist == 48 and sh.lcap == jsh.lcap
    q = torch.from_numpy(world["qp"])
    per = max(1, min(-(-nprobe // 8), 6))
    compared = 0
    for li in range(8):
        c, si = sh.centroids[li], sh.slot_ids[li]
        ours = _coarse_probes(q, c, si, per).numpy()
        theirs = np.asarray(j_coarse_probes(jnp.asarray(world["qp"]), jnp.asarray(c.numpy()),
                                            jnp.asarray(si.numpy()), per))
        live = (si >= 0).any(dim=1).numpy()
        score = 2.0 * world["qp"].astype(np.float64) @ c.numpy().T.astype(np.float64) \
            - np.sum(c.numpy().astype(np.float64) ** 2, axis=1)[None, :]
        score = np.where(live[None, :], score, -np.inf)
        for b in range(B):
            srt = -np.sort(-score[b])
            tie = per < len(srt) and np.isfinite(srt[per - 1]) and srt[per - 1] - srt[per] < 1e-6
            if not tie:
                keep = lambda p: {int(x) for x in p if live[x]}
                assert keep(ours[b]) == keep(theirs[b]), (li, b)
                compared += 1
    assert compared >= 8 * B - 4
    v, i = sh.search_device(q, K, nprobe)
    jv, _ = jsh.search_device(jnp.asarray(world["qp"]), K, nprobe, backend="jnp")
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    assert int(i.max()) < N


@pytest.mark.parametrize("dtype", ["f32", "i8"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_sharded_ivfflat_full_probing_is_exact(world, dtype, backend):
    sh = sharded_ivf.ShardedIVFFlatIndex.from_index(world["flat"][dtype], world["mesh"])
    v, i = sh.search(world["q"], K, nprobe=sh.nlist, q_chunk=5, backend=backend)
    jsh = jsharded_ivf.ShardedIVFFlatIndex.from_index(world["jflat"][dtype], world["jmesh"])
    jv, _ = jsh.search(world["q"], K, nprobe=jsh.nlist, backend="jnp")
    assert i.max() < N and i.dtype == np.int64
    if dtype == "f32":
        assert _regret(world["s64"], i, K) <= TOL
        np.testing.assert_allclose(v, jv, atol=TOL, rtol=TOL)
    else:
        # JAX scores an int8 slab with the bf16-rounded query; the port's
        # plain probe with the f32 query: both rank the same rows here
        assert _recall(i, world["gt"]) >= 0.9


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_sharded_ivfpq_candidates_match_jax(world, backend):
    """ADC-only results (dma candidates, exact f32 ADC on the oracle path):
    values within 1e-5 of JAX's and the same recall."""
    sh = sharded_ivf.ShardedIVFPQIndex.from_index(world["pq"], world["mesh"])
    jsh = jsharded_ivf.ShardedIVFPQIndex.from_index(world["jpq"], world["jmesh"])
    assert sh.nlist == jsh.nlist == 48 and sh.ids_mode() == jsh.ids_mode() == "key"
    v, i = sh.search_device(torch.from_numpy(world["qp"]), 50, 16, backend=backend)
    jv, ji = jsh.search_device(jnp.asarray(world["qp"]), 50, 16, backend="jnp")
    if backend == "auto":
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
        assert _recall(i[:, :K], world["gt"]) == _recall(np.asarray(ji)[:, :K], world["gt"])
    else:
        # the kernels' plain versions read bf16 tables
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-2, rtol=1e-2)
        assert abs(_recall(i[:, :K], world["gt"])
                   - _recall(np.asarray(ji)[:, :K], world["gt"])) <= 0.02


@pytest.mark.parametrize("store_kind", ["single", "sharded"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("dtype", ["f32", "i8"])
def test_sharded_ivfpq_refine_matches_jax(world, store_kind, metric, dtype):
    """Full probing and a deep refine: the refine after the merge, against a
    single-device store or one row-sharded over the same mesh (then each
    shard reranks what it owns); values within 1e-5 of JAX's."""
    base = world["base"]
    rows, sc = (vecbin.quantize_i8(base) if dtype == "i8" else (base, None))
    sh = sharded_ivf.ShardedIVFPQIndex.from_index(world["pq"], world["mesh"])
    jsh = jsharded_ivf.ShardedIVFPQIndex.from_index(world["jpq"], world["jmesh"])
    if store_kind == "sharded":
        store = ShardedVectorStore.from_numpy(rows, world["mesh"], dtype, scales=sc,
                                              row_block=RB)
        jstore = JVectorStore.from_numpy(rows, dtype, scales=sc, row_block=RB, n_shards=8,
                                         sharding=jmeshmod.row_sharding(world["jmesh"]))
        assert sharded_ivf._row_sharded_over(store, sh.mesh)
    else:
        store = VectorStore.from_numpy(rows, dtype, scales=sc, row_block=RB, device=CPU)
        jstore = JVectorStore.from_numpy(rows, dtype, scales=sc, row_block=RB)
    kw = dict(refine_k=200, refine_metric=metric)
    v, i = sh.search_device(torch.from_numpy(world["qp"]), K, sh.nlist, refine_store=store,
                            **kw)
    jv, _ = jsh.search_device(jnp.asarray(world["qp"]), K, jsh.nlist, refine_store=jstore,
                              backend="jnp", **kw)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    assert int(i.max()) < N
    if dtype == "f32":
        assert _regret(world["s64"], i.numpy(), K) <= 1e-4


@pytest.fixture(scope="module")
def residual(world):
    """Residual int8 codes of the base against the JAX-built index (rotated
    rows minus their list's centroid), in a row-sharded store of each package."""
    j = world["jpq"]
    rows = np.pad(world["base"], ((0, 0), (0, DP - D))) @ np.asarray(j.rotation)
    sids = np.asarray(j.slot_ids)
    li, si = np.nonzero(sids >= 0)
    list_of = np.zeros(N, np.int32)
    list_of[sids[li, si]] = li.astype(np.int32)
    cents = np.asarray(j.centroids)
    codes, sc = vecbin.quantize_i8(rows - cents[list_of])
    ours = ShardedVectorStore.from_numpy(codes, world["mesh"], "i8", scales=sc, row_block=RB)
    ours.attach_residual(cents, list_of)
    theirs = JVectorStore.from_numpy(codes, "i8", scales=sc, row_block=RB, n_shards=8,
                                     sharding=jmeshmod.row_sharding(world["jmesh"]))
    theirs.attach_residual(cents, list_of)
    return ours, theirs


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_sharded_ivfpq_residual_refine_matches_jax(world, residual, metric, backend):
    """The residual-int8 refine on a row-sharded store: res_ids sliced with
    the rows, res_cents whole on each shard, each shard's dequantized
    norms2, rotated queries."""
    ours, theirs = residual
    assert [s.res_ids.shape[0] for s in ours.shards] == [ours.rows_per_shard] * 8
    sh = sharded_ivf.ShardedIVFPQIndex.from_index(world["pq"], world["mesh"])
    jsh = jsharded_ivf.ShardedIVFPQIndex.from_index(world["jpq"], world["jmesh"])
    kw = dict(refine_k=200, refine_metric=metric)
    v, i = sh.search_device(torch.from_numpy(world["qp"]), K, sh.nlist, refine_store=ours,
                            backend=backend, **kw)
    jv, _ = jsh.search_device(jnp.asarray(world["qp"]), K, jsh.nlist, refine_store=theirs,
                              backend="jnp", **kw)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-5)
    assert _recall(i.numpy(), world["gt"]) >= 0.95


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_force_sharded_one_shard_equals_single_device(world, backend):
    """At S = 1 the probe set is the single-device one: the same ids, and
    values within 1e-5 (the merge may reorder key-mode candidates that tie
    at bf16, and the rerank's product then sums in another layout)."""
    sh = sharded_ivf.ShardedIVFPQIndex.from_index(world["pq"], cpu_mesh(1))
    store = VectorStore.from_numpy(world["base"], "f32", row_block=RB, device=CPU)
    q = torch.from_numpy(world["qp"])
    kw = dict(refine_k=50, refine_store=store, backend=backend)
    v, i = sh.search_device(q, K, 8, **kw)
    sv, si = world["pq"].search_device(q, K, 8, **kw)
    assert torch.equal(i, si)
    np.testing.assert_allclose(v.numpy(), sv.numpy(), atol=TOL, rtol=TOL)


def test_sharded_ivfpq_replicated_dedup():
    """A replicated index (R = 2) over 8 shards: a row's copies on two
    shards merge once; agreement with the single-device search >= 0.9 (as
    JAX's own test), and the id mode is JAX's."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((8000, 64)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    q = base[rng.choice(8000, 16, replace=False)]
    one = JIVFPQIndex.build(base, nlist=32, m=8, use_opq=False, n_iters=6, seed=7)
    jrep = JIVFPQIndex.repack(one, base, pad_factor=2.0, replicas=2)
    rep = _pq_of(jrep)
    sh = sharded_ivf.ShardedIVFPQIndex.from_index(rep, cpu_mesh(8))
    jsh = jsharded_ivf.ShardedIVFPQIndex.from_index(jrep, jmeshmod.row_mesh(8))
    assert sh.replicas == 2 and sh.ids_mode() == jsh.ids_mode() == "dma"
    _, i_single = rep.search(q, 10, nprobe=32)
    for backend in ("auto", "torch"):
        _, i_shard = sh.search(q, 10, nprobe=32, backend=backend)
        assert all(len(set(row.tolist())) == 10 for row in i_shard)
        agree = np.mean([len(set(a) & set(b)) / 10
                         for a, b in zip(i_single.tolist(), i_shard.tolist())])
        assert agree >= 0.9


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("dtype", ["f32", "i8"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_sharded_refine_matches_jax(world, metric, dtype, backend):
    """Candidates with -1 padding, a row of -1 only, and ids on every shard:
    each shard reranks the ones it owns; values within 1e-5 of JAX's."""
    base = world["base"]
    rows, sc = (vecbin.quantize_i8(base) if dtype == "i8" else (base, None))
    rng = np.random.default_rng(21)
    cand = np.stack([rng.choice(N, 40, replace=False) for _ in range(B)]).astype(np.int32)
    cand[0, 25:] = -1
    cand[1, :] = -1
    store = ShardedVectorStore.from_numpy(rows, world["mesh"], dtype, scales=sc, row_block=RB)
    jstore = JVectorStore.from_numpy(rows, dtype, scales=sc, row_block=RB, n_shards=8,
                                     sharding=jmeshmod.row_sharding(world["jmesh"]))
    v, i = sharded_ivf.sharded_refine(world["mesh"], torch.from_numpy(world["qp"]),
                                      torch.from_numpy(cand), store.vectors, store.scales, K,
                                      metric=metric, backend=backend,
                                      norms2=store.norms2() if metric == "l2" else None)
    jv, ji = jsharded_ivf.sharded_refine(world["jmesh"], jnp.asarray(world["qp"]),
                                         jnp.asarray(cand), jstore.vectors, jstore.scales, K,
                                         metric=metric, backend="jnp")
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    assert (i.numpy()[1] == -1).all() and np.isneginf(v.numpy()[1]).all()
    ok = i.numpy() >= 0
    assert np.isin(i.numpy(), cand).all() and np.array_equal(ok, np.asarray(ji) >= 0)


def _partition_of(j):
    s = j.refine_store
    refine = dict(vectors=np.asarray(s.vectors),
                  scales=None if s.scales is None else np.asarray(s.scales),
                  n=s.n, d=s.d, dtype_code=s.dtype_code, src_dtype_code=s.src_dtype_code)
    if s.is_residual:
        refine.update(res_cents=np.asarray(s.res_cents), res_ids=np.asarray(s.res_ids))
    jivf = j.ivf
    ivf = dict(centroids=np.asarray(jivf.centroids), packed=np.asarray(jivf.packed),
               slot_ids=np.asarray(jivf.slot_ids), slot_scales=None, n=jivf.n, d=jivf.d,
               dtype_code=jivf.dtype_code)
    return PartitionRerankIndex.from_reference(ivf, refine, device="cpu")


@pytest.fixture(scope="module")
def partitions(world):
    j = JPartition.build(world["base"], nlist=NLIST, with_refine=True, seed=5)
    jres = JPartition(ivf=j.ivf, refine_store=JPartition._residual_store(world["base"],
                                                                          j.ivf))
    return {"f32": (j, _partition_of(j)), "res_i8": (jres, _partition_of(jres))}


@pytest.mark.parametrize("nprobe", [16, 48])
@pytest.mark.parametrize("store_kind", ["single", "sharded"])
def test_sharded_partition_matches_jax(world, partitions, nprobe, store_kind):
    j, t = partitions["f32"]
    sh = sharded_ivf.ShardedPartitionIndex.from_index(t, world["mesh"])
    if store_kind == "sharded":
        sh.refine_store = ShardedVectorStore.from_store(
            VectorStore.from_numpy(world["base"], "f32", row_block=RB, n_shards=8,
                                   device=CPU), world["mesh"])
    jsh = jsharded_ivf.ShardedPartitionIndex.from_index(j, world["jmesh"])
    v, i = sh.search(world["q"], K, nprobe, rerank_k=50)
    jv, _ = jsh.search(world["q"], K, nprobe, rerank_k=50)
    np.testing.assert_allclose(v, jv, atol=TOL, rtol=TOL)
    if nprobe == 48:   # full probing: exact
        assert _regret(world["s64"], i, K) <= 1e-4


def test_sharded_partition_residual_refine_uses_centroids(world, partitions):
    """A residual-int8 refine store is scored with its centroids on the
    sharded index as on the single-device one (the JAX sharded index passes
    none: ROADMAP.md queue 3): at full probing the values equal JAX's
    single-device partition search."""
    j, t = partitions["res_i8"]
    sh = sharded_ivf.ShardedPartitionIndex.from_index(t, world["mesh"])
    v, i = sh.search(world["q"], K, sh.nlist, rerank_k=50)
    jv, _ = j.search(world["q"], K, NLIST, rerank_k=50)
    sv, _ = t.search(world["q"], K, NLIST, rerank_k=50)
    np.testing.assert_allclose(v, jv, atol=1e-4, rtol=TOL)
    np.testing.assert_allclose(v, sv, atol=1e-4, rtol=TOL)
    assert _recall(i, world["gt"]) >= 0.95


@pytest.fixture(scope="module")
def tool_files(world, tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_tools")
    paths = {"base": str(d / "b.vecbin"), "q": str(d / "q.vecbin"), "gt": str(d / "gt.gtbin"),
             "idx": str(d / "pq.npz"), "flat": str(d / "flat.npz")}
    jvecbin.write_vecbin(paths["base"], world["base"])
    jvecbin.write_vecbin(paths["q"], world["q"])
    jgtbin.write_gtbin(paths["gt"], world["gt"], dim=D, N=N)
    world["jpq"].save(paths["idx"])
    world["jflat"]["f32"].save(paths["flat"])
    return paths


def _keys(out):
    return [{kv.split("=", 1)[0] for kv in line.split()[1:]}
            for line in out.splitlines() if line.startswith("RESULT ")]


@pytest.mark.parametrize("sharding", [["--shards", "4"], ["--force-sharded"]])
@pytest.mark.parametrize("mode", [[], ["--chained"]])
def test_ivf_eval_sharded_result_keys_match_jax(tool_files, capsys, sharding, mode):
    """The JAX tool's RESULT keys (the port's add the device), the
    ``<kind>-sharded<S>`` label, and ``--ids-mode`` ignored with a warning."""
    from nvdb_tpu.tools import ivf_eval as jivf_eval

    f = tool_files
    args = [f["idx"], f["base"], f["q"], "--gt", f["gt"], "--nprobe", "8", "--refine-k", "0",
            "40", "--batch-q", "8", "--warmup", "0", "--ids-mode", "key", *sharding, *mode]
    got = ivf_eval.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    jivf_eval.main(args + ["--cpu", "--ivf-backend", "jnp"])
    jout = capsys.readouterr().out
    S = sharding[1] if len(sharding) > 1 else "1"
    assert [o - {"device"} for o in _keys(out)] == _keys(jout) and len(got) == 2
    assert all(r["kind"] == f"ivfpq-sharded{S}" for r in got)
    assert "WARNING: --ids-mode key ignored (sharded path" in out
    assert all("ids_mode" not in r and r["recall"] > 0.3 for r in got)


@pytest.mark.parametrize("kind", ["idx", "flat"])
def test_ivf_eval_force_sharded_one_shard_equals_single(tool_files, capsys, kind):
    """``--force-sharded --shards 1`` probes the single-device lists: the
    same recall; the sharded refine runs at stage B."""
    f = tool_files
    args = [f[kind], f["base"], f["q"], "--gt", f["gt"], "--nprobe", "8", "--refine-k",
            "40" if kind == "idx" else "0", "--batch-q", "8", "--warmup", "0", "--device", "cpu"]
    single = ivf_eval.main(args)
    forced = ivf_eval.main(args + ["--force-sharded"])
    capsys.readouterr()
    assert len(forced) == len(single) == 1
    assert [r["recall"] for r in forced] == [r["recall"] for r in single]
    assert forced[0]["kind"].endswith("-sharded1")


def test_pr_eval_shards_result_keys_match_jax(tool_files, capsys):
    """``pr_eval --shards 2`` on CPU shards: the JAX tool's RESULT keys (the
    port's add the device, backend and batch size), the sharded label."""
    from nvdb_tpu.tools import pr_eval as jpr_eval

    f = tool_files
    args = [f["base"], f["q"], "--gt", f["gt"], "--nprobe", "4", "16", "--rerank-k", "50",
            "--batch-q", "8", "--nlist", str(NLIST), "--shards", "2", "--warmup", "0"]
    got = pr_eval.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    jpr_eval.main(args + ["--cpu"])
    jout = capsys.readouterr().out
    assert [o - {"device", "backend", "batch_q"} for o in _keys(out)] == _keys(jout)
    assert [r["kind"] for r in got] == ["partition-rerank-sharded2"] * 2
    assert got[1]["recall"] >= 0.5
