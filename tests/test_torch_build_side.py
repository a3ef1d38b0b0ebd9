"""The build side of the PyTorch port against ``nvdb_tpu`` (4,000 x 64, Dp
128, nlist 16): ``kmeans.corpus_refine`` from the same starting centroids,
``IVFFlatIndex.repack`` and ``IVFPQIndex.repack`` (replicas 1 and 2) of an
index the JAX package built and the port carried across, the replicated
``.npz`` both ways, and the builds with ``corpus_refine_iters``.

Tolerances. ``corpus_refine``: the pool is the same numpy draw and the
ties break the same way (stable sorts, first pool row, first-index
argmin), so the dead counts are equal and the centroids agree to atol
1e-5 (f32 sums in another order). Repack from the same centroids: slot
ids, payload or codes, scales, ``lcap`` and ``n_spilled`` equal bit for
bit; two centroids whose scores differ in the last bit of an f32 sum could
swap in the top-S lists (the two packages sum products in another order),
and this data has no such pair. Searches of the repacked indexes: ids
equal at >= 0.99 of positions, values to atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex
from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from nvdb_tpu.kernels import kmeans as jkmeans
from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.kernels import kmeans
from nvdb_tpu_torch.store import VectorStore

N, D, NLIST, M, B = 4000, 64, 16, 16, 8
DTYPES = ["f32", "bf16", "i8"]


class _JStore:
    """The refine store as the JAX index reads it."""

    def __init__(self, base):
        self.vectors = jnp.asarray(np.pad(base, ((0, 0), (0, 128 - base.shape[1]))))
        self.scales = None


@pytest.fixture(scope="module")
def world():
    """Tightly packed JAX indexes (pad 1.0, 2 spill candidates: they spill)."""
    base = jsynth.low_rank(N, D, intrinsic=16, n_clusters=12, spread=0.5, seed=71)
    queries, _ = jsynth.sample_queries(base, B, seed=72, perturb=0.05)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    gt = np.argsort(-s64, axis=1, kind="stable")[:, :10]
    pq = JIVFPQIndex.build(base, nlist=NLIST, m=M, use_opq=True, n_iters=6, opq_iters=2,
                           pad_factor=1.0, spill_candidates=2, seed=2, train_size=N,
                           cb_iters=4)
    flat = {dt: JIVFFlatIndex.build(base, nlist=NLIST, dtype=dt, n_iters=6,
                                    pad_factor=1.0, spill_candidates=2, seed=4)
            for dt in DTYPES}
    return dict(base=base, q=queries, gt=gt, pq=pq, flat=flat,
                store=VectorStore.from_numpy(base, device="cpu"))


def _port_pq(j):
    return IVFPQIndex.from_reference(
        None if j.rotation is None else np.asarray(j.rotation), np.asarray(j.centroids),
        np.asarray(j.codebooks), np.asarray(j.codes), np.asarray(j.slot_ids),
        j.n, j.d, j.m, n_spilled=j.n_spilled, replicas=j.replicas, device="cpu")


def _port_flat(j):
    return IVFFlatIndex.from_reference(
        np.asarray(j.centroids), np.asarray(j.packed), np.asarray(j.slot_ids),
        None if j.slot_scales is None else np.asarray(j.slot_scales),
        j.n, j.d, j.dtype_code, n_spilled=j.n_spilled, device="cpu")


def _payload_bits(packed):
    """A payload as comparable numpy (a bf16 pack as its uint16 bits)."""
    if isinstance(packed, torch.Tensor):
        if packed.dtype == torch.bfloat16:
            return packed.view(torch.int16).numpy().view(np.uint16)
        return packed.numpy()
    a = np.asarray(packed)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _recall(ids, gt):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


# -- corpus_refine -------------------------------------------------------------------

@pytest.fixture(scope="module")
def starved():
    """The 8M failure mode in small: a subsample quantizer with 10 centroids
    stranded outside the data ball (dead on the corpus)."""
    base = jsynth.clustered(4000, 64, n_clusters=48, seed=13)
    fit, _ = jkmeans.kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(base[:1000]), 48,
                                n_iters=6)
    rng = np.random.default_rng(5)
    stranded = rng.standard_normal((10, 64)).astype(np.float32)
    stranded *= 3.0 / np.linalg.norm(stranded, axis=1, keepdims=True)
    return base, np.concatenate([np.asarray(fit)[:-10], stranded])


def _dead_and_objective(base, cents):
    a = kmeans.assign(torch.from_numpy(base), torch.as_tensor(np.asarray(cents))).numpy()
    counts = np.bincount(a, minlength=cents.shape[0])
    obj = float(np.mean(np.sum((base - np.asarray(cents)[a]) ** 2, axis=1)))
    return int((counts == 0).sum()), obj


@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_corpus_refine_matches_jax(starved, monkeypatch, n_iters):
    """From the same starting centroids: the same pool rows, the same dead
    count per pass, centroids to atol 1e-5."""
    base, c0 = starved
    pools = {}
    j_update, t_update = jkmeans._corpus_update, kmeans._corpus_update

    def j_spy(cents, sums, counts, pool, k, reseed):
        pools["jax"] = np.asarray(pool)
        return j_update(cents, sums, counts, pool, k, reseed)

    def t_spy(cents, sums, counts, pool, reseed):
        pools["port"] = pool.numpy().copy()
        return t_update(cents, sums, counts, pool, reseed)

    monkeypatch.setattr(jkmeans, "_corpus_update", j_spy)
    monkeypatch.setattr(kmeans, "_corpus_update", t_spy)
    jlog, tlog = [], []
    want = jkmeans.corpus_refine(base, jnp.asarray(c0), n_iters=n_iters, chunk=1024,
                                 pool_rows=2048, log=jlog.append)
    got = kmeans.corpus_refine(base, torch.from_numpy(c0), n_iters=n_iters, chunk=1024,
                               pool_rows=2048, log=tlog.append)
    assert tlog == jlog and len(tlog) == n_iters
    np.testing.assert_array_equal(pools["port"], pools["jax"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_corpus_refine_device_tensor_equals_host_stream(starved):
    """A corpus already in a tensor gives the centroids of the streamed host
    corpus, bit for bit (the same chunks in the same order)."""
    base, c0 = starved
    a = kmeans.corpus_refine(base, torch.from_numpy(c0), n_iters=2, chunk=1500)
    b = kmeans.corpus_refine(torch.from_numpy(base), torch.from_numpy(c0), n_iters=2,
                             chunk=1500)
    assert torch.equal(a, b)


def test_corpus_refine_reclaims_dead_centroids(starved):
    """Mirrors tests/test_kmeans.py: fewer dead lists (at most one of 48
    after three passes), a lower objective."""
    base, c0 = starved
    dead0, obj0 = _dead_and_objective(base, c0)
    assert dead0 >= 10
    cents = kmeans.corpus_refine(base, torch.from_numpy(c0), n_iters=3, chunk=1024,
                                 pool_rows=2048)
    dead1, obj1 = _dead_and_objective(base, cents)
    assert dead1 < dead0 and dead1 <= 1
    assert obj1 < obj0


def test_corpus_refine_noop_on_healthy_quantizer():
    """On a quantizer with no dead list one pass is a pure Lloyd polish."""
    base = jsynth.clustered(3000, 64, n_clusters=16, seed=14)
    cents0, _ = kmeans.kmeans_fit(torch.Generator().manual_seed(1), torch.from_numpy(base),
                                  16, n_iters=10)
    dead0, obj0 = _dead_and_objective(base, cents0.numpy())
    cents1 = kmeans.corpus_refine(base, cents0, n_iters=1, chunk=1024)
    dead1, obj1 = _dead_and_objective(base, cents1.numpy())
    assert dead1 == dead0 == 0
    assert obj1 <= obj0 + 1e-6


@pytest.mark.parametrize("kind", ["ivfflat", "ivfpq"])
def test_build_with_corpus_refine(world, kind):
    """``corpus_refine_iters`` in both builds: the refined quantizer has no
    more corpus-dead lists than the plain one, every row is packed once, and
    recall@10 stays within 0.02 of the JAX build with the same option."""
    base = world["base"]
    kw = dict(nlist=NLIST, n_iters=4, train_size=500, seed=3)
    if kind == "ivfflat":
        plain = IVFFlatIndex.build(base, device="cpu", **kw)
        refined = IVFFlatIndex.build(base, corpus_refine_iters=2, device="cpu", **kw)
        jref = JIVFFlatIndex.build(base, corpus_refine_iters=2, **kw)
        search = dict(k=10, nprobe=4)
        _, ti = refined.search(world["q"], **search)
        _, ji = jref.search(world["q"], **search)
    else:
        kw.update(m=M, use_opq=False, cb_iters=4)
        plain = IVFPQIndex.build(base, device="cpu", **kw)
        refined = IVFPQIndex.build(base, corpus_refine_iters=2, device="cpu", **kw)
        jref = JIVFPQIndex.build(base, corpus_refine_iters=2, **kw)
        _, ti = refined.search(world["q"], 10, 4, refine_k=40, refine_store=world["store"])
        _, ji = jref.search(world["q"], 10, 4, refine_k=40, refine_store=_JStore(base))
    pad = np.zeros((N, 128), np.float32)   # the coarse space (no OPQ rotation)
    pad[:, :D] = base
    dead_plain, _ = _dead_and_objective(pad, plain.centroids.numpy())
    dead_ref, _ = _dead_and_objective(pad, refined.centroids.numpy())
    assert dead_ref <= dead_plain
    live = refined.slot_ids.numpy()
    assert sorted(live[live >= 0].tolist()) == list(range(N))
    assert _recall(ti, world["gt"]) >= _recall(np.asarray(ji), world["gt"]) - 0.02


# -- repack --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_ivfflat_repack_bit_for_bit(world, dtype):
    j = world["flat"][dtype]
    want = JIVFFlatIndex.repack(j, world["base"], pad_factor=4.0, spill_candidates=8)
    got = IVFFlatIndex.repack(_port_flat(j), world["base"], pad_factor=4.0,
                              spill_candidates=8)
    assert j.n_spilled > 0 and got.n_spilled < j.n_spilled
    assert (got.lcap, got.n_spilled, got.dtype_code) == (want.lcap, want.n_spilled,
                                                         want.dtype_code)
    np.testing.assert_array_equal(got.slot_ids.numpy(), np.asarray(want.slot_ids))
    np.testing.assert_array_equal(_payload_bits(got.packed), _payload_bits(want.packed))
    if dtype == "i8":
        np.testing.assert_array_equal(got.slot_scales.numpy(), np.asarray(want.slot_scales))
    else:
        assert got.slot_scales is None
    # the centroids are kept; every row is packed once
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(j.centroids))
    live = got.slot_ids.numpy()
    assert sorted(live[live >= 0].tolist()) == list(range(N))
    tv, ti = got.search(world["q"], 10, 4)
    jv, ji = want.search(world["q"], 10, 4)
    assert np.mean(ti == np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("replicas", [1, 2])
def test_ivfpq_repack_bit_for_bit(world, replicas):
    j = world["pq"]
    want = JIVFPQIndex.repack(j, world["base"], pad_factor=2.0, spill_candidates=8,
                              replicas=replicas)
    got = IVFPQIndex.repack(_port_pq(j), world["base"], pad_factor=2.0, spill_candidates=8,
                            replicas=replicas)
    assert got.replicas == want.replicas == replicas
    assert (got.lcap, got.n_spilled) == (want.lcap, want.n_spilled)
    assert got.n_spilled < j.n_spilled
    np.testing.assert_array_equal(got.slot_ids.numpy(), np.asarray(want.slot_ids))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    for name in ("rotation", "centroids", "codebooks"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(j, name)))
    live = got.slot_ids.numpy()
    counts = np.bincount(live[live >= 0], minlength=N)
    assert counts.min() >= 1 and counts.max() == replicas
    assert got.ids_mode() == ("key" if replicas == 1 else "dma")
    tv, ti = got.search(world["q"], 10, 4, refine_k=40, refine_store=world["store"])
    jv, ji = want.search(world["q"], 10, 4, refine_k=40,
                         refine_store=_JStore(world["base"]))
    assert np.mean(ti == np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)
    for row in ti:
        assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_replicated_search_returns_each_id_once(world, backend):
    """The replicated index on the plain paths: ADC candidates and refined
    results never repeat an id, and the ADC candidates cover the rows that
    the single-copy index finds."""
    t = IVFPQIndex.repack(_port_pq(world["pq"]), world["base"], pad_factor=2.0,
                          replicas=2)
    one = IVFPQIndex.repack(_port_pq(world["pq"]), world["base"], pad_factor=4.0)
    for kw in (dict(), dict(refine_k=40, refine_store=world["store"])):
        _, ids = t.search(world["q"], 30, 2, backend=backend, **kw)
        for row in ids:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live) == 30
    _, i2 = t.search(world["q"], 10, 1, refine_k=100, refine_store=world["store"],
                     backend=backend)
    _, i1 = one.search(world["q"], 10, 1, refine_k=100, refine_store=world["store"],
                       backend=backend)
    assert _recall(i2, world["gt"]) >= _recall(i1, world["gt"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replicated_npz_loads_in_the_other_package(world, tmp_path, writer):
    path = str(tmp_path / "rep.npz")
    j = JIVFPQIndex.repack(world["pq"], world["base"], pad_factor=2.0, replicas=2)
    t = IVFPQIndex.repack(_port_pq(world["pq"]), world["base"], pad_factor=2.0, replicas=2)
    if writer == "port":
        t.save(path)
        back = JIVFPQIndex.load(path)
        assert back.replicas == 2
        np.testing.assert_array_equal(np.asarray(back.codes), t.codes.numpy())
        _, bi = back.search(world["q"], 10, 4, refine_k=40,
                            refine_store=_JStore(world["base"]))
        _, ti = t.search(world["q"], 10, 4, refine_k=40, refine_store=world["store"])
    else:
        j.save(path)
        back = IVFPQIndex.load(path, device="cpu")
        assert back.replicas == 2 and back.ids_mode() == "dma"
        np.testing.assert_array_equal(back.slot_ids.numpy(), np.asarray(j.slot_ids))
        _, bi = back.search(world["q"], 10, 4, refine_k=40, refine_store=world["store"])
        _, ti = j.search(world["q"], 10, 4, refine_k=40, refine_store=_JStore(world["base"]))
    # the exact refine orders the ids: ADC scores of rows with equal codes
    # tie, and the packages order ties otherwise
    assert np.mean(np.asarray(bi) == np.asarray(ti)) >= 0.99
