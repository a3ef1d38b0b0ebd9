"""IVF-PQ parity of the PyTorch port against ``nvdb_tpu.index.ivf_pq`` at the
sizes of test_adc_scan.py (6000 x 128, nlist 16, m 16, B 8): an index built
by JAX, saved and loaded by the port (and back); the plain version of the
ADC kernel against ``pallas_adc_topk(ids_mode="dma")`` in interpret mode;
the gather mode's route (the fused plain version, the key mode's result bit
for bit; the slab as its A/B) and its parity with the JAX gather path;
``search_device`` with refine; a replicated index; the port's own build;
the deterministic helpers bit for bit.

Tolerances. ADC: the kernel and its plain version round the tables to bf16
and sum in f32 in another order than the Pallas kernel, so candidate sets
overlap at >= 0.9 k per row and values agree to atol 1e-3. After the exact
refine: ids equal at >= 0.99 of positions, values to atol 1e-5. Builds draw
other random numbers than JAX: recall@10 within 0.02 of the JAX-built
index's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.index import ivf_flat as jivf_flat
from nvdb_tpu.index import ivf_pq as jivf_pq
from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from nvdb_tpu.kernels import adc_scan as jadc
from nvdb_tpu.kernels import pq as jpq
from nvdb_tpu_torch.index import ivf_flat, ivf_pq
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.kernels import adc_scan
from nvdb_tpu_torch.store import VectorStore

N, D, NLIST, M, B = 6000, 128, 16, 16, 8


class _JStore:
    """The refine store as the JAX index reads it (vectors + scales)."""

    def __init__(self, base):
        self.vectors = jnp.asarray(base)
        self.scales = None


@pytest.fixture(scope="module")
def world():
    base = jsynth.low_rank(N, D, intrinsic=16, n_clusters=64, seed=3)
    j = JIVFPQIndex.build(base, nlist=NLIST, m=M, use_opq=True, train_size=4000, seed=0)
    queries, _ = jsynth.sample_queries(base, B, seed=5, perturb=0.02)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    gt = np.argsort(-s64, axis=1, kind="stable")[:, :10]
    return dict(base=base, j=j, q=queries, gt=gt,
                store=VectorStore.from_numpy(base, device="cpu"))


def _port_of(j):
    return IVFPQIndex.from_reference(
        None if j.rotation is None else np.asarray(j.rotation), np.asarray(j.centroids),
        np.asarray(j.codebooks), np.asarray(j.codes), np.asarray(j.slot_ids),
        j.n, j.d, j.m, n_spilled=j.n_spilled, replicas=j.replicas, device="cpu")


def _recall(ids, gt):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def _assert_overlap(a, b, frac):
    for x, y in zip(a, b):
        assert len(set(x.tolist()) & set(y.tolist())) >= int(frac * len(x))


def _probes_and_lut(j, q, nprobe):
    """Coarse probes and f32 ADC tables of the JAX index (shared inputs)."""
    qp = jnp.asarray(q)
    q_rot = qp @ j.rotation
    probes = jivf_flat._coarse_probes(q_rot, j.centroids, j.slot_ids, nprobe)
    res = q_rot[:, None, :] - jnp.take(j.centroids, probes, axis=0)
    lut = jpq.adc_lut(res.reshape(q.shape[0] * nprobe, -1), j.codebooks, j.m)
    return np.array(probes), np.array(lut).reshape(q.shape[0], nprobe, j.m, 256)


def test_load_jax_index(world, tmp_path):
    j = world["j"]
    path = str(tmp_path / "j.npz")
    j.save(path)
    t = IVFPQIndex.load(path, device="cpu")
    for name in ("rotation", "centroids", "codebooks", "codes", "slot_ids"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert (t.n, t.d, t.m, t.n_spilled, t.replicas) == (j.n, j.d, j.m, j.n_spilled, j.replicas)
    assert (t.nlist, t.lcap, t.index_bytes) == (j.nlist, j.lcap, j.index_bytes)
    np.testing.assert_array_equal(t.fills().numpy(), np.asarray(j.fills()))
    assert t.ids_mode() == j.ids_mode()


def test_save_round_trip_loads_in_jax(world, tmp_path):
    t = _port_of(world["j"])
    path = str(tmp_path / "t.npz")
    t.save(path)
    back = JIVFPQIndex.load(path)
    for name in ("rotation", "centroids", "codebooks", "codes", "slot_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(t, name).numpy())
    assert (back.n, back.d, back.m, back.replicas) == (t.n, t.d, t.m, t.replicas)
    jv, ji = world["j"].search(world["q"], 10, 4)
    bv, bi = back.search(world["q"], 10, 4)
    np.testing.assert_array_equal(np.asarray(bi), np.asarray(ji))


@pytest.mark.parametrize("nprobe,kk", [(4, 10), (8, 200)])
def test_adc_reference_matches_pallas_dma(world, nprobe, kk):
    j = world["j"]
    probes, lut = _probes_and_lut(j, world["q"], nprobe)
    tv, ti = adc_scan.adc_topk_reference(torch.from_numpy(lut), torch.from_numpy(probes),
                                         torch.from_numpy(np.array(j.codes)),
                                         torch.from_numpy(np.array(j.slot_ids)), kk)
    pv, pi = jadc.pallas_adc_topk(jnp.asarray(lut).reshape(B, nprobe, M, 16, 16),
                                  jnp.asarray(probes), j.codes, j.slot_ids, kk,
                                  ids_mode="dma", interpret=True)
    tv, ti, pv, pi = tv.numpy(), ti.numpy(), np.asarray(pv), np.asarray(pi)
    for r in range(B):
        live = ti[r][ti[r] >= 0]
        assert len(set(live.tolist())) == len(live)            # no duplicate ids
        assert np.all(np.diff(tv[r][np.isfinite(tv[r])]) <= 0)  # sorted
        inter = len(set(live.tolist()) & set(pi[r][pi[r] >= 0].tolist()))
        assert inter >= int(0.9 * min(kk, len(live)))
    fin = np.isfinite(pv) & np.isfinite(tv)
    np.testing.assert_allclose(tv[fin], pv[fin], atol=1e-3, rtol=0)


def test_adc_reference_collapses_duplicate_ids():
    """A replicated index holds a row in two lists: one slot, best score."""
    rng = np.random.default_rng(0)
    m, lcap, nlist, k = 4, 16, 3, 6
    codes = rng.integers(0, 256, (nlist, m, lcap)).astype(np.uint8)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    slot_ids[0, :5] = [0, 1, 2, 3, 4]
    slot_ids[1, :5] = [3, 4, 5, 6, 7]
    slot_ids[2, :2] = [0, 8]
    lut = rng.standard_normal((1, nlist, m, 256)).astype(np.float32)
    probes = np.arange(nlist, dtype=np.int32)[None, :]
    v, i = adc_scan.adc_topk_reference(torch.from_numpy(lut), torch.from_numpy(probes),
                                       torch.from_numpy(codes), torch.from_numpy(slot_ids),
                                       k)
    v, i = v.numpy()[0], i.numpy()[0]
    assert (i >= 0).all() and len(set(i.tolist())) == k
    lutb = torch.from_numpy(lut).to(torch.bfloat16).float().numpy()[0]
    best = {}
    for li in range(nlist):
        for lane in range(lcap):
            sid = int(slot_ids[li, lane])
            if sid >= 0:
                s = np.float32(0)
                for mm in range(m):
                    s = np.float32(s + lutb[li, mm, codes[li, mm, lane]])
                best[sid] = max(best.get(sid, -np.inf), -s)
    want = sorted(best.items(), key=lambda kv: (-kv[1], -kv[0]))[:k]
    assert i.tolist() == [sid for sid, _ in want]
    np.testing.assert_array_equal(v, np.array([s for _, s in want], np.float32))


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_search_device_with_refine_matches_jax(world, backend):
    j = world["j"]
    t = _port_of(j)
    jv, ji = j.search(world["q"], 10, 8, refine_k=40, refine_store=_JStore(world["base"]))
    tv, ti = t.search(world["q"], 10, 8, refine_k=40, refine_store=world["store"],
                      backend=backend)
    assert np.mean(ti == np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)


def test_search_device_adc_only_matches_jax(world):
    """Without refine, auto on the CPU is the JAX package's f32-table path."""
    j = world["j"]
    t = _port_of(j)
    jv, ji = j.search(world["q"], 10, 4)
    tv, ti = t.search(world["q"], 10, 4)
    assert np.mean(ti == np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-4, rtol=0)


def test_replicated_index_from_jax(world):
    base = jsynth.low_rank(4000, 64, intrinsic=8, n_clusters=32, seed=9)
    one = JIVFPQIndex.build(base, nlist=16, m=8, use_opq=False, n_iters=4, seed=7,
                            train_size=4000)
    rep = JIVFPQIndex.repack(one, base, pad_factor=2.0, replicas=2)
    queries, _ = jsynth.sample_queries(base, 8, seed=10, perturb=0.02)
    t = _port_of(rep)
    assert t.replicas == 2 and t.ids_mode() == "dma"
    jv, ji = rep.search(queries, 10, 8)
    for backend in ("auto", "torch"):
        tv, ti = t.search(queries, 10, 8, backend=backend)
        for row in ti:
            live = row[row >= 0]
            assert len(live) == 10 and len(set(live.tolist())) == 10
        if backend == "auto":
            # rows with equal codes tie; ties order differently (module doc)
            np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-4, rtol=0)
            _assert_overlap(ti, np.asarray(ji), 0.9)
    store = VectorStore.from_numpy(base, device="cpu")
    jv, ji = rep.search(queries, 10, 8, refine_k=30, refine_store=_JStore(
        np.pad(base, ((0, 0), (0, 64)))))
    tv, ti = t.search(queries, 10, 8, refine_k=30, refine_store=store)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)
    _assert_overlap(ti, np.asarray(ji), 0.9)


def test_port_build_recall_near_jax(world):
    t = IVFPQIndex.build(world["base"], nlist=NLIST, m=M, use_opq=True, train_size=4000,
                         seed=0, device="cpu")
    assert (t.nlist, t.lcap, t.m) == (world["j"].nlist, world["j"].lcap, M)
    live = t.slot_ids.numpy()
    assert sorted(live[live >= 0].tolist()) == list(range(N))   # every row packed once
    _, ti = t.search(world["q"], 10, 8, refine_k=40, refine_store=world["store"])
    _, ji = world["j"].search(world["q"], 10, 8, refine_k=40,
                              refine_store=_JStore(world["base"]))
    assert _recall(ti, world["gt"]) >= _recall(np.asarray(ji), world["gt"]) - 0.02


def test_deterministic_helpers_bit_for_bit(world):
    j = world["j"]
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 128)).astype(np.float32)
    cents, sids = np.array(j.centroids), np.array(j.slot_ids)
    sids[3] = -1                                                  # an empty list
    got = ivf_flat._coarse_probes(torch.from_numpy(q), torch.from_numpy(cents),
                                  torch.from_numpy(sids), 6).numpy()
    want = np.asarray(jivf_flat._coarse_probes(jnp.asarray(q), jnp.asarray(cents),
                                               jnp.asarray(sids), 6))
    np.testing.assert_array_equal(got, want)
    assert not (got == 3).any()
    x = rng.standard_normal((1000, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        ivf_flat._topS_centroids(torch.from_numpy(x), torch.from_numpy(cents), 4).numpy(),
        np.asarray(jivf_flat._topS_centroids(jnp.asarray(x), jnp.asarray(cents), 4)))
    alts = rng.integers(0, 16, (3000, 4))
    got = ivf_flat._pack_lists(np.zeros((3000, 1), np.float32), None, alts[:, 0], None,
                               alts, 16, 256, 1)
    want = jivf_flat._pack_lists(np.zeros((3000, 1), np.float32), None, alts[:, 0], None,
                                 alts, 16, 256, 1)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[3] == want[3]
    holes = np.array([[0, -1, 2, -1], [3, -1, -1, -1], [-1, -1, -1, -1]], np.int32)
    np.testing.assert_array_equal(adc_scan.list_fills(torch.from_numpy(holes)).numpy(),
                                  np.asarray(jadc.list_fills(jnp.asarray(holes))))
    assert not adc_scan.is_prefix_packed(torch.from_numpy(holes))
    assert adc_scan.is_prefix_packed(torch.from_numpy(np.array(j.slot_ids)))


def test_corpus_refine_build_and_cuda_wrapper_guard(world):
    """``corpus_refine_iters`` builds (it raised before the build side was
    ported): every row packed once; the ADC kernel wrapper still refuses a
    CPU tensor."""
    t = _port_of(world["j"])
    r = IVFPQIndex.build(world["base"][:500], nlist=4, m=16, corpus_refine_iters=1,
                         device="cpu")
    live = r.slot_ids.numpy()
    assert sorted(live[live >= 0].tolist()) == list(range(500))
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_topk_cuda(torch.zeros((1, 1, M, 256)), torch.zeros((1, 1)),
                               t.codes, t.slot_ids, 10)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_search_block_matches_jax_block(world, backend):
    """``_ivfpq_search_block`` on the CPU: ``auto`` is the JAX package's f32
    jnp block (ids equal at >= 0.99 of positions, values to 1e-4); ``torch``
    rounds the tables to bf16 as the JAX block's pallas backend does (run
    in interpret mode: candidate overlap >= 0.9 k, values to 1e-3). The
    index's cached coarse terms change nothing."""
    j = world["j"]
    t = _port_of(j)
    k, nprobe = 20, 8
    qp = np.zeros((B, 128), np.float32)
    qp[:, :D] = world["q"]
    q_rot_j = jnp.asarray(qp) @ j.rotation
    jv, ji = jivf_pq._ivfpq_search_block(
        q_rot_j, j.centroids, j.codebooks, j.codes, j.slot_ids, k, nprobe, j.m,
        backend="jnp" if backend == "auto" else "pallas", fills=j.fills())
    q_rot = torch.from_numpy(np.array(q_rot_j))
    args = (q_rot, t.centroids, t.codebooks, t.codes, t.slot_ids, k, nprobe, t.m)
    tv, ti = ivf_pq._ivfpq_search_block(*args, backend=backend)
    cv, ci = ivf_pq._ivfpq_search_block(*args, backend=backend, terms=t.coarse_terms(),
                                        fills=t.fills())
    np.testing.assert_array_equal(tv.numpy(), cv.numpy())
    np.testing.assert_array_equal(ti.numpy(), ci.numpy())
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    if backend == "auto":
        assert np.mean(ti == ji) >= 0.99
        np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=0)
    else:
        _assert_overlap(ti, ji, 0.9)
        np.testing.assert_allclose(tv, jv, atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ivf_pq._ivfpq_search_block(*args, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_tables_cuda(q_rot, torch.zeros((B, nprobe), dtype=torch.int32),
                                 t.centroids, t.codebooks, t.fills())


def test_coarse_terms_cached_and_probes_unchanged(world):
    """The cached ||c||^2 and live-list mask give bit-equal probes."""
    t = _port_of(world["j"])
    sids = t.slot_ids.clone()
    sids[3] = -1                                                  # an empty list
    t = IVFPQIndex(rotation=t.rotation, centroids=t.centroids, codebooks=t.codebooks,
                   codes=t.codes, slot_ids=sids, n=t.n, d=t.d, m=t.m)
    assert t.coarse_terms() is t.coarse_terms()
    c2, live = t.coarse_terms()
    assert tuple(c2.shape) == (1, NLIST) and not bool(live[0, 3]) and int(live.sum()) == NLIST - 1
    q = torch.from_numpy(np.random.default_rng(6).standard_normal((B, 128)).astype(np.float32))
    before = ivf_flat._coarse_probes(q, t.centroids, t.slot_ids, 6)
    after = ivf_flat._coarse_probes(q, t.centroids, t.slot_ids, 6, terms=t.coarse_terms())
    assert before.dtype == torch.int64
    np.testing.assert_array_equal(before.numpy(), after.numpy())
    assert not bool((after == 3).any())


def test_scan_plan_fits_shared_memory():
    """The ring plan of the ADC scan: two stages of whole lists at the
    flagship shape, narrower tiles or one stage as k and M grow, an error
    when one table cannot fit."""
    assert adc_scan.scan_plan(100, 96, 640) == (2, 640)
    stages, tile = adc_scan.scan_plan(1024, 96, 640)
    assert stages == 2 and tile % 128 == 0 and tile < 640
    assert adc_scan.scan_plan(10, 16, 256) == (2, 256)
    assert adc_scan.scan_plan(100, 192, 640)[0] == 1
    for k, m, lcap in [(100, 96, 640), (1024, 96, 640), (100, 192, 640), (1024, 8, 2048)]:
        stages, tile = adc_scan.scan_plan(k, m, lcap)
        cap = 1024 if k <= 512 else 2048
        assert cap * 8 + stages * (m * 512 + m * tile) <= 227 * 1024 - 1024
    with pytest.raises(ValueError, match="shared memory"):
        adc_scan.scan_plan(10, 400, 640)


def _record_adc_routes(monkeypatch):
    """Record each plain ADC route called: "fused"
    (``adc_fused_keys_reference``), "key", "gather" (the key mode's plain
    scan over ``codes``, or over the gathered slab), "fused_dma"
    (``adc_fused_topk_reference``) and "dma" (the staged route's plain scan)."""
    calls = []
    real_fused = adc_scan.adc_fused_keys_reference
    real_fused_dma = adc_scan.adc_fused_topk_reference
    real_keys, real_dma = adc_scan.adc_topk_keys_reference, adc_scan.adc_topk_reference
    monkeypatch.setattr(adc_scan, "adc_fused_keys_reference",
                        lambda *a, **kw: calls.append("fused") or real_fused(*a, **kw))
    monkeypatch.setattr(adc_scan, "adc_fused_topk_reference",
                        lambda *a, **kw: calls.append("fused_dma") or real_fused_dma(*a, **kw))
    monkeypatch.setattr(adc_scan, "adc_topk_keys_reference",
                        lambda *a, **kw: calls.append("gather" if kw.get("gathered") else "key")
                        or real_keys(*a, **kw))
    monkeypatch.setattr(adc_scan, "adc_topk_reference",
                        lambda *a, **kw: calls.append("dma") or real_dma(*a, **kw))
    return calls


def _queries(world, b, seed):
    """b padded queries near rows of the corpus (seeded)."""
    rng = np.random.default_rng(seed)
    rows = world["base"][rng.choice(N, b, replace=False)]
    qp = np.zeros((b, 128), np.float32)
    qp[:, :D] = rows + 0.05 * rng.standard_normal(rows.shape).astype(np.float32)
    return qp


GATHER_NPROBE = 6      # not a multiple of the Pallas kernel's 4 lists a grid step


@pytest.mark.parametrize("kk", [10, 100])
@pytest.mark.parametrize("b", [1, 5, 16])
def test_gather_mode_reads_lists_in_place(world, monkeypatch, b, kk):
    """The torch path's gather mode is the fused plain version (no code
    slab), bit for bit the key mode's values and ids and the plain scan
    over the gathered slab on the same probes."""
    t = _port_of(world["j"])
    qp = torch.from_numpy(_queries(world, b, seed=b * 7 + kk))
    calls = _record_adc_routes(monkeypatch)
    gv, gi = t.search_device(qp, kk, GATHER_NPROBE, backend="torch", ids_mode="gather")
    assert calls == ["fused", "key"]
    calls.clear()
    kv, ki = t.search_device(qp, kk, GATHER_NPROBE, backend="torch", ids_mode="key")
    assert calls == ["fused", "key"]
    calls.clear()
    q_rot = ivf_pq._matmul(qp, t.rotation) if t.rotation is not None else qp
    probes = ivf_flat._coarse_probes(q_rot, t.centroids, t.slot_ids, GATHER_NPROBE,
                                     terms=t.coarse_terms())
    fills = adc_scan.list_fills(t.slot_ids)
    lut = adc_scan.adc_tables_reference(q_rot, probes, t.centroids, t.codebooks, fills)
    sv, si = adc_scan.adc_topk_keys_reference(lut, probes, adc_scan.gather_codes(t.codes, probes),
                                              t.slot_ids, kk, fills=fills, gathered=True)
    assert tuple(gv.shape) == tuple(gi.shape) == (b, kk)
    for v, i in ((kv, ki), (sv, si)):
        assert torch.equal(gv, v) and torch.equal(gi, i)
    assert bool((gi >= 0).all())


def _bf16_ordered(x):
    """Truncated f32 scores as ordered integers of their 16 high bits."""
    bits = x.astype(np.float32).view(np.int32).astype(np.int64) >> 16
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


@pytest.mark.parametrize("kk", [10, 100])
def test_gather_mode_matches_jax_pallas(world, kk):
    """``search_device(ids_mode="gather")`` on the torch path (the fused
    plain version) against the JAX ``search_device(ids_mode="gather")``, its
    Pallas gather kernel in interpret mode, on the same index and queries at
    an nprobe the Pallas kernel pads to its grid step. Tolerance, as the key
    tests state it: the tables are computed by another product and the
    Pallas kernel sums them in another order, so a truncated score may sit
    one bf16 step off: sorted values within one bf16 step, ids shared at >=
    0.95 kk per row, live positions equal."""
    j = world["j"]
    t = _port_of(j)
    qp = _queries(world, B, seed=kk)
    jv, ji = j.search_device(jnp.asarray(qp), kk, GATHER_NPROBE, backend="pallas",
                             ids_mode="gather")
    tv, ti = t.search_device(torch.from_numpy(qp), kk, GATHER_NPROBE, backend="torch",
                             ids_mode="gather")
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    assert ((ti >= 0) == (ji >= 0)).all()
    for a, c in zip(ti, ji):
        assert len(set(a.tolist()) & set(c.tolist())) >= int(0.95 * kk)
    steps = np.abs(_bf16_ordered(np.sort(tv, 1)) - _bf16_ordered(np.sort(jv, 1)))
    assert steps[np.sort(ti >= 0, 1)].max() <= 1


@pytest.mark.parametrize("mode", ["key", "gather"])
def test_key_modes_run(world, mode):
    """The key and gather modes run on the torch path: the same candidates
    as the plain key version on the same tables, ids from the index."""
    t = _port_of(world["j"])
    qp = torch.zeros((B, 128))
    qp[:, :D] = torch.from_numpy(world["q"])
    v, i = t.search_device(qp, 20, 8, backend="torch", ids_mode=mode)
    kv, ki = t.search_device(qp, 20, 8, backend="torch", ids_mode="key")
    assert torch.equal(v, kv) and torch.equal(i, ki)
    dv, di = t.search_device(qp, 20, 8, backend="torch", ids_mode="dma")
    _assert_overlap(i.numpy(), di.numpy(), 0.9)
    # every value is a bf16-truncated score: its low 16 bits are clear
    assert not bool((v.view(torch.int32) & 0xFFFF).any())


def test_ids_mode_resolution_and_guard(world, monkeypatch):
    """``search_device`` picks the mode as the JAX package does: the
    index's ``ids_mode()`` (key on a prefix-packed, replicas 1 index) for
    refine candidates (``refine_k > 0`` or ``for_refine``), else dma; an
    explicit mode wins; key and gather on an index whose auto mode is dma
    raise the JAX package's ValueError; the oracle path ignores the mode."""
    t = _port_of(world["j"])
    assert t.ids_mode() == "key" == world["j"].ids_mode()
    calls = _record_adc_routes(monkeypatch)
    qp = torch.zeros((2, 128))
    qp[:, :D] = torch.from_numpy(world["q"][:2])
    store = world["store"]
    t.search_device(qp, 10, 4, backend="torch")
    t.search_device(qp, 10, 4, backend="torch", for_refine=True)
    t.search_device(qp, 10, 4, refine_k=20, refine_store=store, backend="torch")
    t.search_device(qp, 10, 4, refine_k=20, refine_store=store, backend="torch",
                    ids_mode="dma")
    t.search_device(qp, 10, 4, backend="torch", ids_mode="gather")
    # the fused key plain version runs the key mode's plain scan on its
    # tables; the gather mode reads the lists in place; the dma mode is the
    # fused dma plain version
    assert calls == ["fused_dma", "fused", "key", "fused", "key", "fused_dma", "fused", "key"]
    calls.clear()
    t.search_device(qp, 10, 4, refine_k=20, refine_store=store, ids_mode="key")
    assert calls == []                                   # auto on the CPU: the jnp path
    with pytest.raises(ValueError, match="must be 'dma', 'key' or 'gather'"):
        t.search_device(qp, 10, 4, ids_mode="slots")
    j = world["j"]
    rep = IVFPQIndex.from_reference(
        np.asarray(j.rotation), np.asarray(j.centroids), np.asarray(j.codebooks),
        np.asarray(j.codes), np.asarray(j.slot_ids), j.n, j.d, j.m, replicas=2,
        device="cpu")
    assert rep.ids_mode() == "dma"
    for mode in ("key", "gather"):
        with pytest.raises(ValueError, match="requires a prefix-packed index with "
                                             "replicas == 1"):
            rep.search_device(qp, 10, 4, ids_mode=mode)
    holes = np.asarray(j.slot_ids).copy()
    live = np.nonzero(holes[0] >= 0)[0]
    holes[0, live[0]] = -1                               # an interior hole
    holed = IVFPQIndex.from_reference(
        np.asarray(j.rotation), np.asarray(j.centroids), np.asarray(j.codebooks),
        np.asarray(j.codes), holes, j.n, j.d, j.m, device="cpu")
    assert holed.ids_mode() == "dma"
    with pytest.raises(ValueError, match="auto mode 'dma'"):
        holed.search_device(qp, 10, 4, ids_mode="key")


def test_refine_key_path_matches_jax_pallas(world):
    """End to end: ``search_device(backend="torch", refine_k > 0)`` (key-mode
    candidates, then the refine) against the JAX ``search_device`` with its
    Pallas kernels in interpret mode (key mode too) on the same index:
    the final ids equal except where two rows tie on their exact score."""
    j = world["j"]
    t = _port_of(j)
    qp = np.zeros((B, 128), np.float32)
    qp[:, :D] = world["q"]
    jv, ji = j.search_device(jnp.asarray(qp), 10, 8, refine_k=40,
                             refine_store=_JStore(world["base"]), backend="pallas")
    tv, ti = t.search_device(torch.from_numpy(qp), 10, 8, refine_k=40,
                             refine_store=world["store"], backend="torch")
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    differ = ti != ji
    assert np.mean(differ) <= 0.05
    for b, r in zip(*np.nonzero(differ)):        # a swap only where scores tie
        assert abs(tv[b, r] - jv[b, r]) <= 1e-5
