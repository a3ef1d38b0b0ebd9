"""IVF-Flat parity of the PyTorch port against ``nvdb_tpu.index.ivf_flat`` at
the sizes of test_ivf.py or smaller (6000 x 64, Dp 128, nlist 32, B 8): the
plain version of the probe kernel against ``pallas_ivf_probe_topk`` in
interpret mode, ``_ivf_search_block`` against JAX's, JAX-built indexes saved
and loaded by the port (and back), indexes carried across with
``from_reference`` and searched by both packages, and the port's own build.

Tolerances. Values: 1e-5 abs + 1e-5 rel (f32 sums in another order). Ids:
the Pallas kernel gives ties to the larger id, ``lax.top_k`` to the lower
index, so ids are judged by float64 score regret <= 1e-5 over the effective
inputs (the bf16-rounded query and the widened slab where the path rounds),
and carried-across searches by >= 99% equal ids. Builds draw other random
numbers than JAX: recall@10 within 0.02 of the JAX-built index's, with the
invariants exact (every row packed once, the payload equal to the row's
encoding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.index import ivf_flat as jivf_flat
from nvdb_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex
from nvdb_tpu.kernels.ivf_scan import pallas_ivf_probe_topk
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index import ivf_flat
from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex
from nvdb_tpu_torch.kernels import dispatch, ivf_scan

N, D, DP, NLIST, B = 6000, 64, 128, 32, 8
DTYPES = ["f32", "bf16", "i8"]
ATOL = RTOL = 1e-5
REGRET_TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    base = jsynth.low_rank(N, D, intrinsic=16, n_clusters=32, spread=0.5, seed=51)
    queries, _ = jsynth.sample_queries(base, B, seed=52, perturb=0.05)
    qp = np.zeros((B, DP), np.float32)
    qp[:, :D] = queries
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    gt = np.argsort(-s64, axis=1, kind="stable")[:, :10]
    js = {dt: JIVFFlatIndex.build(base, nlist=NLIST, dtype=dt, n_iters=6, seed=1)
          for dt in DTYPES}
    return dict(base=base, q=queries, qp=qp, gt=gt, j=js)


def _port_of(j):
    return IVFFlatIndex.from_reference(
        np.asarray(j.centroids), np.asarray(j.packed), np.asarray(j.slot_ids),
        None if j.slot_scales is None else np.asarray(j.slot_scales),
        j.n, j.d, j.dtype_code, n_spilled=j.n_spilled, device="cpu")


def _recall(ids, gt):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def _effective(q, packed, slot_scales):
    """float64 (queries, slabs) as the kernel's path sees them."""
    slabs = packed.to(torch.float64)
    if packed.dtype == torch.float32:
        return q.to(torch.float64), slabs
    if slot_scales is not None:
        slabs = slabs * slot_scales.to(torch.float64)[:, :, None]
    return q.to(torch.bfloat16).to(torch.float64), slabs


def _regret(q, probes, packed, slot_ids, slot_scales, ids, k):
    """Worst float64 score regret of ``ids`` against the exact top-k over
    each query's live probed slots."""
    q64, slabs = _effective(q, packed, slot_scales)
    worst = 0.0
    for b in range(q.shape[0]):
        score = {}
        for p in probes[b].tolist():
            if not 0 <= p < slot_ids.shape[0]:
                continue
            s = (slabs[p] @ q64[b]).numpy()
            for sid, v in zip(slot_ids[p].tolist(), s.tolist()):
                if sid >= 0:
                    score[sid] = v
        ref = sorted(score.values(), reverse=True)[:k]
        got = sorted((score[i] for i in ids[b].tolist() if i >= 0), reverse=True)
        assert len(got) == len(ref)
        worst = max(worst, max((r - g for r, g in zip(ref, got)), default=0.0))
    return worst


def _check_probe(q, probes, packed, slot_ids, slot_scales, k, tv, ti, pv, pi):
    """The plain probe (tv, ti) against the Pallas kernel (pv, pi)."""
    tv, ti, pv, pi = tv.numpy(), ti.numpy(), np.asarray(pv), np.asarray(pi)
    assert ((ti >= 0) == (pi >= 0)).all()
    assert np.isneginf(tv[ti < 0]).all()
    np.testing.assert_allclose(tv, pv, atol=ATOL, rtol=RTOL)
    assert _regret(q, probes, packed, slot_ids, slot_scales, ti, k) <= REGRET_TOL
    assert _regret(q, probes, packed, slot_ids, slot_scales, pi, k) <= REGRET_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nprobe,k", [(6, 10), (2, 128)])
def test_probe_reference_matches_pallas(world, dtype, nprobe, k):
    j = world["j"][dtype]
    t = _port_of(j)
    q = torch.from_numpy(world["qp"])
    probes = jivf_flat._coarse_probes(jnp.asarray(world["qp"]), j.centroids, j.slot_ids,
                                      nprobe)
    pv, pi = pallas_ivf_probe_topk(jnp.asarray(world["qp"]), probes, j.packed, j.slot_ids,
                                   j.slot_scales, k, interpret=True)
    probes = torch.from_numpy(np.array(probes))
    tv, ti = ivf_scan.ivf_probe_topk_reference(q, probes, t.packed, t.slot_ids,
                                               t.slot_scales, k, q_chunk=3)
    _check_probe(q, probes, t.packed, t.slot_ids, t.slot_scales, k, tv, ti, pv, pi)


def _ragged_index(dtype, seed, nlist=12, lcap=64):
    """A random packed index whose lists are full, partly filled with holes,
    filled below k, or dead (every slot -1)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((nlist * lcap, DP)).astype(np.float32)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        f = lcap if li % 3 == 0 else int(rng.integers(0, lcap))
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[1] = -1                     # dead
    slot_ids[2, 3:] = -1                 # three live slots
    slot_ids[4, ::5] = -1                # holes
    scales = None
    if dtype == "f32":
        enc = rows
    elif dtype == "bf16":
        enc = jvecbin.to_bf16(rows)
    else:
        enc, scales = jvecbin.quantize_i8(rows)
        scales = scales.reshape(nlist, lcap)
    packed = np.asarray(enc).reshape(nlist, lcap, DP)
    q = rng.standard_normal((5, DP)).astype(np.float32)
    # distinct probes per query, as the coarse ranking gives: lists 1 and 2
    # first, then two of the others
    others = np.arange(3, nlist)
    probes = np.stack([np.r_[1, 2, rng.choice(others, 2, replace=False)] for _ in range(5)])
    return q, probes.astype(np.int32), packed, slot_ids, scales


@pytest.mark.parametrize("dtype", DTYPES)
def test_probe_reference_dead_and_short_lists_match_pallas(dtype):
    q, probes, packed, slot_ids, scales = _ragged_index(dtype, seed=len(dtype))
    k = 100
    pv, pi = pallas_ivf_probe_topk(jnp.asarray(q), jnp.asarray(probes), jnp.asarray(packed),
                                   jnp.asarray(slot_ids),
                                   None if scales is None else jnp.asarray(scales), k,
                                   interpret=True)
    code = vecbin.dtype_code(dtype)
    tq, tp = torch.from_numpy(q), torch.from_numpy(probes)
    tpk = ivf_flat._payload_tensor(packed, code)
    tsi = torch.from_numpy(slot_ids)
    tsc = None if scales is None else torch.from_numpy(scales)
    tv, ti = ivf_scan.ivf_probe_topk_reference(tq, tp, tpk, tsi, tsc, k)
    _check_probe(tq, tp, tpk, tsi, tsc, k, tv, ti, pv, pi)
    # a probe id outside [0, nlist) is an empty list in the plain version
    tp2 = tp.clone()
    tp2[:, 3] = -1
    tp2[0, 2] = 10 ** 6
    tv2, ti2 = ivf_scan.ivf_probe_topk_reference(tq, tp2, tpk, tsi, tsc, k)
    assert _regret(tq, tp2, tpk, tsi, tsc, ti2.numpy(), k) <= REGRET_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_search_block_matches_jax(world, dtype, backend):
    j = world["j"][dtype]
    t = _port_of(j)
    jv, ji = jivf_flat._ivf_search_block(jnp.asarray(world["qp"]), j.centroids, j.packed,
                                         j.slot_ids, j.slot_scales, 10, 6)
    tv, ti = ivf_flat._ivf_search_block(torch.from_numpy(world["qp"]), t.centroids,
                                        t.packed, t.slot_ids, t.slot_scales, 10, 6,
                                        backend=backend)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
    probes = ivf_flat._coarse_probes(torch.from_numpy(world["qp"]), t.centroids,
                                     t.slot_ids, 6)
    q = torch.from_numpy(world["qp"])
    for ids in (ti.numpy(), np.asarray(ji)):
        assert _regret(q, probes, t.packed, t.slot_ids, t.slot_scales, ids, 10) <= REGRET_TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_load_jax_index(world, dtype, tmp_path):
    j = world["j"][dtype]
    path = str(tmp_path / "j.npz")
    j.save(path)
    t = IVFFlatIndex.load(path, device="cpu")
    for name in ("centroids", "slot_ids"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    jp = np.asarray(j.packed)
    if dtype == "bf16":
        np.testing.assert_array_equal(t.packed.view(torch.int16).numpy().view(np.uint16),
                                      jp.view(np.uint16))
    else:
        np.testing.assert_array_equal(t.packed.numpy(), jp)
    if dtype == "i8":
        np.testing.assert_array_equal(t.slot_scales.numpy(), np.asarray(j.slot_scales))
    else:
        assert t.slot_scales is None
    assert (t.n, t.d, t.dtype_code, t.n_spilled) == (j.n, j.d, j.dtype_code, j.n_spilled)
    assert (t.nlist, t.lcap, t.index_bytes) == (j.nlist, j.lcap, j.index_bytes)
    _, ti = t.search(world["q"], 10, 6)
    _, ji = j.search(world["q"], 10, 6)
    assert np.mean(ti == ji) >= 0.99


@pytest.mark.parametrize("dtype", DTYPES)
def test_save_round_trip_loads_in_jax(world, dtype, tmp_path):
    j = world["j"][dtype]
    t = _port_of(j)
    path = str(tmp_path / "t.npz")
    t.save(path)
    back = JIVFFlatIndex.load(path)
    for name in ("centroids", "packed", "slot_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(j, name)))
    assert (back.n, back.d, back.dtype_code, back.n_spilled) == (j.n, j.d, j.dtype_code,
                                                                 j.n_spilled)
    _, bi = back.search(world["q"], 10, 6)
    _, ji = j.search(world["q"], 10, 6)
    np.testing.assert_array_equal(bi, ji)


@pytest.mark.parametrize("dtype", DTYPES)
def test_from_reference_search_matches_jax(world, dtype):
    j = world["j"][dtype]
    t = _port_of(j)
    jv, ji = j.search(world["q"], 10, 8)
    for backend in ("auto", "torch"):
        tv, ti = t.search(world["q"], 10, 8, q_chunk=3, backend=backend)
        assert tv.shape == (B, 10) and ti.dtype == np.int64
        assert np.mean(ti == ji) >= 0.99
        np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=RTOL)
    # the device path returns the index's device tensors
    dv, di = t.search_device(torch.from_numpy(world["qp"]), 10, 8)
    assert di.dtype == torch.int32 and dv.dtype == torch.float32


def test_nprobe_beyond_live_lists_matches_jax(world):
    """With nprobe above the live list count the coarse ranking must pick
    dead lists (all slots -1); both packages then return every live row."""
    j = world["j"]["bf16"]
    sids = np.array(j.slot_ids)
    sids[NLIST // 2:] = -1                       # half the lists dead
    jd = JIVFFlatIndex(centroids=j.centroids, packed=j.packed,
                       slot_ids=jnp.asarray(sids), slot_scales=None, n=j.n, d=j.d,
                       dtype_code=j.dtype_code)
    t = _port_of(jd)
    jv, ji = jd.search(world["q"], 10, NLIST)
    for backend in ("auto", "torch"):
        tv, ti = t.search(world["q"], 10, NLIST, backend=backend)
        np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=RTOL)
        assert np.mean(ti == ji) >= 0.99
    live = set(sids[sids >= 0].tolist())
    assert set(ti.ravel().tolist()) <= live


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_build_recall_near_jax(world, dtype):
    base = world["base"]
    t = IVFFlatIndex.build(base, nlist=NLIST, dtype=dtype, n_iters=6, seed=1, device="cpu")
    j = world["j"][dtype]
    assert (t.nlist, t.lcap, t.packed.shape[2]) == (j.nlist, j.lcap, DP)
    assert t.packed.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                              "i8": torch.int8}[dtype]
    sids = t.slot_ids.numpy()
    li, si = np.nonzero(sids >= 0)
    rows = sids[li, si]
    assert sorted(rows.tolist()) == list(range(N))           # every row packed once
    # the payload of each slot is its row's encoding, padding zero
    if dtype == "bf16":
        got = t.packed.view(torch.int16).numpy().view(np.uint16)[li, si, :D]
        np.testing.assert_array_equal(got, jvecbin.to_bf16(base).view(np.uint16)[rows])
    elif dtype == "i8":
        codes, sc = jvecbin.quantize_i8(base)
        np.testing.assert_array_equal(t.packed.numpy()[li, si, :D], codes[rows])
        np.testing.assert_array_equal(t.slot_scales.numpy()[li, si], sc[rows])
    else:
        np.testing.assert_array_equal(t.packed.numpy()[li, si, :D], base[rows])
    assert not t.packed.to(torch.float32).numpy()[:, :, D:].any()
    assert not t.packed.to(torch.float32).numpy()[sids < 0].any()
    _, ti = t.search(world["q"], 10, 4)
    _, ji = j.search(world["q"], 10, 4)
    assert _recall(ti, world["gt"]) >= _recall(ji, world["gt"]) - 0.02


def test_corpus_refine_build_and_repack(world):
    """The build options that raised before the build side was ported:
    ``corpus_refine_iters`` packs every row once, and ``repack`` of a
    carried-across index equals the JAX package's repack bit for bit."""
    r = IVFFlatIndex.build(world["base"][:500], nlist=4, corpus_refine_iters=1,
                           device="cpu")
    live = r.slot_ids.numpy()
    assert sorted(live[live >= 0].tolist()) == list(range(500))
    j = world["j"]["f32"]
    got = IVFFlatIndex.repack(_port_of(j), world["base"])
    want = JIVFFlatIndex.repack(j, world["base"])
    assert (got.lcap, got.n_spilled) == (want.lcap, want.n_spilled)
    np.testing.assert_array_equal(got.slot_ids.numpy(), np.asarray(want.slot_ids))
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))


def test_cuda_paths_raise_on_cpu(world):
    """The kernel wrapper and ``backend='cuda'`` never run the plain version
    on a CPU tensor."""
    t = _port_of(world["j"]["bf16"])
    q = torch.from_numpy(world["qp"])
    probes = torch.zeros((B, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ivf_scan.ivf_probe_topk_cuda(q, probes, t.packed, t.slot_ids, None, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.ivf_probe_topk(q, probes, t.packed, t.slot_ids, None, 10, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t.search_device(q, 10, 4, backend="cuda")
