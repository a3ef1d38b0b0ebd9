"""The fused ADC key scan's plain versions on the CPU (the CUDA kernel itself
runs in tests/test_torch_gpu.py and chip_smoke.py):

- ``adc_topk_keys_listmajor_reference``, the key mode walked as the kernel
  walks it (pairs grouped by list into items of at most q_chunk, each
  pair's partial top-k, the merge), is bit for bit
  ``adc_topk_keys_reference`` on the same tables;
- ``adc_fused_keys_reference`` against the JAX package's key path on the
  same numpy inputs: ``_coarse_probes``, the residuals, ``pq.adc_lut`` and
  the bf16 cast, then ``pallas_adc_topk(ids_mode="key")`` in interpret mode.
  The tables are computed by another product (XLA's einsum against the
  port's chains) and the Pallas kernel sums them in another order, so a
  truncated score may sit one bf16 step off: sorted values within one bf16
  step, ids shared at >= 0.95 k per row;
- ``IVFPQIndex.search_device`` on the CPU: the key mode's plain fused path
  and its two-step A/B give the same candidates bit for bit, and the
  refined result is the JAX ``search_device``'s;
- the fused dma scan's plain version, ``adc_fused_topk_reference`` (the
  pairs grouped by list, each (pair, tile)'s k best keys of distinct ids,
  the merge), bit for bit ``adc_topk_reference(adc_tables_reference(...))``
  on lists with holes below their fill, ids held by two lists and ids held
  twice by one list, against ``pallas_adc_topk(ids_mode="dma")`` in
  interpret mode on the same bf16 tables (the Pallas kernel sums the same
  f32 terms in another order: sorted values within 2e-6 relative, ids
  equal but where two scores sit within that of the k-th), and through
  ``search_device`` (ADC-only and a replicated index's refine) against the
  JAX ``search_device``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.index import ivf_flat as jivf_flat
from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from nvdb_tpu.kernels import adc_scan as jadc
from nvdb_tpu.kernels import pq as jpq
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.kernels import adc_scan
from nvdb_tpu_torch.store import VectorStore

NLIST, M, DSUB, LCAP = 10, 16, 8, 128
DP = M * DSUB


def _index(seed, b, p, hot=False, bad=False, fills=None):
    """Random prefix-packed lists with unique ids (list 3 dead), b queries of
    p distinct probes; ``hot``: every query probes list 5; ``bad``: two
    probes out of range."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (NLIST, M, LCAP)).astype(np.uint8)
    slot_ids = np.full((NLIST, LCAP), -1, np.int32)
    perm = rng.permutation(NLIST * LCAP).astype(np.int32)
    for li in range(NLIST):
        f = int(rng.integers(1, LCAP + 1)) if fills is None else fills[li]
        slot_ids[li, :f] = perm[li * LCAP:li * LCAP + f]
    slot_ids[3] = -1
    probes = np.stack([rng.choice(NLIST, p, replace=False) for _ in range(b)]).astype(np.int32)
    if hot:
        for r in range(b):
            rest = [x for x in probes[r] if x != 5][:p - 1]
            probes[r] = [5] + rest
    if bad:
        probes[0, 0] = -1
        probes[-1, -1] = NLIST + 2
    return codes, slot_ids, probes, rng


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("q_chunk", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 10, 100, 700])
def test_listmajor_reference_is_the_key_reference(q_chunk, k):
    """Every query probes list 5, which splits into ceil(B / q_chunk) items;
    a dead list and out-of-range probes drop their pairs; k = 700 is above
    most queries' live lanes, k = 1 keeps one key a pair."""
    codes, slot_ids, probes, rng = _index(1, 12, 5, hot=True, bad=True)
    lut = torch.from_numpy(rng.standard_normal((12, 5, M, 256)).astype(np.float32))
    codes, slot_ids, probes = _t(codes, slot_ids, probes)
    want = adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, k)
    got = adc_scan.adc_topk_keys_listmajor_reference(lut, probes, codes, slot_ids, k,
                                                     q_chunk=q_chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_listmajor_reference_ties_and_scarce_lists():
    """Tables of small integers make truncated scores tie, so the order
    rests on the coordinate; lists of a few rows leave fewer candidates
    than k."""
    fills = [3, 1, 2, 0, 5, 1, 4, 2, 1, 3]
    codes, slot_ids, probes, rng = _index(2, 9, 6, hot=True, fills=fills)
    lut = torch.from_numpy(rng.integers(0, 3, (9, 6, M, 256)).astype(np.float32))
    codes, slot_ids, probes = _t(codes, slot_ids, probes)
    for k in (4, 50):
        want = adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, k)
        got = adc_scan.adc_topk_keys_listmajor_reference(lut, probes, codes, slot_ids, k,
                                                         q_chunk=4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1][:, -1] == -1).all()) and bool(torch.isneginf(got[0][:, -1]).all())


def _geometry(rng, b):
    cents = rng.standard_normal((NLIST, DP)).astype(np.float32)
    near = rng.integers(0, NLIST, b)
    q_rot = (cents[near] + 0.3 * rng.standard_normal((b, DP))).astype(np.float32)
    codebooks = (0.5 * rng.standard_normal((M, 256, DSUB))).astype(np.float32)
    return q_rot, cents, codebooks


@pytest.mark.parametrize("q_chunk", [1, 8])
def test_listmajor_reference_on_the_plain_tables(q_chunk):
    """On the tables the fused scans build (``adc_tables_reference``: the
    query's, the list's and the pair's shares of each entry), the list-major
    walk is the key reference bit for bit, dead and out-of-range probes
    included."""
    codes, slot_ids, probes, rng = _index(6, 10, 5, hot=True, bad=True)
    q_rot, cents, codebooks = _geometry(rng, 10)
    codes, slot_ids, probes, q_rot, cents, codebooks = _t(codes, slot_ids, probes, q_rot,
                                                          cents, codebooks)
    fills = adc_scan.list_fills(slot_ids)
    lut = adc_scan.adc_tables_reference(q_rot, probes, cents, codebooks, fills)
    for k in (10, 300):
        want = adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, k, fills=fills)
        got = adc_scan.adc_topk_keys_listmajor_reference(lut, probes, codes, slot_ids, k,
                                                         fills=fills, q_chunk=q_chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [10, 100])
def test_fused_reference_matches_the_jax_key_path(k):
    b, p = 4, 6
    codes, slot_ids, _, rng = _index(3, b, p)
    q_rot, cents, codebooks = _geometry(rng, b)
    # the JAX package's block: coarse probes, residuals, f32 tables, bf16,
    # the Pallas key kernel in interpret mode
    jq = jnp.asarray(q_rot)
    probes = jivf_flat._coarse_probes(jq, jnp.asarray(cents), jnp.asarray(slot_ids), p)
    res = jq[:, None, :] - jnp.take(jnp.asarray(cents), probes, axis=0)
    lut = jpq.adc_lut(res.reshape(b * p, -1), jnp.asarray(codebooks), M)
    jv, ji = jadc.pallas_adc_topk(lut.astype(jnp.bfloat16).reshape(b, p, M, 16, 16), probes,
                                  jnp.asarray(codes), jnp.asarray(slot_ids), k,
                                  ids_mode="key", interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = adc_scan.adc_fused_keys_reference(*_t(q_rot, np.array(probes), cents,
                                                   codebooks, codes, slot_ids), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert ((ti >= 0) == (ji >= 0)).all()
    for a, c in zip(ti, ji):
        assert len(set(a.tolist()) & set(c.tolist())) >= int(0.95 * k)

    def ordered(x):
        bits = x.astype(np.float32).view(np.int32).astype(np.int64) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits)

    live = ti >= 0
    steps = np.abs(ordered(np.sort(tv, 1)) - ordered(np.sort(jv, 1)))
    assert steps[np.sort(live, 1)].max() <= 1
    # and the fused plain version is the two-step plain path bit for bit
    t = _t(q_rot, np.array(probes), cents, codebooks, codes, slot_ids)
    fills = adc_scan.list_fills(t[5])
    two = adc_scan.adc_topk_keys_reference(
        adc_scan.adc_tables_reference(t[0], t[1], t[2], t[3], fills), t[1], t[4], t[5], k)
    assert np.array_equal(two[0].numpy(), tv) and np.array_equal(two[1].numpy(), ti)


def test_fused_reference_dead_and_out_of_range_probes():
    """A dead list and out-of-range probes add no candidate and no table."""
    codes, slot_ids, probes, rng = _index(4, 5, 4, bad=True)
    probes[1, 1] = 3
    q_rot, cents, codebooks = _geometry(rng, 5)
    t = _t(q_rot, probes, cents, codebooks, codes, slot_ids)
    v, i = adc_scan.adc_fused_keys_reference(*t, 600)
    for b in range(5):
        lists = [li for li in probes[b] if 0 <= li < NLIST]
        want = set(slot_ids[lists][slot_ids[lists] >= 0].tolist())
        got = i[b][i[b] >= 0].tolist()
        assert set(got) == want and len(got) == len(want)


def test_fused_cuda_wrapper_refuses_cpu_tensors():
    codes, slot_ids, probes, rng = _index(5, 3, 2)
    q_rot, cents, codebooks = _geometry(rng, 3)
    t = _t(q_rot, probes, cents, codebooks, codes, slot_ids)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_fused_keys_cuda(*t, 10)


@pytest.fixture(scope="module")
def small_world():
    base = jsynth.low_rank(3000, 128, intrinsic=12, n_clusters=32, seed=7)
    j = JIVFPQIndex.build(base, nlist=8, m=16, use_opq=True, train_size=3000, seed=0)
    queries, _ = jsynth.sample_queries(base, 6, seed=8, perturb=0.02)
    t = IVFPQIndex.from_reference(
        np.asarray(j.rotation), np.asarray(j.centroids), np.asarray(j.codebooks),
        np.asarray(j.codes), np.asarray(j.slot_ids), j.n, j.d, j.m, device="cpu")
    qp = np.zeros((6, 128), np.float32)
    qp[:, :] = queries
    return dict(base=base, j=j, t=t, qp=qp)


def test_search_device_key_scan_fused_is_the_tables_a_b(small_world):
    """The torch path's key mode through the fused plain version and
    through its two-step A/B: the same candidates bit for bit."""
    t, qp = small_world["t"], torch.from_numpy(small_world["qp"])
    assert t.ids_mode() == "key"
    a = t.search_device(qp, 30, 4, backend="torch", for_refine=True)
    b = t.search_device(qp, 30, 4, backend="torch", for_refine=True, key_scan="tables")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="key_scan"):
        t.search_device(qp, 30, 4, backend="torch", for_refine=True, key_scan="lut")


def test_search_device_on_the_cpu_matches_jax(small_world):
    """Refined results through the fused plain version against the JAX
    ``search_device`` (its Pallas kernels in interpret mode, key mode): ids
    equal except where two rows tie on their exact score."""

    class _JStore:
        vectors, scales = jnp.asarray(small_world["base"]), None

    j, t, qp = small_world["j"], small_world["t"], small_world["qp"]
    jv, ji = j.search_device(jnp.asarray(qp), 10, 4, refine_k=40, refine_store=_JStore(),
                             backend="pallas")
    store = VectorStore.from_numpy(small_world["base"], device="cpu")
    tv, ti = t.search_device(torch.from_numpy(qp), 10, 4, refine_k=40, refine_store=store,
                             backend="torch")
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    differ = ti != ji
    assert np.mean(differ) <= 0.05
    for b, r in zip(*np.nonzero(differ)):
        assert abs(tv[b, r] - jv[b, r]) <= 1e-5


# -- the fused dma scan --------------------------------------------------------

DMA_RTOL = 2e-6   # two f32 sums of 16 positive terms in two orders: 2 * 15 * 2^-24


def _dma_index(seed, b, p, kind):
    """``_index``'s lists with ``kind``: "holes" frees slots below lists'
    fills; "replicas" makes list 2 hold list 1's ids and lists 4, 5 and 6
    hold some of their own ids twice, list 5's copies with the same codes
    (two copies of a row in one list encode the same residual), and gives
    25 other rows of list 5 the codes of 25 more (tied scores); "scarce"
    keeps at most 5 rows a list; "bad" puts two probes out of range."""
    fills = [int(x) for x in np.random.default_rng(seed).integers(0, 6, NLIST)] \
        if kind == "scarce" else [LCAP if li % 3 == 0 else 40 + 8 * li for li in range(NLIST)]
    codes, slot_ids, probes, rng = _index(seed, b, p, hot=True, bad=kind == "bad", fills=fills)
    if kind in ("holes", "replicas", "bad"):
        slot_ids[5, 1::3] = -1
        slot_ids[6, :30:2] = -1
    if kind == "replicas":
        slot_ids[2] = slot_ids[1]
        slot_ids[4, 10:20] = slot_ids[4, 30:40]
        slot_ids[6, 1:30:2] = slot_ids[6, 31:60:2]
        slot_ids[5, :30] = slot_ids[5, 40:70]
        codes[5, :, :30] = codes[5, :, 40:70]
        codes[5, :, 70:95] = codes[5, :, 95:120]        # other ids: tied scores
    q_rot, cents, codebooks = _geometry(rng, b)
    return _t(q_rot, probes, cents, codebooks, codes, slot_ids)


def _two_step_dma(q_rot, probes, cents, codebooks, codes, slot_ids, k):
    """The staged route's plain versions, the plain tables then the plain dma
    scan; probes out of range go to the dead list 3 (the plain scan would
    index with them)."""
    fills = adc_scan.list_fills(slot_ids)
    probes = torch.where((probes >= 0) & (probes < NLIST), probes, 3)
    lut = adc_scan.adc_tables_reference(q_rot, probes, cents, codebooks, fills)
    return adc_scan.adc_topk_reference(lut, probes, codes, slot_ids, k), lut


def _assert_dma_result(v, i, k):
    for vr, ir in zip(v, i):
        live = ir[ir >= 0]
        assert len(set(live.tolist())) == len(live)                 # one slot an id
        n = len(live)
        assert bool((ir[n:] == -1).all()) and bool(torch.isneginf(vr[n:]).all())
        assert bool((vr[1:n] <= vr[:n - 1]).all())                  # score descending
    assert tuple(v.shape) == tuple(i.shape) == (i.shape[0], k)


@pytest.mark.parametrize("q_chunk", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 10, 100, 700])
def test_fused_dma_reference_is_the_two_step_reference(q_chunk, k):
    """Every query probes list 5 (holes below its fill), so the list splits
    into ceil(B / q_chunk) items, taken in waves of a few items; list 2
    repeats list 1's ids and lists 4, 5 and 6 hold ids twice; k = 700 is
    above every query's live slots."""
    args = _dma_index(10 + k, 12, 5, "replicas")
    got = adc_scan.adc_fused_topk_reference(*args, k, q_chunk=q_chunk, wave_pairs=7)
    (want_v, want_i), _ = _two_step_dma(*args, k)
    assert torch.equal(got[0], want_v) and torch.equal(got[1], want_i)
    _assert_dma_result(*got, k)


@pytest.mark.parametrize("kind", ["packed", "holes", "bad", "scarce"])
def test_fused_dma_reference_edge_lists(kind):
    """Prefix-packed lists with unique ids (``dedup=False`` gives the same),
    holes, dead and out-of-range probes (which add nothing), and fewer live
    slots than k ((-inf, -1) after the real candidates)."""
    k = 100 if kind == "scarce" else 40
    args = _dma_index(20, 9, 6, kind)
    got = adc_scan.adc_fused_topk_reference(*args, k)
    (want_v, want_i), _ = _two_step_dma(*args, k)
    assert torch.equal(got[0], want_v) and torch.equal(got[1], want_i)
    _assert_dma_result(*got, k)
    if kind == "packed":
        plain = adc_scan.adc_fused_topk_reference(*args, k, dedup=False)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    if kind == "scarce":
        assert bool((got[1][:, -1] == -1).all())


@pytest.mark.parametrize("kind,k", [("packed", 10), ("holes", 100), ("replicas", 100),
                                    ("scarce", 100)])
def test_fused_dma_reference_matches_pallas_dma(kind, k):
    """Against ``pallas_adc_topk(ids_mode="dma")`` in interpret mode on the
    same bf16 tables (every probe in range): the Pallas kernel sums the same
    f32 terms in another order, so sorted values agree within DMA_RTOL and
    the ids above the k-th value's tie band are the same set."""
    q_rot, probes, cents, codebooks, codes, slot_ids = _dma_index(30, 4, 4, kind)
    (_, _), lut = _two_step_dma(q_rot, probes, cents, codebooks, codes, slot_ids, k)
    jv, ji = jadc.pallas_adc_topk(jnp.asarray(lut.float().numpy()).reshape(4, 4, M, 16, 16),
                                  jnp.asarray(probes.numpy()), jnp.asarray(codes.numpy()),
                                  jnp.asarray(slot_ids.numpy()), k, ids_mode="dma",
                                  interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = (x.numpy() for x in adc_scan.adc_fused_topk_reference(
        q_rot, probes, cents, codebooks, codes, slot_ids, k))
    assert ((ti >= 0) == (ji >= 0)).all()
    live = ti >= 0
    np.testing.assert_allclose(tv[live], jv[live], rtol=DMA_RTOL, atol=0)
    for a, av, c, cv in zip(ti, tv, ji, jv):
        n = int((a >= 0).sum())
        assert len(set(c[c >= 0].tolist())) == n                    # JAX keeps one slot an id
        if n == 0:
            continue
        band = abs(av[n - 1]) * DMA_RTOL
        above = lambda ids, vals: set(ids[:n][vals[:n] > av[n - 1] + band].tolist())
        assert above(a, av) == above(c, cv)


def test_tile_leads():
    """The first lane of the tile holding a repeated id, -1 elsewhere; the
    same id in another tile or another list is not repeated."""
    sids = torch.tensor([[5, 7, 5, -1, 5, 9, 7, 7], [1, 2, 3, 4, -1, -1, -1, -1]],
                        dtype=torch.int32)
    want = [[0, -1, 0, -1, -1, -1, 6, 6], [-1] * 8]
    assert adc_scan.tile_leads(sids, tile=4).tolist() == want
    assert adc_scan.tile_leads(sids).tolist() == [[0, 1, 0, -1, 0, -1, 1, 1], [-1] * 8]


def test_fused_dma_cuda_wrapper_refuses_cpu_tensors():
    args = _dma_index(5, 3, 2, "packed")
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_fused_topk_cuda(*args, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_fused_topk_cuda(*args, 10, dedup=False)


@pytest.mark.parametrize("replicas", [1, 2])
def test_search_device_dma_fused_is_the_tables_a_b(small_world, replicas):
    """The torch path's dma mode through the fused plain version and through
    the staged route's plain versions (``key_scan="tables"``): the same
    candidates bit for bit, on the index and on a replicated copy of it."""
    t, qp = small_world["t"], torch.from_numpy(small_world["qp"])
    if replicas > 1:
        j = JIVFPQIndex.repack(small_world["j"], small_world["base"], pad_factor=2.0,
                               replicas=2)
        t = IVFPQIndex.from_reference(
            np.asarray(j.rotation), np.asarray(j.centroids), np.asarray(j.codebooks),
            np.asarray(j.codes), np.asarray(j.slot_ids), j.n, j.d, j.m, replicas=2,
            device="cpu")
    a = t.search_device(qp, 30, 4, backend="torch", ids_mode="dma")
    b = t.search_device(qp, 30, 4, backend="torch", ids_mode="dma", key_scan="tables")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _assert_dma_result(*a, 30)


def test_search_device_adc_only_on_the_cpu_matches_jax(small_world):
    """``search_device(refine_k=0, backend="torch")`` (the dma mode through
    the fused plain version) against the JAX ``search_device`` (its Pallas
    dma kernel in interpret mode): the tables come from two products, so a
    rare entry sits one bf16 step off: ids shared at >= 0.9 k a row, values
    to 1e-3, as the JAX block's comparison states it (test_torch_ivfpq)."""
    j, t, qp = small_world["j"], small_world["t"], small_world["qp"]
    jv, ji = j.search_device(jnp.asarray(qp), 20, 4, backend="pallas")
    tv, ti = t.search_device(torch.from_numpy(qp), 20, 4, backend="torch")
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    for a, c in zip(ti, ji):
        assert len(set(a.tolist()) & set(c.tolist())) >= int(0.9 * 20)
    np.testing.assert_allclose(tv, jv, atol=1e-3, rtol=0)


def test_replicated_refine_on_the_cpu_matches_jax(small_world):
    """A replicated (R = 2) repack of the index, refined: the fused dma
    plain version's candidates hold no id twice, and the refined result is
    the JAX ``search_device``'s (Pallas dma kernel in interpret mode): ids
    equal except where two rows tie on their exact score."""

    class _JStore:
        vectors, scales = jnp.asarray(small_world["base"]), None

    j = JIVFPQIndex.repack(small_world["j"], small_world["base"], pad_factor=2.0, replicas=2)
    t = IVFPQIndex.from_reference(
        np.asarray(j.rotation), np.asarray(j.centroids), np.asarray(j.codebooks),
        np.asarray(j.codes), np.asarray(j.slot_ids), j.n, j.d, j.m, replicas=2, device="cpu")
    assert t.ids_mode() == "dma"
    qp = small_world["qp"]
    _assert_dma_result(*t.search_device(torch.from_numpy(qp), 40, 4, backend="torch"), 40)
    jv, ji = j.search_device(jnp.asarray(qp), 10, 4, refine_k=40, refine_store=_JStore(),
                             backend="pallas")
    store = VectorStore.from_numpy(small_world["base"], device="cpu")
    tv, ti = t.search_device(torch.from_numpy(qp), 10, 4, refine_k=40, refine_store=store,
                             backend="torch")
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    differ = ti != ji
    assert np.mean(differ) <= 0.05
    for b, r in zip(*np.nonzero(differ)):
        assert abs(tv[b, r] - jv[b, r]) <= 1e-5
