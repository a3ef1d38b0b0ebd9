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
  refined result is the JAX ``search_device``'s."""

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
