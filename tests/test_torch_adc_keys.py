"""The ADC key and gather modes of the PyTorch port against
``nvdb_tpu.kernels.adc_scan.pallas_adc_topk(ids_mode="key"/"gather")`` in
interpret mode, at m 16, Lcap 128, nlist 8 (the CUDA kernels themselves run
in tests/test_torch_gpu.py and chip_smoke.py).

Two cases of tables. Exact sums: entries are multiples of 1/64 in [-2, 2],
so every f32 sum of 16 of them is exact in any order and the Pallas
kernel's one-hot matmul and the port's in-order sum give the same score;
then the sorted values are bit-equal, and each returned id's score,
truncated to bf16, equals the value beside it. Random normal: the sums
differ in their last bits between the two orders, so a truncated score may
sit one bf16 step off; ids overlap at >= 0.95 per row, values within one
bf16 step. Ids are compared as sets: the JAX kernel breaks ties at the kk-th
truncated value otherwise (larger coordinate within a grid step, the
earlier step across steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.kernels import adc_scan as jadc
from nvdb_tpu_torch.kernels import adc_scan

M, LCAP, NLIST, B, P = 16, 128, 8, 4, 6


def _index(seed, fills=None):
    """Random prefix-packed lists (unique ids), one dead list (3)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (NLIST, M, LCAP)).astype(np.uint8)
    slot_ids = np.full((NLIST, LCAP), -1, np.int32)
    perm = rng.permutation(NLIST * LCAP).astype(np.int32)
    for li in range(NLIST):
        f = int(rng.integers(1, LCAP + 1)) if fills is None else fills[li]
        slot_ids[li, :f] = perm[li * LCAP:li * LCAP + f]
    if fills is None:
        slot_ids[3] = -1
    probes = np.stack([rng.choice(NLIST, P, replace=False) for _ in range(B)]).astype(np.int32)
    return codes, slot_ids, probes, rng


def _tables(rng, exact):
    if exact:
        return (rng.integers(-128, 129, (B, P, M, 256)) / 64.0).astype(np.float32)
    return rng.standard_normal((B, P, M, 256)).astype(np.float32)


def _pallas(lut, probes, codes, slot_ids, k, mode):
    v, i = jadc.pallas_adc_topk(jnp.asarray(lut.reshape(B, P, M, 16, 16)),
                                jnp.asarray(probes), jnp.asarray(codes),
                                jnp.asarray(slot_ids), k, ids_mode=mode, interpret=True)
    return np.asarray(v), np.asarray(i)


def _port(lut, probes, codes, slot_ids, k, mode):
    t = torch.from_numpy
    probes_t, codes_t = t(probes), t(codes)
    if mode == "gather":
        codes_t = adc_scan.gather_codes(codes_t, probes_t)
    v, i = adc_scan.adc_topk_keys_reference(t(lut), probes_t, codes_t, t(slot_ids), k,
                                            gathered=mode == "gather")
    return v.numpy(), i.numpy()


def _truncated_scores(lut, probes, codes, slot_ids):
    """{(b, id): the id's ADC score in float64, truncated to bf16}."""
    lut16 = torch.from_numpy(lut).to(torch.bfloat16).double().numpy()
    out = {}
    for b in range(B):
        for p, li in enumerate(probes[b]):
            for lane in np.nonzero(slot_ids[li] >= 0)[0]:
                s = -sum(lut16[b, p, m, codes[li, m, lane]] for m in range(M))
                bits = np.array([s + 0.0], np.float32).view(np.uint32) & 0xFFFF0000
                out[b, int(slot_ids[li, lane])] = float(bits.view(np.float32)[0])
    return out


def _bf16_steps(a, b):
    def ordered(x):
        bits = x.astype(np.float32).view(np.int32).astype(np.int64) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("k", [10, 200])
@pytest.mark.parametrize("mode", ["key", "gather"])
def test_exact_sums_match_pallas(mode, k):
    codes, slot_ids, probes, rng = _index(1)
    lut = _tables(rng, exact=True)
    pv, pi = _pallas(lut, probes, codes, slot_ids, k, mode)
    tv, ti = _port(lut, probes, codes, slot_ids, k, mode)
    np.testing.assert_array_equal(np.sort(tv, 1), np.sort(pv, 1))
    assert ((ti >= 0) == (pi >= 0)).all()
    assert (np.diff(tv, axis=1) <= 0).all()
    truth = _truncated_scores(lut, probes, codes, slot_ids)
    for b in range(B):
        for v, i in zip(tv[b], ti[b]):
            if i >= 0:
                assert truth[b, int(i)] == v
        live = ti[b][ti[b] >= 0]
        assert len(set(live.tolist())) == len(live)


@pytest.mark.parametrize("mode", ["key", "gather"])
def test_random_normal_matches_pallas(mode):
    codes, slot_ids, probes, rng = _index(2)
    lut = _tables(rng, exact=False)
    k = 100
    pv, pi = _pallas(lut, probes, codes, slot_ids, k, mode)
    tv, ti = _port(lut, probes, codes, slot_ids, k, mode)
    for a, b in zip(ti, pi):
        assert len(set(a.tolist()) & set(b.tolist())) >= int(0.95 * k)
    assert _bf16_steps(np.sort(tv, 1), np.sort(pv, 1)).max() <= 1


def test_scarce_candidates_fill_after_real_ones():
    """Fewer live candidates than k: the real ones first, then (-inf, -1),
    never a padding lane's coordinate (tests/test_adc_scan.py's case)."""
    fills = [0, 3, 0, 0, 2, 0, 0, 0]
    codes, slot_ids, probes, rng = _index(3, fills=fills)
    probes[:] = np.arange(P, dtype=np.int32)
    lut = _tables(rng, exact=True)
    for k in (10, 300):
        tv, ti = _port(lut, probes, codes, slot_ids, k, "key")
        pv, pi = _pallas(lut, probes, codes, slot_ids, k, "key")
        live = set(slot_ids[slot_ids >= 0].tolist())
        for b in range(B):
            assert set(ti[b, :5].tolist()) == live == set(pi[b, :5].tolist())
            assert (ti[b, 5:] == -1).all() and np.isneginf(tv[b, 5:]).all()
        np.testing.assert_array_equal(np.sort(tv, 1), np.sort(pv, 1))


def test_dead_lists_and_fills_below_k():
    """Dead lists, lists filled below k and probes out of range: only live
    lanes rank; the gather plain version equals the key one bit for bit."""
    fills = [0, 5, 128, 1, 0, 40, 7, 2]
    codes, slot_ids, probes, rng = _index(4, fills=fills)
    probes[0, :2] = [-1, NLIST]                    # out of range: no candidates
    lut = torch.from_numpy(_tables(rng, exact=False))
    args = (torch.from_numpy(probes), torch.from_numpy(codes), torch.from_numpy(slot_ids))
    v, i = adc_scan.adc_topk_keys_reference(lut, *args, 256)
    gv, gi = adc_scan.adc_topk_keys_reference(
        lut, args[0], adc_scan.gather_codes(args[1], args[0]), args[2], 256, gathered=True)
    assert torch.equal(v, gv) and torch.equal(i, gi)
    for b in range(B):
        lists = [li for li in probes[b] if 0 <= li < NLIST]
        want = set(slot_ids[lists][slot_ids[lists] >= 0].tolist())
        got = i[b][i[b] >= 0].tolist()
        assert set(got) == want and len(got) == len(want)


def test_truncation_and_tie_order():
    """One list of four lanes, every table entry 0 but the ones chosen:
    scores truncate toward zero, a zero score is +0, and equal truncated
    scores rank by coordinate, the larger first."""
    codes = torch.zeros((2, 1, 16), dtype=torch.uint8)
    codes[0, 0, :4] = torch.tensor([1, 2, 3, 4], dtype=torch.uint8)
    codes[1, 0, :2] = torch.tensor([1, 5], dtype=torch.uint8)
    slot_ids = torch.full((2, 16), -1, dtype=torch.int32)
    slot_ids[0, :4] = torch.tensor([10, 11, 12, 13])
    slot_ids[1, :2] = torch.tensor([20, 21])
    lut = torch.zeros((1, 2, 1, 256))
    lut[0, :, 0, 1] = 1.0
    lut[0, :, 0, 2] = 1.0078125        # 1 + 2^-7: a bf16 value
    lut[0, :, 0, 3] = 1.00390625       # 1 + 2^-8: the table's bf16 rounds it to 1.0
    lut[0, 0, 0, 4] = 0.0              # score exactly 0
    lut[0, 1, 0, 5] = 3.0
    v, i = adc_scan.adc_topk_keys_reference(lut, torch.tensor([[0, 1]]), codes, slot_ids, 6)
    # coordinates 0-3 (list 0) score -1, -1.0078125, -1, +0; coordinates 16
    # and 17 (list 1) score -1 and -3
    assert i.tolist() == [[13, 20, 12, 10, 11, 21]]
    assert v.tolist() == [[0.0, -1.0, -1.0, -1.0, -1.0078125, -3.0]]
    assert not torch.signbit(v[0, 0])
    with pytest.raises(ValueError, match="outside"):
        adc_scan.adc_topk_keys_reference(lut, torch.tensor([[0, 1]]), codes, slot_ids, 1025)


def test_truncation_is_toward_zero():
    """A score between two bf16 values keeps the one nearer zero."""
    codes = torch.zeros((1, 2, 16), dtype=torch.uint8)
    slot_ids = torch.full((1, 16), -1, dtype=torch.int32)
    slot_ids[0, 0] = 7
    lut = torch.zeros((1, 1, 2, 256))
    lut[0, 0, 0, 0] = 1.0
    lut[0, 0, 1, 0] = 2.0 ** -8        # sum 1.00390625: f32-exact, not a bf16 value
    v, i = adc_scan.adc_topk_keys_reference(lut, torch.tensor([[0]]), codes, slot_ids, 1)
    assert (v.item(), i.item()) == (-1.0, 7)


def test_key_groups_fit_16_bit_coordinates():
    assert adc_scan.key_groups(1, 64, 640) == 1          # 64 * 640 = 40960 lanes
    assert adc_scan.key_groups(1, 64, 2048) == 2         # 32 lists of 2048 per group
    assert adc_scan.key_groups(5, 64, 2048) == 5
    assert adc_scan.key_groups(1, 3, 65536) == 3
    assert adc_scan.key_groups(100, 7, 128) == 7         # never more groups than probes
    for s, p, lcap in [(1, 64, 640), (1, 100, 1024), (3, 64, 4096)]:
        g = adc_scan.key_groups(s, p, lcap)
        assert -(-p // g) * lcap <= adc_scan.COORD_SPAN
    with pytest.raises(ValueError, match="16-bit"):
        adc_scan.key_groups(1, 4, 65552)


def test_key_plan_and_cpu_refusal():
    """4-byte keys leave the ring room for wider tiles at deep kk; the
    wrapper raises on CPU tensors, on kk > 1024 and on a list too wide."""
    assert adc_scan.scan_plan(100, 96, 640, key_bytes=4) == (2, 640)
    s8, t8 = adc_scan.scan_plan(1024, 96, 640)
    s4, t4 = adc_scan.scan_plan(1024, 96, 640, key_bytes=4)
    assert (s4, t4) >= (s8, t8) and 2048 * 4 + s4 * (96 * 512 + 96 * t4) <= 227 * 1024 - 1024
    codes, slot_ids, probes, rng = _index(5)
    args = (torch.zeros((B, P, M, 256)), torch.from_numpy(probes), torch.from_numpy(codes),
            torch.from_numpy(slot_ids))
    for gathered in (False, True):
        with pytest.raises(ValueError, match="CUDA tensors"):
            adc_scan.adc_topk_keys_cuda(*args, 10, gathered=gathered)
