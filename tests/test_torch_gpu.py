"""The CUDA kernels against their plain PyTorch versions and a float64 numpy
oracle, on a card (the flat top-k: the tensor-core kernel of every store
type, f32 by the three-way bf16 split, and the SIMT kernel of f32 FMA as its
A/B). Marked ``gpu``: each test asks its fixture for a
card and skips without one. The file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: score regret <= 1e-5 against float64 over the effective inputs
(the bf16-rounded query where the path rounds it, the dequantized store);
values against the plain version to atol 1e-5 / rtol 1e-5 (f32 sums in
another order); ids equal to the plain version's at >= 95% of positions
(near-ties may swap)."""

import numpy as np
import pytest
import torch

from nvdb_tpu_torch.formats import synth, vecbin
from nvdb_tpu_torch.kernels import dispatch, flat_scan

DTYPES = ["f32", "bf16", "i8", "i8xi8"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _dispatched_ops(fn):
    """Run ``fn``; return (result, [(operator, [(shape, dtype) of each tensor
    result])]) of every torch operator it dispatched. A kernel launched
    through ctypes is no torch operator."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            seen.append((str(func), [(tuple(o.shape), o.dtype) for o in outs
                                     if isinstance(o, torch.Tensor)]))
            return out

    with Recorder():
        res = fn()
    return res, seen


def _case(n_pad, dp, b, dtype, seed):
    base = np.zeros((n_pad, dp), np.float32)
    base[:, :] = synth.normalized_gaussian(n_pad, dp, seed=seed)
    q = synth.normalized_gaussian(b, dp, seed=seed + 1)
    sc = qq = qs = None
    if dtype == "f32":
        store, q_eff, store_eff = torch.from_numpy(base), q, base
    elif dtype == "bf16":
        bits = vecbin.to_bf16(base)
        store = vecbin.bf16_bits_to_torch(bits)
        q_eff = vecbin.bf16_to_f32(vecbin.to_bf16(q))
        store_eff = vecbin.bf16_to_f32(bits)
    else:
        codes, sc = vecbin.quantize_i8(base)
        store = torch.from_numpy(codes)
        store_eff = codes.astype(np.float64) * sc[:, None]
        q_eff = vecbin.bf16_to_f32(vecbin.to_bf16(q))
        if dtype == "i8xi8":
            qq, qs = vecbin.quantize_i8(q)
            q_eff = qq.astype(np.float64) * qs[:, None]
    return dict(q=q, store=store, sc=sc, qq=qq, qs=qs,
                q_eff=np.asarray(q_eff, np.float64),
                store_eff=np.asarray(store_eff, np.float64))


def _args(c, device):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(device)
    q = t(c["qq"]) if c["qq"] is not None else t(c["q"])
    return q, c["store"].to(device), t(c["sc"]), t(c["qs"])


def _check(vals, ids, c, n_valid, k):
    s64 = c["q_eff"] @ c["store_eff"][:n_valid].T
    kk = min(k, n_valid)
    ref = -np.sort(-s64, axis=1)[:, :kk]
    assert (ids[:, :kk] >= 0).all() and (ids[:, :kk] < n_valid).all()
    got = np.take_along_axis(s64, ids[:, :kk].astype(np.int64), axis=1)
    assert np.max(ref - got) <= 1e-5
    np.testing.assert_allclose(vals[:, :kk], got, atol=1e-5, rtol=1e-5)
    assert np.all(np.diff(vals[:, :kk], axis=1) <= 0)
    assert (ids[:, kk:] == -1).all() and np.isneginf(vals[:, kk:]).all()
    for row in ids[:, :kk]:
        assert len(set(row.tolist())) == kk


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k", [(1, 1), (8, 10), (37, 128), (130, 10)])
def test_kernel_matches_plain(cuda_device, dtype, b, k):
    n_pad, n_valid, dp = 8192, 8000, 256
    c = _case(n_pad, dp, b, dtype, seed=7)
    q, v, sc, qs = _args(c, cuda_device)
    before = flat_scan.LAUNCHES
    kv, ki = flat_scan.flat_topk_cuda(q, v, sc, n_valid, k, query_scales=qs)
    torch.cuda.synchronize()
    assert flat_scan.LAUNCHES == before + 1
    pv, pi = flat_scan.flat_topk_reference(q, v, sc, n_valid, k, query_scales=qs)
    kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
    _check(kv, ki, c, n_valid, k)
    np.testing.assert_allclose(kv, pv.cpu().numpy(), atol=1e-5, rtol=1e-5)
    assert np.mean(ki == pi.cpu().numpy()) >= 0.95


@pytest.mark.gpu
@pytest.mark.parametrize("n_valid", [0, 5, 64, 65])
def test_kernel_few_valid_rows(cuda_device, n_valid):
    c = _case(4096, 128, 8, "bf16", seed=3)
    q, v, sc, qs = _args(c, cuda_device)
    kv, ki = dispatch.flat_topk(q, v, sc, n_valid, 10)
    kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
    if n_valid == 0:
        assert (ki == -1).all() and np.isneginf(kv).all()
    else:
        _check(kv, ki, c, n_valid, 10)


@pytest.mark.gpu
def test_kernel_ties_go_to_larger_id(cuda_device):
    """Duplicate rows score equal: the larger id comes first, as in the
    Pallas kernel's final sort."""
    base = np.zeros((256, 128), np.float32)
    base[:, 0] = 0.5
    base[[3, 100, 200], 0] = 1.0
    v = torch.from_numpy(base).to(cuda_device)
    q = torch.zeros((2, 128), device=cuda_device)
    q[:, 0] = 1.0
    vals, ids = flat_scan.flat_topk_cuda(q, v, None, 256, 5)
    assert ids.cpu().tolist() == [[200, 100, 3, 255, 254]] * 2
    assert vals.cpu().tolist() == [[1.0, 1.0, 1.0, 0.5, 0.5]] * 2


@pytest.mark.gpu
def test_wrapper_rejects_bad_input(cuda_device):
    c = _case(1024, 128, 8, "f32", seed=5)
    q, v, _, _ = _args(c, cuda_device)
    with pytest.raises(ValueError):
        flat_scan.flat_topk_cuda(q, v, None, 1024, 129)
    with pytest.raises(TypeError):
        flat_scan.flat_topk_cuda(q.double(), v, None, 1024, 10)
    with pytest.raises(ValueError):
        flat_scan.flat_topk_cuda(q[:, :64], v, None, 1024, 10)
    with pytest.raises(ValueError):
        flat_scan.flat_topk_cuda(q, v, torch.ones(1024, device=cuda_device), 1024, 10)


# -- the tensor-core flat kernel's edges (every store type) ----------------------

TC_DTYPES = ["bf16", "i8", "i8xi8", "f32"]


def _store(base, q, dtype, device):
    """(queries, store, scales, query scales) of one store type on the card."""
    sc = qs = None
    qt = torch.from_numpy(q).to(device)
    if dtype == "f32":
        v = torch.from_numpy(base).to(device)
    elif dtype == "bf16":
        v = torch.from_numpy(base).to(torch.bfloat16).to(device)
    else:
        codes, scn = vecbin.quantize_i8(base)
        v, sc = torch.from_numpy(codes).to(device), torch.from_numpy(scn).to(device)
        if dtype == "i8xi8":
            qq, qsn = vecbin.quantize_i8(q)
            qt, qs = torch.from_numpy(qq).to(device), torch.from_numpy(qsn).to(device)
    return qt, v, sc, qs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("n_valid", [0, 5, 127, 129, 255, 257])
def test_tensor_core_kernel_few_valid_rows(cuda_device, dtype, n_valid):
    """n_valid = 0, n_valid < k, and an n_valid one row short of and one row
    past a row tile (256 rows; 128 for f32 stores)."""
    c = _case(1024, 128, 8, dtype, seed=3)
    q, v, sc, qs = _args(c, cuda_device)
    kv, ki = flat_scan.flat_topk_cuda(q, v, sc, n_valid, 10, query_scales=qs)
    kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
    if n_valid == 0:
        assert (ki == -1).all() and np.isneginf(kv).all()
    else:
        _check(kv, ki, c, n_valid, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TC_DTYPES)
def test_tensor_core_kernel_ties_go_to_larger_id(cuda_device, dtype):
    """A store of duplicated rows: equal scores come out by descending id,
    whatever order tiles and candidates arrive in (rows 3, 300 and 700 lie
    in three different row tiles)."""
    base = np.zeros((1024, 128), np.float32)
    base[:, 0] = 0.5
    base[[3, 300, 700], 0] = 1.0
    q = np.zeros((130, 128), np.float32)
    q[:, 0] = 1.0
    qt, v, sc, qs = _store(base, q, dtype, cuda_device)
    vals, ids = flat_scan.flat_topk_cuda(qt, v, sc, 1000, 6, query_scales=qs)
    pv, pi = flat_scan.flat_topk_reference(qt, v, sc, 1000, 6, query_scales=qs)
    assert ids.cpu().tolist() == [[700, 300, 3, 999, 998, 997]] * 130
    assert torch.equal(ids, pi)
    np.testing.assert_allclose(vals.cpu().numpy(), pv.cpu().numpy(), atol=1e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("dp", [64, 384, 768])
@pytest.mark.parametrize("b", [1, 129, 513])
def test_tensor_core_kernel_dims_and_batches(cuda_device, dtype, dp, b):
    """Dp of one chunk, of an odd number of 128-byte int8 chunks, and the
    main path's; one query, a second query block of one query, and five
    query blocks with a ragged last one; k = 128 (the shortest ring)."""
    n_pad, n_valid, k = 4096, 4000, 128
    c = _case(n_pad, dp, b, dtype, seed=dp + b)
    q, v, sc, qs = _args(c, cuda_device)
    kv, ki = flat_scan.flat_topk_cuda(q, v, sc, n_valid, k, query_scales=qs)
    pv, pi = flat_scan.flat_topk_reference(q, v, sc, n_valid, k, query_scales=qs)
    kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
    _check(kv, ki, c, n_valid, k)
    np.testing.assert_allclose(kv, pv.cpu().numpy(), atol=1e-5, rtol=1e-5)
    if dtype == "i8xi8":   # exact int32 sums: bit for bit
        np.testing.assert_array_equal(kv, pv.cpu().numpy())
    assert np.mean(ki == pi.cpu().numpy()) >= 0.95


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("n_rows", [300, 512])
def test_tensor_core_kernel_zero_fill_does_not_win(cuda_device, dtype, n_rows):
    """Every score is negative and the last row tile is ragged: the zeros
    that the tile's rows past the store (n_rows = 300) or past n_valid
    (n_rows = 512, rows 300.. all zero) score must not enter a list, nor
    the zero rows of the queries past B."""
    rng = np.random.default_rng(9)
    base = -np.abs(rng.standard_normal((n_rows, 128))).astype(np.float32) - 0.1
    base[300:] = 0.0
    q = np.abs(rng.standard_normal((5, 128))).astype(np.float32) + 0.1
    qt, v, sc, qs = _store(base, q, dtype, cuda_device)
    vals, ids = flat_scan.flat_topk_cuda(qt, v, sc, 300, 10, query_scales=qs)
    pv, pi = flat_scan.flat_topk_reference(qt, v, sc, 300, 10, query_scales=qs)
    assert bool((vals < 0).all()) and bool(((ids >= 0) & (ids < 300)).all())
    np.testing.assert_allclose(vals.cpu().numpy(), pv.cpu().numpy(), atol=1e-5, rtol=1e-5)
    assert np.mean(ids.cpu().numpy() == pi.cpu().numpy()) >= 0.95


@pytest.mark.gpu
def test_f32_tensor_core_every_k(cuda_device):
    """The f32 instance's shared-memory plan holds for every k in [1, 128]
    (two split tiles while a ring of two stages fits beside the lists, one
    above): each k runs and matches the plain version and float64."""
    n_pad, n_valid, dp, b = 2048, 2000, 128, 70
    c = _case(n_pad, dp, b, "f32", seed=17)
    q, v, _, _ = _args(c, cuda_device)
    for k in range(1, 129):
        kv, ki = flat_scan.flat_topk_cuda(q, v, None, n_valid, k)
        pv, _ = flat_scan.flat_topk_reference(q, v, None, n_valid, k)
        kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
        _check(kv, ki, c, n_valid, k)
        np.testing.assert_allclose(kv, pv.cpu().numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(129, 10), (512, 128)])
def test_f32_tensor_core_against_simt(cuda_device, b, k):
    """The error gate of chip_smoke.py phase 3 against the SIMT kernel (the
    A/B) on the same call: the tensor-core values no further from float64
    than twice the SIMT kernel's, and the same ids wherever the float64
    scores of the two ids differ by more than 1e-6. Each launch is counted
    under its own instance."""
    n_pad, n_valid, dp = 16384, 16000, 768
    c = _case(n_pad, dp, b, "f32", seed=23)
    q, v, _, _ = _args(c, cuda_device)
    before = dict(flat_scan.LAUNCHES_BY_KERNEL)
    tv, ti = flat_scan.flat_topk_cuda(q, v, None, n_valid, k)
    sv, si = flat_scan.flat_topk_cuda(q, v, None, n_valid, k, f32_kernel="simt")
    after = flat_scan.LAUNCHES_BY_KERNEL
    assert after["f32_tensor_core"] == before["f32_tensor_core"] + 1
    assert after["f32_simt"] == before["f32_simt"] + 1
    s64 = c["q_eff"] @ c["store_eff"][:n_valid].T
    tv, ti, sv, si = (x.cpu().numpy() for x in (tv, ti, sv, si))
    _check(tv, ti, c, n_valid, k)
    _check(sv, si, c, n_valid, k)
    gt = np.take_along_axis(s64, ti.astype(np.int64), axis=1)
    gs = np.take_along_axis(s64, si.astype(np.int64), axis=1)
    assert np.abs(tv - gt).max() <= 2.0 * np.abs(sv - gs).max()
    assert not ((ti != si) & (np.abs(gt - gs) > 1e-6)).any()
    with pytest.raises(ValueError, match="f32 stores only"):
        flat_scan.flat_topk_cuda(q, v.to(torch.bfloat16), None, n_valid, k, f32_kernel="simt")


# -- the rerank kernel ---------------------------------------------------------

def _rerank_case(dtype, b, r, seed, n=4096, dp=256):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dp)).astype(np.float32)
    cand = np.stack([rng.choice(n, r, replace=False) for _ in range(b)]).astype(np.int32)
    cand[0, r // 2:] = -1                      # padding
    if b > 1 and r > 3:
        cand[1, 1] = cand[1, 0]                # a repeated id
    sc = None
    if dtype == "f32":
        store = torch.from_numpy(base)
    elif dtype == "bf16":
        store = vecbin.bf16_bits_to_torch(vecbin.to_bf16(base))
    else:
        codes, sc = vecbin.quantize_i8(base)
        store = torch.from_numpy(codes)
    q = rng.standard_normal((b, dp)).astype(np.float32)
    return q, cand, store, sc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("b,r,k", [(1, 10, 1), (37, 100, 10), (8, 256, 100)])
def test_rerank_kernel_matches_plain(cuda_device, dtype, metric, b, r, k):
    from nvdb_tpu_torch.kernels import rerank

    q, cand, store, sc = _rerank_case(dtype, b, r, seed=b + r)
    q, cand = torch.from_numpy(q).to(cuda_device), torch.from_numpy(cand).to(cuda_device)
    store = store.to(cuda_device)
    sc = torch.from_numpy(sc).to(cuda_device) if sc is not None else None
    n2 = rerank.store_norms2(store)
    before = rerank.LAUNCHES
    (kv, ki), ops_seen = _dispatched_ops(
        lambda: rerank.rerank_topk_cuda(q, cand, store, sc, k, norms2=n2, metric=metric))
    torch.cuda.synchronize()
    # one launch a call, and nothing else on the device: the coefficients
    # are folded inside the kernel
    assert rerank.LAUNCHES == before + 1
    assert [name for name, _ in ops_seen if "empty" not in name] == []
    pv, pi = rerank.rerank_topk_reference(q, cand, store, sc, k, norms2=n2, metric=metric)
    kv, ki, pv, pi = (x.cpu().numpy() for x in (kv, ki, pv, pi))
    np.testing.assert_allclose(kv, pv, atol=1e-5, rtol=1e-5)
    assert np.mean(ki == pi) >= 0.95
    for row, vals in zip(ki, kv):
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
        assert np.all(np.diff(vals[np.isfinite(vals)]) <= 0)
        assert np.isneginf(vals[row < 0]).all()


@pytest.mark.gpu
def test_rerank_kernel_rejects_bad_input(cuda_device):
    from nvdb_tpu_torch.kernels import rerank

    q, cand, store, _ = _rerank_case("f32", 4, 20, seed=1)
    q, cand = torch.from_numpy(q).to(cuda_device), torch.from_numpy(cand).to(cuda_device)
    store = store.to(cuda_device)
    with pytest.raises(ValueError):
        rerank.rerank_topk_cuda(q, cand, store, None, 129, metric="dot")
    with pytest.raises(TypeError):
        rerank.rerank_topk_cuda(q, cand.long(), store, None, 10, metric="dot")
    with pytest.raises(ValueError):
        rerank.rerank_topk_cuda(q, cand, store, torch.ones(4096, device=cuda_device), 10,
                                metric="dot")
    with pytest.raises(ValueError):                     # norms of another length
        rerank.rerank_topk_cuda(q, cand, store, None, 10, metric="l2",
                                norms2=torch.ones(100, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rerank.rerank_topk_cuda(q.cpu(), cand.cpu(), store.cpu(), None, 10, metric="dot")


# -- the ADC kernel ------------------------------------------------------------

def _adc_case(b, p, seed, nlist=40, m=16, lcap=256, dup=False):
    """A random packed index with lists of varied fill (empty, partial,
    full), the tables and probe ids; ``dup``: lists 1 and 2 hold the same
    ids (a replicated index)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nlist, m, lcap)).astype(np.uint8)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        f = int(rng.integers(0, lcap + 1)) if li % 5 else lcap
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[3, :] = -1                                   # an empty list
    if dup:
        slot_ids[2] = slot_ids[1]
    lut = rng.standard_normal((b, p, m, 256)).astype(np.float32)
    probes = np.stack([rng.choice(nlist, p, replace=False) for _ in range(b)]).astype(np.int32)
    if dup:
        probes[:, :2] = [1, 2]
    return lut, probes, codes, slot_ids


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(1, 1), (8, 7), (64, 32)])
@pytest.mark.parametrize("kk", [10, 100, 256, 1024])
@pytest.mark.parametrize("dup", [False, True])
def test_adc_kernel_matches_plain(cuda_device, b, p, kk, dup):
    from nvdb_tpu_torch.kernels import adc_scan

    if dup and p < 2:
        pytest.skip("a duplicated list needs two probes")
    lut, probes, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                                    for x in _adc_case(b, p, seed=b * p + kk, dup=dup))
    before = adc_scan.LAUNCHES
    kv, ki = adc_scan.adc_topk_cuda(lut, probes, codes, slot_ids, kk)
    torch.cuda.synchronize()
    assert adc_scan.LAUNCHES == before + 1
    pv, pi = adc_scan.adc_topk_reference(lut, probes, codes, slot_ids, kk)
    kv, ki, pv, pi = (x.cpu().numpy() for x in (kv, ki, pv, pi))
    # the kernel sums the bf16 tables in the plain version's order
    np.testing.assert_allclose(kv, pv, atol=1e-4, rtol=0)
    assert np.mean(ki == pi) >= 0.99
    for row, vals in zip(ki, kv):
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
        assert np.all(np.diff(vals[np.isfinite(vals)]) <= 0)
        assert np.isneginf(vals[row < 0]).all()


@pytest.mark.gpu
def test_adc_kernel_rejects_bad_input(cuda_device):
    from nvdb_tpu_torch.kernels import adc_scan

    lut, probes, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                                    for x in _adc_case(4, 3, seed=1))
    with pytest.raises(ValueError):
        adc_scan.adc_topk_cuda(lut, probes, codes, slot_ids, 1025)
    with pytest.raises(ValueError, match="multiple of 16"):     # 16-byte code row copies
        adc_scan.adc_topk_cuda(lut, probes, codes[:, :, :250].contiguous(),
                               slot_ids[:, :250].contiguous(), 10)
    with pytest.raises(ValueError):
        adc_scan.adc_topk_cuda(lut[:, :, :8].contiguous(), probes, codes, slot_ids, 10)


# -- the ADC table kernel ------------------------------------------------------

def _table_case(b, p, nlist, m, dsub, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    dp = m * dsub
    cents = torch.randn((nlist, dp), generator=g, device=device)
    near = torch.randint(0, nlist, (b,), generator=g, device=device)
    q_rot = cents[near] + 0.3 * torch.randn((b, dp), generator=g, device=device)
    cb = 0.3 * torch.randn((m, 256, dsub), generator=g, device=device)
    fills = torch.randint(0, 4, (nlist,), generator=g, device=device).to(torch.int32)
    probes = torch.randint(0, nlist, (b, p), generator=g, device=device).to(torch.int32)
    probes[0, 0] = -1
    probes[-1, -1] = nlist + 3
    return q_rot.contiguous(), probes, cents, cb, fills


def _bf16_steps(a, b):
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.gpu
@pytest.mark.parametrize("b,p,nlist,m,dsub", [
    (1, 1, 8, 16, 8), (8, 7, 40, 96, 8), (37, 12, 64, 16, 8), (64, 64, 512, 96, 8),
    (5, 3, 20, 32, 4), (5, 3, 20, 64, 12), (5, 3, 20, 8, 16), (5, 3, 20, 4, 32),
    (5, 3, 20, 10, 8)])
def test_tables_kernel_matches_plain(cuda_device, b, p, nlist, m, dsub):
    """Register-resident instances (dsub 4, 8, 12, 16), the any-dsub kernel
    (32), an M off the 8-subspace group (10); dead and out-of-range probes.
    At least 99.9% of the live probes' entries bit-equal, the rest one bf16
    step off (8 products summed in another order, then one rounding)."""
    from nvdb_tpu_torch.kernels import adc_scan

    args = _table_case(b, p, nlist, m, dsub, seed=b * p + m, device=cuda_device)
    before = adc_scan.TABLE_LAUNCHES
    got, ops_seen = _dispatched_ops(lambda: adc_scan.adc_tables_cuda(*args))
    torch.cuda.synchronize()
    assert adc_scan.TABLE_LAUNCHES == before + 1
    assert [name for name, _ in ops_seen if "empty" not in name] == []
    want = adc_scan.adc_tables_reference(*args)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, p, m, 256)
    live = adc_scan.live_probes(args[1], args[4])
    assert bool((got[~live] == 0).all())
    if bool(live.any()):
        steps = _bf16_steps(got[live], want[live])
        assert float((steps == 0).float().mean()) >= 0.999
        assert int(steps.max()) <= 1


@pytest.mark.gpu
def test_tables_kernel_rejects_bad_input(cuda_device):
    from nvdb_tpu_torch.kernels import adc_scan

    q, probes, cents, cb, fills = _table_case(4, 3, 20, 16, 8, seed=3, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_tables_cuda(q.cpu(), probes.cpu(), cents.cpu(), cb.cpu(), fills.cpu())
    with pytest.raises(TypeError):
        adc_scan.adc_tables_cuda(q, probes.long(), cents, cb, fills)
    with pytest.raises(ValueError):
        adc_scan.adc_tables_cuda(q, probes, cents, cb[:, :, :4].contiguous(), fills)
    with pytest.raises(ValueError):
        adc_scan.adc_tables_cuda(q[:, :64].contiguous(), probes, cents, cb, fills)
    with pytest.raises(ValueError):
        adc_scan.adc_tables_cuda(q, probes, cents, cb, fills[:5].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 2])
def test_ivfpq_kernel_path_makes_no_f32_table(cuda_device, replicas):
    """``IVFPQIndex.search_device`` on a CUDA index: one table launch and one
    scan launch, and no tensor the size of the tables but the bf16 one the
    table kernel fills; its candidates are the plain path's."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.kernels import adc_scan

    b, p, nlist, m, lcap, k = 16, 8, 40, 16, 256, 20
    _, _, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                             for x in _adc_case(b, p, seed=11, nlist=nlist, m=m, lcap=lcap,
                                                dup=replicas > 1))
    q_rot, _, cents, cb, _ = _table_case(b, p, nlist, m, 8, seed=12, device=cuda_device)
    idx = IVFPQIndex(rotation=None, centroids=cents, codebooks=cb, codes=codes,
                     slot_ids=slot_ids, n=nlist * lcap, d=m * 8, m=m, replicas=replicas)
    t0, s0 = adc_scan.TABLE_LAUNCHES, adc_scan.LAUNCHES
    (kv, ki), ops_seen = _dispatched_ops(lambda: idx.search_device(q_rot, k, p))
    torch.cuda.synchronize()
    assert (adc_scan.TABLE_LAUNCHES, adc_scan.LAUNCHES) == (t0 + 1, s0 + 1)
    big = [(name, shape, dt) for name, outs in ops_seen for shape, dt in outs
           if int(np.prod(shape)) >= b * p * m * 256]
    assert len(big) == 1 and "empty" in big[0][0] and big[0][2] == torch.bfloat16
    pv, pi = idx.search_device(q_rot, k, p, backend="torch")
    kv, ki, pv, pi = (x.cpu().numpy() for x in (kv, ki, pv, pi))
    # the kernel's tables differ from the plain ones in a rare entry by one
    # bf16 step, 2^-8 of that entry
    np.testing.assert_allclose(kv, pv, atol=2.0 ** -8 * float(np.abs(pv).max()), rtol=0)
    for x, y in zip(ki, pi):
        assert len(set(x.tolist()) & set(y.tolist())) >= int(0.9 * k)


# -- the ADC key and gather kernels -----------------------------------------------

def _key_check(cuda_device, lut, probes, codes, slot_ids, kk):
    """Both key kernels against the plain version, bit for bit, values and
    ids; one launch each on its own counter."""
    from nvdb_tpu_torch.kernels import adc_scan

    pv, pi = adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, kk)
    out = []
    for gathered in (False, True):
        before = (adc_scan.KEY_LAUNCHES, adc_scan.GATHER_LAUNCHES)
        kv, ki = adc_scan.adc_topk_keys_cuda(lut, probes, codes, slot_ids, kk,
                                             gathered=gathered)
        torch.cuda.synchronize()
        after = (adc_scan.KEY_LAUNCHES, adc_scan.GATHER_LAUNCHES)
        assert after == (before[0] + (not gathered), before[1] + gathered)
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
        out.append((kv, ki))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    return pv, pi


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(1, 1), (8, 7), (64, 32)])
@pytest.mark.parametrize("kk", [10, 100, 1024])
def test_adc_key_kernels_match_plain(cuda_device, b, p, kk):
    lut, probes, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                                    for x in _adc_case(b, p, seed=b * p + kk + 3))
    pv, pi = _key_check(cuda_device, lut, probes, codes, slot_ids, kk)
    assert not bool((pv[pi >= 0].view(torch.int32) & 0xFFFF).any())   # truncated to bf16


@pytest.mark.gpu
@pytest.mark.parametrize("lcap,nlist,p", [(256, 40, 32), (2048, 80, 64)])
def test_adc_key_kernels_ties_and_coordinate_groups(cuda_device, lcap, nlist, p):
    """Tables of small integers make most truncated scores tie, so the kk-th
    value is shared by many candidates; at Lcap 2048 the 64 probes split
    into groups whose coordinates fit 16 bits, merged in pass 2."""
    _, probes, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                                  for x in _adc_case(4, p, seed=lcap, nlist=nlist, lcap=lcap))
    g = torch.Generator(device=cuda_device).manual_seed(lcap)
    lut = torch.randint(0, 3, (4, p, 16, 256), generator=g, device=cuda_device).float()
    for kk in (10, 1024):
        _key_check(cuda_device, lut, probes, codes, slot_ids, kk)


@pytest.mark.gpu
def test_adc_key_kernels_scarce_dead_and_bad_input(cuda_device):
    """Fewer live candidates than kk (list 3 dead, list 5 three slots, an
    out-of-range probe): the real candidates, then (-inf, -1). Bad input
    raises by name."""
    from nvdb_tpu_torch.kernels import adc_scan

    lut, probes, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                                    for x in _adc_case(3, 4, seed=5))
    slot_ids[:] = -1
    slot_ids[5, :3] = torch.tensor([7, 8, 9], device=cuda_device)
    probes[:] = torch.tensor([3, 5, 40, -1], device=cuda_device, dtype=torch.int32)
    pv, pi = _key_check(cuda_device, lut, probes, codes, slot_ids, 100)
    assert (pi[:, :3] >= 7).all() and (pi[:, 3:] == -1).all()
    assert torch.isneginf(pv[:, 3:]).all()
    with pytest.raises(ValueError, match="outside"):
        adc_scan.adc_topk_keys_cuda(lut, probes, codes, slot_ids, 1025)
    with pytest.raises(ValueError, match="16-bit"):
        adc_scan.adc_topk_keys_cuda(
            lut[:1, :1], probes[:1, :1], torch.zeros((1, 16, 65552), dtype=torch.uint8,
                                                     device=cuda_device),
            torch.zeros((1, 65552), dtype=torch.int32, device=cuda_device), 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_topk_keys_cuda(lut.cpu(), probes.cpu(), codes.cpu(), slot_ids.cpu(), 10)


def _ivfpq_on_card(cuda_device, replicas=1, b=16, p=8, nlist=40, m=16, lcap=256):
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex

    _, _, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                             for x in _adc_case(b, p, seed=11, nlist=nlist, m=m, lcap=lcap,
                                                dup=replicas > 1))
    q_rot, _, cents, cb, _ = _table_case(b, p, nlist, m, 8, seed=12, device=cuda_device)
    idx = IVFPQIndex(rotation=None, centroids=cents, codebooks=cb, codes=codes,
                     slot_ids=slot_ids, n=nlist * lcap, d=m * 8, m=m, replicas=replicas)
    return idx, q_rot


@pytest.mark.gpu
def test_ivfpq_key_mode_on_a_replicated_index_raises(cuda_device):
    idx, q = _ivfpq_on_card(cuda_device, replicas=2)
    assert idx.ids_mode() == "dma"
    for mode in ("key", "gather"):
        with pytest.raises(ValueError, match="replicas == 1"):
            idx.search_device(q, 10, 8, ids_mode=mode)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ivfpq_residual_refine_through_the_kernels(cuda_device, metric):
    """``search_device`` with a residual-int8 refine store on a CUDA index:
    the table, key and rerank kernels launch once each, and the result is
    the plain path's: ids at >= 0.9 of positions (a rare table entry one
    bf16 step off may change a candidate), values where the ids agree to
    1e-4."""
    from nvdb_tpu_torch.kernels import adc_scan, rerank
    from nvdb_tpu_torch.store import VectorStore

    idx, q = _ivfpq_on_card(cuda_device)
    rng = np.random.default_rng(13)
    n, dp = idx.n, idx.centroids.shape[1]
    list_of = rng.integers(0, idx.nlist, n).astype(np.int32)
    cents = idx.centroids.cpu().numpy()
    rows = cents[list_of] + 0.05 * rng.standard_normal((n, dp)).astype(np.float32)
    codes, sc = vecbin.quantize_i8(rows - cents[list_of])
    store = VectorStore.from_numpy(codes, "i8", scales=sc, device=cuda_device)
    store.attach_residual(cents, list_of)
    before = (adc_scan.TABLE_LAUNCHES, adc_scan.KEY_LAUNCHES, rerank.LAUNCHES)
    kv, ki = idx.search_device(q, 10, 8, refine_k=50, refine_store=store,
                               refine_metric=metric)
    torch.cuda.synchronize()
    assert (adc_scan.TABLE_LAUNCHES, adc_scan.KEY_LAUNCHES, rerank.LAUNCHES) == tuple(
        x + 1 for x in before)
    pv, pi = idx.search_device(q, 10, 8, refine_k=50, refine_store=store, backend="torch",
                               refine_metric=metric)
    same = ki == pi
    assert float(same.float().mean()) >= 0.9
    assert torch.allclose(kv[same], pv[same], atol=1e-4, rtol=1e-4)


# -- the IVF probe kernel ------------------------------------------------------

def _probe_case(dtype, b, p, seed, nlist=24, lcap=160, dp=128):
    """A random packed IVF index with lists of varied fill (empty, partial
    with holes, full, one filled below k), its queries and probe ids; list 3
    is dead (every slot -1) and every query probes it."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((nlist, lcap, dp)).astype(np.float32)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        f = int(rng.integers(0, lcap + 1)) if li % 5 else lcap
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[3] = -1
    slot_ids[4, 3:] = -1                              # three live slots
    slot_ids[5, ::7] = -1                             # holes
    sc = None
    if dtype == "f32":
        packed = torch.from_numpy(rows)
    elif dtype == "bf16":
        packed = vecbin.bf16_bits_to_torch(vecbin.to_bf16(rows))
    else:
        codes, s = vecbin.quantize_i8(rows.reshape(-1, dp))
        packed = torch.from_numpy(codes.reshape(nlist, lcap, dp))
        sc = torch.from_numpy(s.reshape(nlist, lcap))
    # distinct probes per query, as the coarse ranking gives: lists 3 and 4
    # first, then others
    fixed = [3, 4][:p]
    others = np.setdiff1d(np.arange(nlist), fixed)
    probes = np.stack([np.r_[fixed, rng.choice(others, p - len(fixed), replace=False)]
                       for _ in range(b)]).astype(np.int32)
    q = rng.standard_normal((b, dp)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(probes), packed, torch.from_numpy(slot_ids), sc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("b,p,k", [(1, 1, 1), (8, 7, 10), (37, 12, 128), (130, 3, 50)])
def test_probe_kernel_matches_plain(cuda_device, dtype, b, p, k):
    from nvdb_tpu_torch.kernels import ivf_scan

    args = [x.to(cuda_device) if x is not None else None
            for x in _probe_case(dtype, b, p, seed=b * 7 + p + k)]
    before = ivf_scan.LAUNCHES
    kv, ki = ivf_scan.ivf_probe_topk_cuda(*args, k)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == before + 1
    pv, pi = ivf_scan.ivf_probe_topk_reference(*args, k)
    kv, ki, pv, pi = (x.cpu().numpy() for x in (kv, ki, pv, pi))
    assert ((ki >= 0) == (pi >= 0)).all()
    np.testing.assert_allclose(kv, pv, atol=1e-5, rtol=1e-5)
    assert np.mean(ki == pi) >= 0.95
    for row, vals in zip(ki, kv):
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
        assert np.all(np.diff(vals[np.isfinite(vals)]) <= 0)
        assert np.isneginf(vals[row < 0]).all()


@pytest.mark.gpu
def test_probe_kernel_out_of_range_probe_is_empty(cuda_device):
    from nvdb_tpu_torch.kernels import ivf_scan

    q, probes, packed, sids, _ = _probe_case("f32", 4, 3, seed=9)
    q, probes, packed, sids = (x.to(cuda_device) for x in (q, probes, packed, sids))
    probes[:, 2] = -1
    probes[0, 1] = 10 ** 6
    kv, ki = ivf_scan.ivf_probe_topk_cuda(q, probes, packed, sids, None, 20)
    pv, pi = ivf_scan.ivf_probe_topk_reference(q, probes, packed, sids, None, 20)
    np.testing.assert_allclose(kv.cpu().numpy(), pv.cpu().numpy(), atol=1e-5, rtol=1e-5)
    assert ((ki >= 0) == (pi >= 0)).all()


@pytest.mark.gpu
def test_probe_kernel_rejects_bad_input(cuda_device):
    from nvdb_tpu_torch.kernels import ivf_scan

    q, probes, packed, sids, sc = _probe_case("i8", 4, 3, seed=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ivf_scan.ivf_probe_topk_cuda(q, probes, packed, sids, sc, 10)
    q, probes, packed, sids, sc = (x.to(cuda_device) for x in (q, probes, packed, sids, sc))
    with pytest.raises(ValueError):
        ivf_scan.ivf_probe_topk_cuda(q, probes, packed, sids, sc, 129)
    with pytest.raises(ValueError):
        ivf_scan.ivf_probe_topk_cuda(q, probes, packed, sids, None, 10)   # int8 needs scales
    with pytest.raises(TypeError):
        ivf_scan.ivf_probe_topk_cuda(q.double(), probes, packed, sids, sc, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_rerank_kernel_residual_fold(cuda_device, metric):
    """A residual-int8 store (row = cent + s * codes) through the kernel,
    against the plain version and a float64 oracle over the dequantized
    rows."""
    from nvdb_tpu_torch.kernels import rerank
    from nvdb_tpu_torch.store import VectorStore

    rng = np.random.default_rng(17)
    n, dp, nlist, b, r, k = 3000, 128, 16, 12, 60, 10
    cents = rng.standard_normal((nlist, dp)).astype(np.float32)
    list_of = rng.integers(0, nlist, n).astype(np.int32)
    rows = cents[list_of] + 0.3 * rng.standard_normal((n, dp)).astype(np.float32)
    codes, sc = vecbin.quantize_i8(rows - cents[list_of])
    store = VectorStore.from_numpy(codes, "i8", scales=sc, device=cuda_device)
    store.attach_residual(cents, list_of)
    q = torch.from_numpy(rng.standard_normal((b, dp)).astype(np.float32)).to(cuda_device)
    cand = torch.from_numpy(np.stack([rng.choice(n, r, replace=False) for _ in range(b)])
                            .astype(np.int32)).to(cuda_device)
    kw = dict(norms2=store.norms2() if metric == "l2" else None, metric=metric,
              res_cents=store.res_cents, res_ids=store.res_ids)
    before = rerank.LAUNCHES
    kv, ki = rerank.rerank_topk_cuda(q, cand, store.vectors, store.scales, k, **kw)
    assert rerank.LAUNCHES == before + 1
    pv, pi = rerank.rerank_topk_reference(q, cand, store.vectors, store.scales, k, **kw)
    kv, ki, pv, pi = (x.cpu().numpy() for x in (kv, ki, pv, pi))
    np.testing.assert_allclose(kv, pv, atol=1e-4, rtol=1e-5)
    deq = cents[list_of].astype(np.float64) + codes.astype(np.float64) * sc[:, None]
    c = cand.cpu().numpy()
    s64 = np.einsum("bd,brd->br", q.cpu().numpy().astype(np.float64), deq[c])
    if metric == "l2":
        s64 = 2.0 * s64 - (deq[c] ** 2).sum(-1)
    best = -np.sort(-s64, axis=1)[:, :k]
    pos = [{int(cid): ri for ri, cid in enumerate(row)} for row in c]
    got = np.array([[s64[bi, pos[bi][int(i)]] for i in ki[bi]] for bi in range(b)])
    assert np.max(best - -np.sort(-got, axis=1)) <= 1e-4


# -- the HBM stream and add1 kernels -------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 4097, 70001])
def test_stream_kernels_match_amax(cuda_device, rows):
    from nvdb_tpu_torch.kernels import hbm_stream

    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn((rows, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    want = hbm_stream.stream_max_reference(x)
    before = dict(hbm_stream.LAUNCHES)
    assert torch.equal(hbm_stream.stream_max_cuda(x), want)
    assert torch.equal(hbm_stream.ring_max_cuda(x), want)
    assert hbm_stream.LAUNCHES == {"stream": before["stream"] + 1, "ring": before["ring"] + 1}
    with pytest.raises(ValueError, match="CUDA tensors"):
        hbm_stream.stream_max_cuda(x.cpu())


@pytest.mark.gpu
def test_add1_kernel(cuda_device):
    from nvdb_tpu_torch.kernels import add1

    x = torch.linspace(-3, 3, 8 * 128, device=cuda_device).reshape(8, 128)
    before = add1.LAUNCHES
    assert torch.equal(add1.add1_cuda(x), x + 1.0)
    assert add1.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        add1.add1_cuda(x.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(7, 3), (1,), (5, 4), (1000, 33)])
def test_add1_kernel_other_shapes(cuda_device, shape):
    """Sizes off the 256-thread block, down to one element."""
    from nvdb_tpu_torch.kernels import add1

    x = torch.arange(int(np.prod(shape)), dtype=torch.float32, device=cuda_device).reshape(shape)
    assert torch.equal(add1.add1_cuda(x), x + 1.0)


# -- the build side and the data tools on the card ------------------------------

@pytest.fixture(scope="module")
def built_pq():
    """A small IVF-PQ index built on the card (4,000 x 64, nlist 16, m 16)
    with its base and queries; None without a card."""
    if not torch.cuda.is_available():
        return None
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.store import VectorStore

    base = synth.low_rank(4000, 64, intrinsic=16, n_clusters=12, spread=0.5, seed=71)
    queries, _ = synth.sample_queries(base, 32, seed=72, perturb=0.05)
    idx = IVFPQIndex.build(base, nlist=16, m=16, use_opq=True, opq_iters=2, n_iters=6,
                           pad_factor=1.0, spill_candidates=2, seed=2, device="cuda")
    return dict(base=base, q=queries, idx=idx,
                store=VectorStore.from_numpy(base, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 2])
def test_repacked_ivfpq_kernels_match_plain(cuda_device, built_pq, replicas):
    """A repacked (R = 1) and a replicated (R = 2) index searched through the
    kernels against the plain path: ids equal at >= 0.99 of positions after
    the exact refine, and no id twice in any query's ADC candidates or
    results (R = 2 takes the dma kernel with its duplicate pass)."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.kernels import adc_scan

    w = built_pq
    idx = IVFPQIndex.repack(w["idx"], w["base"], pad_factor=2.0, spill_candidates=8,
                            replicas=replicas)
    assert idx.replicas == replicas and idx.device.type == "cuda"
    assert idx.n_spilled < w["idx"].n_spilled
    assert idx.ids_mode() == ("key" if replicas == 1 else "dma")
    before = adc_scan.LAUNCHES
    _, ki = idx.search(w["q"], 10, 4, refine_k=50, refine_store=w["store"])
    _, pi = idx.search(w["q"], 10, 4, refine_k=50, refine_store=w["store"], backend="torch")
    assert float(np.mean(ki == pi)) >= 0.99
    _, cand = idx.search(w["q"], 40, 4)
    if replicas > 1:
        assert adc_scan.LAUNCHES > before
    for row in [*ki, *cand]:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


@pytest.mark.gpu
def test_corpus_refine_on_card_matches_cpu(cuda_device):
    from nvdb_tpu_torch.kernels import kmeans

    base = synth.clustered(6000, 64, n_clusters=48, seed=13)
    rng = np.random.default_rng(5)
    c0 = base[rng.choice(6000, 48, replace=False)].copy()
    c0[-8:] = 3.0 * rng.standard_normal((8, 64)).astype(np.float32)
    logs = {"cpu": [], "cuda": []}
    cpu = kmeans.corpus_refine(base, torch.from_numpy(c0), n_iters=2, chunk=2048,
                               pool_rows=4096, log=logs["cpu"].append)
    card = kmeans.corpus_refine(base, torch.from_numpy(c0).to(cuda_device), n_iters=2,
                                chunk=2048, pool_rows=4096, log=logs["cuda"].append)
    assert card.device.type == "cuda" and logs["cuda"] == logs["cpu"]
    assert torch.allclose(card.cpu(), cpu, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_gt_build_on_card_matches_cpu(cuda_device, tmp_path):
    """``tools.gt_build`` on the card (the flat kernel), chunked on the card,
    and with ``--device cpu``: the same ids at >= 0.99 of positions (f32
    sums in another order may swap a near-tie), and the card's ids lose no
    float64 score against the CPU's beyond 1e-5."""
    from nvdb_tpu_torch.kernels import flat_scan
    from nvdb_tpu_torch.tools import gt_build

    base = synth.clustered(20000, 96, n_clusters=32, spread=0.5, seed=31)
    queries, _ = synth.sample_queries(base, 64, seed=32, perturb=0.05)
    bp, qp = str(tmp_path / "base.vecbin"), str(tmp_path / "q.vecbin")
    vecbin.write_vecbin(bp, base)
    vecbin.write_vecbin(qp, queries)
    before = flat_scan.LAUNCHES
    card = gt_build.main([bp, qp, str(tmp_path / "a.gtbin"), "--k", "10"])
    assert flat_scan.LAUNCHES > before
    chunked = gt_build.main([bp, qp, str(tmp_path / "b.gtbin"), "--k", "10",
                             "--row-chunk", "7000"])
    cpu = gt_build.main([bp, qp, str(tmp_path / "c.gtbin"), "--k", "10", "--device", "cpu"])
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    for ids in (card, chunked):
        assert float(np.mean(ids == cpu)) >= 0.99
        got = np.sort(np.take_along_axis(s64, ids.astype(np.int64), axis=1), axis=1)
        want = np.sort(np.take_along_axis(s64, cpu.astype(np.int64), axis=1), axis=1)
        assert float(np.max(want - got)) <= 1e-5


# -- the sharded paths: the kernels on a shard's inputs ------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_flat_kernel_on_shard_views(cuda_device, dtype):
    """Row views at each shard's offset of one store (as four shards of
    ``cuda:0`` see it): the kernel on a view equals the kernel on a copy of
    the same rows bit for bit and the plain version to 1e-5; a shard whose
    valid row count is 0 returns (-inf, -1) everywhere."""
    S, rps = 4, 1024
    c = _case(S * rps, 256, 16, dtype, seed=41)
    q, v, sc, _ = _args(c, cuda_device)
    for s in range(S):
        view = v[s * rps:(s + 1) * rps]
        vsc = None if sc is None else sc[s * rps:(s + 1) * rps]
        assert view.data_ptr() == v.data_ptr() + s * rps * v.shape[1] * v.element_size()
        n_valid = rps - 100 if s < S - 1 else 0
        kv, ki = flat_scan.flat_topk_cuda(q, view, vsc, n_valid, 10)
        if n_valid == 0:
            assert bool((ki == -1).all()) and bool(torch.isneginf(kv).all())
            continue
        cv, ci = flat_scan.flat_topk_cuda(q, view.clone(), None if vsc is None else vsc.clone(),
                                          n_valid, 10)
        assert torch.equal(kv, cv) and torch.equal(ki, ci)
        pv, _ = dispatch.flat_topk(q, view, vsc, n_valid, 10, backend="torch")
        assert torch.allclose(kv, pv, atol=1e-5, rtol=1e-5)
        assert int(ki.max()) < n_valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_rerank_kernel_on_shard_views(cuda_device, dtype):
    """The rerank kernel on a shard's view with local ids equals it on the
    whole store with global ids; candidates all -1 (a shard that owns none)
    give (-inf, -1)."""
    from nvdb_tpu_torch.kernels import rerank

    q, cand, store, sc = _rerank_case(dtype, 8, 64, seed=5)
    q, cand, store = (torch.from_numpy(q).to(cuda_device), torch.from_numpy(cand).to(cuda_device),
                      store.to(cuda_device))
    sc = None if sc is None else torch.from_numpy(sc).to(cuda_device)
    rps, s = 1024, 2
    lid = cand - s * rps
    own = (cand >= 0) & (lid >= 0) & (lid < rps)
    local = torch.where(own, lid, -1).to(torch.int32)
    glob = torch.where(own, cand, -1).to(torch.int32)
    view = store[s * rps:(s + 1) * rps]
    vsc = None if sc is None else sc[s * rps:(s + 1) * rps]
    for metric in ("l2", "dot"):
        lv, li = rerank.rerank_topk_cuda(q, local, view, vsc, 10, metric=metric)
        gv, gi = rerank.rerank_topk_cuda(q, glob, store, sc, 10, metric=metric)
        assert torch.equal(lv, gv) and torch.equal(torch.where(li >= 0, li + s * rps, -1), gi)
        nv, ni = rerank.rerank_topk_cuda(q, torch.full_like(local, -1), view, vsc, 10,
                                         metric=metric)
        assert bool((ni == -1).all()) and bool(torch.isneginf(nv).all())


@pytest.mark.gpu
def test_probe_and_adc_kernels_on_a_shard_of_padding(cuda_device):
    """A shard whose lists are all poisoned padding (nlist 42 over 8 shards:
    the last six lists): the probe kernel and the ADC table, dma and key
    kernels return (-inf, -1) everywhere and read no row of them."""
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist import sharded_ivf
    from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex, _coarse_probes
    from nvdb_tpu_torch.kernels import adc_scan, ivf_scan

    q, _, packed, sids, _ = _probe_case("bf16", 16, 4, seed=3, nlist=42)
    idx = IVFFlatIndex(torch.randn((42, 128)).to(cuda_device), packed.to(cuda_device),
                       sids.to(cuda_device), None, 42 * 160, 128, vecbin.DTYPE_BF16)
    mesh = meshmod.row_mesh(8, devices=[cuda_device] * 8)
    sh = sharded_ivf.ShardedIVFFlatIndex.from_index(idx, mesh)
    last = 7
    assert bool((sh.slot_ids[last] == -1).all()) and int(sh.fills(last).max()) == 0
    q = q.to(cuda_device)
    probes = _coarse_probes(q, sh.centroids[last], sh.slot_ids[last], 6).to(torch.int32)
    kv, ki = ivf_scan.ivf_probe_topk_cuda(q, probes, sh.packed[last], sh.slot_ids[last], None,
                                          10, fills=sh.fills(last))
    assert bool((ki == -1).all()) and bool(torch.isneginf(kv).all())

    idx_pq, q_rot = _ivfpq_on_card(cuda_device, nlist=42)
    spq = sharded_ivf.ShardedIVFPQIndex.from_index(idx_pq, mesh)
    assert bool((spq.slot_ids[last] == -1).all()) and spq.ids_mode() == "key"
    pr = _coarse_probes(q_rot, spq.centroids[last], spq.slot_ids[last], 6).to(torch.int32)
    fills = spq.fills(last)
    lut = adc_scan.adc_tables_cuda(q_rot, pr, spq.centroids[last], spq.codebooks[last], fills)
    for v, i in (adc_scan.adc_topk_cuda(lut, pr, spq.codes[last], spq.slot_ids[last], 50,
                                        fills=fills),
                 adc_scan.adc_topk_keys_cuda(lut, pr, spq.codes[last], spq.slot_ids[last], 50,
                                             fills=fills)):
        assert bool((i == -1).all()) and bool(torch.isneginf(v).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f32", "i8"])
def test_sharded_flat_index_on_one_card_is_flat_index(cuda_device, dtype):
    """``ShardedFlatIndex`` over four shards of ``cuda:0`` (views of one
    store, the last one short of valid rows): values bit-equal to
    ``FlatIndex`` on the same store, ids equal wherever the values are not
    tied; the flat kernel launches once a shard."""
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import ShardedVectorStore, VectorStore

    base = synth.normalized_gaussian(20000, 200, seed=51)
    queries = synth.normalized_gaussian(64, 200, seed=52)
    store = VectorStore.from_numpy(base, dtype, row_block=1024, n_shards=4, device=cuda_device)
    mesh = meshmod.row_mesh(4, devices=[cuda_device] * 4)
    sh = ShardedVectorStore.from_store(store, mesh)
    assert sh.vectors[0].data_ptr() == store.vectors.data_ptr()
    before = flat_scan.LAUNCHES
    sv, si = ShardedFlatIndex(sh).search(queries, 10)
    assert flat_scan.LAUNCHES == before + 4
    fv, fi = FlatIndex(store).search(queries, 10)
    np.testing.assert_array_equal(sv, fv)
    untied = np.ones_like(sv, dtype=bool)
    untied[:, 1:] &= sv[:, 1:] != sv[:, :-1]
    untied[:, :-1] &= sv[:, :-1] != sv[:, 1:]
    assert (si[untied] == fi[untied]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_sharded_ivfpq_and_refine_on_one_card(cuda_device, metric):
    """Four shards of ``cuda:0``: the sharded IVF-PQ search with a
    row-sharded refine store runs the table, key and rerank kernels once a
    shard, and gives the plain path's answer (values to 1e-4 where the ids
    agree, ids at >= 0.9 of positions)."""
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist import sharded_ivf
    from nvdb_tpu_torch.kernels import adc_scan, rerank
    from nvdb_tpu_torch.store import ShardedVectorStore

    idx, q = _ivfpq_on_card(cuda_device)
    mesh = meshmod.row_mesh(4, devices=[cuda_device] * 4)
    sh = sharded_ivf.ShardedIVFPQIndex.from_index(idx, mesh)
    rng = np.random.default_rng(17)
    rows = rng.standard_normal((idx.n, idx.centroids.shape[1])).astype(np.float32)
    store = ShardedVectorStore.from_numpy(rows, mesh, "f32", row_block=1024)
    before = (adc_scan.TABLE_LAUNCHES, adc_scan.KEY_LAUNCHES, rerank.LAUNCHES)
    kv, ki = sh.search_device(q, 10, 8, refine_k=50, refine_store=store, refine_metric=metric)
    torch.cuda.synchronize()
    assert (adc_scan.TABLE_LAUNCHES, adc_scan.KEY_LAUNCHES, rerank.LAUNCHES) == tuple(
        x + 4 for x in before)
    pv, pi = sh.search_device(q, 10, 8, refine_k=50, refine_store=store, backend="torch",
                              refine_metric=metric)
    same = ki == pi
    assert float(same.float().mean()) >= 0.9
    assert torch.allclose(kv[same], pv[same], atol=1e-4, rtol=1e-4)


# -- the A/B tools and the probes on the card -----------------------------------

def _tool(main, argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return buf.getvalue(), out


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["gen4", "gen6"])
def test_adc_ab_pairs_bit_identical(cuda_device, mode):
    """gen4 (full width against the live prefix) and gen6 (key against the
    gather kernel, the slab made inside the arm and beforehand): each pair
    bit-identical, which the tool checks before timing (it exits 1 if not)."""
    from nvdb_tpu_torch.tools import adc_ab

    _, recs = _tool(adc_ab.main, ["--mode", mode, "--nlist", "512", "--lcap", "256",
                                  "--b", "16", "--pairs", "2", "--chain", "2"])
    assert recs and all(r["id_match"] == 1.0 for r in recs)
    assert all(r["device"] != "cpu" and r["power_limit_w"] is not None for r in recs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,arms", [("bf16", "kernel,library,plain"),
                                        ("f32", "kernel,simt,library,plain"),
                                        ("i8", "kernel,plain")])
def test_kernel_ab_check_on_card(cuda_device, dtype, arms):
    from nvdb_tpu_torch.tools import kernel_ab

    text, recs = _tool(kernel_ab.main, ["--n", "70001", "--dtype", dtype, "--batches", "37,8",
                                        "--ks", "10,64", "--arms", arms, "--iters", "2",
                                        "--pairs", "2", "--check"])
    assert len(recs) == 4 * len(arms.split(",")) and text.count("# check arm=") == len(recs)


@pytest.mark.gpu
def test_refine_ab_check_on_card(cuda_device):
    from nvdb_tpu_torch.tools import refine_ab

    for dtype in ("bf16", "i8"):
        _, recs = _tool(refine_ab.main, ["--n", "50000", "--dtype", dtype, "--batches", "8,64",
                                         "--rs", "50,100", "--pairs", "2", "--chain", "2",
                                         "--check"])
        assert len(recs) == 4 and all(r["cuda_ms"] > 0 for r in recs)


@pytest.mark.gpu
def test_adc_rank_probe_tables_kernel_matches_plain_tables(cuda_device, tmp_path):
    """bf16lut with the serving path's table kernel against the same probe
    with the plain tables (``--backend torch``): within 0.002."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.formats import gtbin
    from nvdb_tpu_torch.tools import adc_rank_probe

    n, d = 20000, 128
    base = synth.clustered(n, d, n_clusters=32, seed=3)
    q, _ = synth.sample_queries(base, 64, seed=4, perturb=0.05)
    vecbin.write_vecbin(str(tmp_path / "q.vecbin"), q)
    s64 = q.astype(np.float64) @ base.astype(np.float64).T
    gtbin.write_gtbin(str(tmp_path / "gt.gtbin"),
                      np.argsort(-s64, axis=1)[:, :10].astype(np.int32), dim=d, N=n)
    IVFPQIndex.build(base, nlist=64, m=16, use_opq=False, train_size=n, n_iters=4, seed=1,
                     device=cuda_device).save(str(tmp_path / "idx.npz"))
    argv = [str(tmp_path / n_) for n_ in ("idx.npz", "q.vecbin", "gt.gtbin")]
    argv += ["--nprobe", "8", "--rk", "16", "64", "--score-mode", "bf16lut"]
    _, card = _tool(adc_rank_probe.main, argv)
    _, plain = _tool(adc_rank_probe.main, argv + ["--backend", "torch"])
    assert all(abs(card[r] - plain[r]) <= 0.002 for r in (16, 64)), (card, plain)


@pytest.mark.gpu
def test_tool_mesh_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    """Two ranks of ``tools.bench --shards 2`` on cuda:0 (gloo: NCCL refuses
    two ranks on one card), each with one shard: recall 1 against the
    one-process ids."""
    from nvdb_tpu_torch.dist import _worker
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex
    from nvdb_tpu_torch.formats import gtbin
    from nvdb_tpu_torch.store import ShardedVectorStore

    n, d = 9000, 64
    base = synth.clustered(n, d, n_clusters=16, seed=5)
    q, _ = synth.sample_queries(base, 16, seed=6, perturb=0.05)
    vecbin.write_vecbin(str(tmp_path / "base.vecbin"), base)
    vecbin.write_vecbin(str(tmp_path / "q.vecbin"), q)
    mesh = meshmod.row_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    _, ids = ShardedFlatIndex(ShardedVectorStore.from_vecbin(str(tmp_path / "base.vecbin"),
                                                             mesh)).search(q, 10)
    gtbin.write_gtbin(str(tmp_path / "one.gtbin"), ids.astype(np.int32), dim=d, N=n)
    runs = _worker.run_ranks([str(tmp_path / "base.vecbin"), str(tmp_path / "q.vecbin"), "10",
                              "--gt", str(tmp_path / "one.gtbin"), "--shards", "2",
                              "--batch-q", "8"], nproc=2, timeout=240,
                             module="nvdb_tpu_torch.tools.bench")
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, out
        assert f"process {rank}/2" in out and "backend=gloo" in out and "global_devices=2" in out
        assert "recall=1.000000" in out, out
