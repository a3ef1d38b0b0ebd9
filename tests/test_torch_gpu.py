"""The CUDA flat top-k kernel against its plain PyTorch version and a float64
numpy oracle, on a card. Marked ``gpu``: each test asks its fixture for a
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
    kv, ki = rerank.rerank_topk_cuda(q, cand, store, sc, k, norms2=n2, metric=metric)
    torch.cuda.synchronize()
    assert rerank.LAUNCHES == before + 1
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
