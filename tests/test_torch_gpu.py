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
