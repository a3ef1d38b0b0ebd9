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
# The launches of each kernel of a served search's first call for its shape
# on the card: its eager warm-up, then the replay of the CUDA graph captured
# after it, which serves the call (``nvdb_tpu_torch/index/graphs.py``; the
# capture itself launches nothing and counts nothing).
FIRST_CALL_LAUNCHES = 2


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


# -- the tensor-core kernel's queue, drained under the next tile's products ----
#
# Exact data: entries on a grid of eighths (queries: first dim 1), a "level"
# on the first dim of the rows, all exact in bf16, int8 and the f32 split,
# so every instance's scores equal the plain version's in any order of
# summation and the ids must match it bit for bit, ties by the larger id.

DRAIN_KS = [1, 10, 32, 33, 128]
DRAIN_BATCHES = [1, 64, 65, 512, 513]
DRAIN_ROWS, DRAIN_VALID, DRAIN_DP = 150_000, 149_963, 128


def _tile_rows(dtype):
    return 128 if dtype == "f32" else 256


def _exact_store(dtype, level, b, seed, device):
    """(queries, store, scales, query scales) of an exact case: rows of
    noise in {-2..2} / 8 with ``level`` on their first dim, queries of the
    same noise with 1 on theirs."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = level.shape[0]
    x = torch.randint(-2, 3, (n, DRAIN_DP), generator=g, device=device).float() / 8
    x[:, 0] = level
    q = torch.randint(-2, 3, (b, DRAIN_DP), generator=g, device=device).float() / 8
    q[:, 0] = 1.0
    sc = qs = None
    if dtype == "f32":
        v = x
    elif dtype == "bf16":
        v = x.to(torch.bfloat16)
    else:
        amax = x.abs().amax(dim=1)
        sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        v = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
        if dtype == "i8xi8":
            qa = q.abs().amax(dim=1)
            qs = qa / 127.0
            q = torch.clamp(torch.round(q / qs[:, None]), -127, 127).to(torch.int8)
    return q, v.contiguous(), sc, qs


def _same_as_plain(q, v, sc, qs, n_valid, k):
    kv, ki = flat_scan.flat_topk_cuda(q, v, sc, n_valid, k, query_scales=qs)
    pv, pi = flat_scan.flat_topk_reference(q, v, sc, n_valid, k, query_scales=qs)
    assert torch.equal(ki, pi)
    np.testing.assert_allclose(kv.cpu().numpy(), pv.cpu().numpy(), atol=1e-5, rtol=1e-5)
    return ki


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("k", DRAIN_KS)
@pytest.mark.parametrize("b", DRAIN_BATCHES)
def test_tensor_core_kernel_rising_scores_refill_every_list(cuda_device, dtype, k, b):
    """Scores that rise tile after tile: the first ``hot`` rows of each row
    tile carry the tile's level (8 and 9 a tile: a warp's sixteen queries
    push 128 candidates, a full queue that drains under the next tile's
    products, or 144, an overflow and a rescan every tile), or every row
    does (every list refilled by every tile). n_valid is no multiple of 256."""
    tn = _tile_rows(dtype)
    rows = torch.arange(DRAIN_ROWS, device=cuda_device)
    rise = ((rows // tn) % 256).float() * 32.0
    for hot in (8, 9, tn):
        level = torch.where(rows % tn < hot, rise, torch.zeros_like(rise))
        q, v, sc, qs = _exact_store(dtype, level, b, seed=hot + k + b, device=cuda_device)
        ki = _same_as_plain(q, v, sc, qs, DRAIN_VALID, k)
        # the noise is below a level's step: each best row has the top level
        assert bool((level[ki[:, 0].long()] == level[:DRAIN_VALID].max()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TC_DTYPES)
@pytest.mark.parametrize("k", DRAIN_KS)
@pytest.mark.parametrize("b", DRAIN_BATCHES)
def test_tensor_core_kernel_ties_across_tile_and_slice_edges(cuda_device, dtype, k, b):
    """Four rows of one top score on both sides of the first row tile's end
    and of the first slice's end (the slice count of the wrapper at this B):
    each query's list starts with them by descending id, whichever tile's
    queue held them and whichever slice found them."""
    tn = _tile_rows(dtype)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tiles = -(-DRAIN_VALID // tn)
    S = flat_scan.slice_count(b, DRAIN_VALID, n_sm, flat_scan.TENSOR_CORE)
    edge = -(-tiles // S) * tn   # the first row of the second slice
    assert tn < edge < DRAIN_VALID
    tied = [tn - 1, tn, edge - 1, edge]
    level = torch.zeros(DRAIN_ROWS, device=cuda_device)
    level[tied] = 64.0
    q, v, sc, qs = _exact_store(dtype, level, b, seed=k + b, device=cuda_device)
    for r in tied:   # the four tied rows are one vector
        v[r] = v[tied[0]]
    ki = _same_as_plain(q, v, sc, qs, DRAIN_VALID, k)
    want = torch.tensor(sorted(tied, reverse=True)[:k], dtype=ki.dtype, device=cuda_device)
    assert bool((ki[:, :len(want)] == want).all())


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


@pytest.mark.gpu
@pytest.mark.parametrize("b,p,nlist,m,dsub", [
    (1, 1, 8, 16, 8), (8, 7, 40, 96, 8), (37, 12, 64, 16, 8), (64, 64, 512, 96, 8),
    (5, 3, 20, 32, 4), (5, 3, 20, 64, 12), (5, 3, 20, 8, 16), (5, 3, 20, 4, 32),
    (5, 3, 20, 10, 8)])
def test_tables_kernel_matches_plain(cuda_device, b, p, nlist, m, dsub):
    """Register-resident instances (dsub 4, 8, 12, 16), the any-dsub kernel
    (32), an M off the 8-subspace group (10); dead and out-of-range probes.
    Bit for bit the plain version, which runs the kernel's FMA chains and
    combinations (``adc_scan.fma_chain``). One launch on its counter and one
    of the query-term pass it reads."""
    from nvdb_tpu_torch.kernels import adc_scan

    args = _table_case(b, p, nlist, m, dsub, seed=b * p + m, device=cuda_device)
    before = adc_scan.TABLE_LAUNCHES, adc_scan.QTERM_LAUNCHES
    got, ops_seen = _dispatched_ops(lambda: adc_scan.adc_tables_cuda(*args))
    torch.cuda.synchronize()
    assert (adc_scan.TABLE_LAUNCHES, adc_scan.QTERM_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert [name for name, _ in ops_seen if "empty" not in name] == []
    want = adc_scan.adc_tables_reference(*args)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, p, m, 256)
    live = adc_scan.live_probes(args[1], args[4])
    assert bool((got[~live] == 0).all())
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 256])
@pytest.mark.parametrize("dsub", [3, 4, 8, 12, 16])
def test_query_terms_kernel_matches_plain(cuda_device, b, dsub):
    """The query-term pass, its register instances (dsub 4, 8, 12, 16) and
    the any-dsub one (3), bit for bit its plain version; one launch on its
    counter and no torch operator but the output's allocation."""
    from nvdb_tpu_torch.kernels import adc_scan

    q_rot, _, _, cb, _ = _table_case(b, 1, 8, 64, dsub, seed=b * dsub, device=cuda_device)
    before = adc_scan.QTERM_LAUNCHES
    got, ops_seen = _dispatched_ops(lambda: adc_scan.adc_query_terms_cuda(q_rot, cb))
    torch.cuda.synchronize()
    assert adc_scan.QTERM_LAUNCHES == before + 1
    assert [name for name, _ in ops_seen if "empty" not in name] == []
    want = adc_scan.adc_query_terms_reference(q_rot, cb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 64, 256)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
@pytest.mark.parametrize("replicas,mode", [(1, "key"), (1, "dma"), (2, "dma")])
def test_ivfpq_kernel_path_makes_no_f32_table(cuda_device, replicas, mode):
    """``IVFPQIndex.search_device`` on a CUDA index. The key mode: the
    fused key scan alone (launched by the call's warm-up and by the replay
    of its CUDA graph); the dma mode (ADC-only, and a replicated index): the
    fused dma scan alone; no table kernel and no tensor the size of the
    tables in either. The candidates are the plain path's."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.kernels import adc_scan

    b, p, nlist, m, lcap, k = 16, 8, 40, 16, 256, 20
    _, _, codes, slot_ids = (torch.from_numpy(x).to(cuda_device)
                             for x in _adc_case(b, p, seed=11, nlist=nlist, m=m, lcap=lcap,
                                                dup=replicas > 1))
    q_rot, _, cents, cb, _ = _table_case(b, p, nlist, m, 8, seed=12, device=cuda_device)
    idx = IVFPQIndex(rotation=None, centroids=cents, codebooks=cb, codes=codes,
                     slot_ids=slot_ids, n=nlist * lcap, d=m * 8, m=m, replicas=replicas)
    counts = lambda: (adc_scan.TABLE_LAUNCHES, adc_scan.LAUNCHES, adc_scan.KEY_LAUNCHES,
                      adc_scan.FUSED_LAUNCHES, adc_scan.FUSED_DMA_LAUNCHES)
    before = counts()
    (kv, ki), ops_seen = _dispatched_ops(lambda: idx.search_device(q_rot, k, p, ids_mode=mode))
    torch.cuda.synchronize()
    big = [(name, shape, dt) for name, outs in ops_seen for shape, dt in outs
           if int(np.prod(shape)) >= b * p * m * 256]
    first = FIRST_CALL_LAUNCHES
    assert tuple(a - c for a, c in zip(counts(), before)) == (
        (0, 0, 0, first, 0) if mode == "key" else (0, 0, 0, 0, first))
    assert big == []
    pv, pi = idx.search_device(q_rot, k, p, backend="torch", ids_mode=mode)
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


# -- the fused ADC key scan ---------------------------------------------------------

def _fused_case(b, p, nlist, m, dsub, lcap, seed, device, hot=False, bad=False,
                scarce=False):
    """A prefix-packed index (list 3 dead) with the geometry the tables are
    built from; ``hot``: every query probes list 5; ``bad``: an
    out-of-range probe at each end; ``scarce``: at most 12 rows a list."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nlist, m, lcap)).astype(np.uint8)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        f = int(rng.integers(0, 13 if scarce else lcap + 1)) if li % 4 or scarce else lcap
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[3] = -1
    probes = np.stack([rng.choice(nlist, p, replace=False) for _ in range(b)]).astype(np.int32)
    if hot:
        for r in range(b):
            probes[r] = [5] + [x for x in probes[r] if x != 5][:p - 1]
    if bad:
        probes[0, 0], probes[-1, -1] = -1, nlist + 2
    q_rot, _, cents, cb, _ = _table_case(b, p, nlist, m, dsub, seed=seed, device=device)
    t = lambda x: torch.from_numpy(x).to(device)
    return q_rot, t(probes), cents, cb, t(codes), t(slot_ids)


def _fused_check(q_rot, probes, cents, cb, codes, slot_ids, kk, nq_max=None):
    """The fused scan bit for bit the key mode's plain scan on the table
    kernel's tables and the two-kernel key path; one launch on its counter
    and one of the query-term pass."""
    from nvdb_tpu_torch.kernels import adc_scan

    fills = adc_scan.list_fills(slot_ids)
    lut = adc_scan.adc_tables_cuda(q_rot, probes, cents, cb, fills)
    pv, pi = adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, kk, fills=fills)
    kv, ki = adc_scan.adc_topk_keys_cuda(lut, probes, codes, slot_ids, kk, fills=fills)
    before = adc_scan.FUSED_LAUNCHES, adc_scan.QTERM_LAUNCHES
    fv, fi = adc_scan.adc_fused_keys_cuda(q_rot, probes, cents, cb, codes, slot_ids, kk,
                                          fills=fills, nq_max=nq_max)
    torch.cuda.synchronize()
    assert (adc_scan.FUSED_LAUNCHES, adc_scan.QTERM_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(fv, pv) and torch.equal(fi, pi)
    assert torch.equal(fv, kv) and torch.equal(fi, ki)
    return fv, fi


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(1, 1), (8, 7), (64, 32)])
@pytest.mark.parametrize("kk", [10, 100, 1024])
@pytest.mark.parametrize("nq_max", [1, 8, 32])
def test_fused_keys_matches_the_key_path(cuda_device, b, p, kk, nq_max):
    _fused_check(*_fused_case(b, p, 64, 16, 8, 640, seed=b + p + kk, device=cuda_device,
                              hot=True, bad=True), kk, nq_max=nq_max)


@pytest.mark.gpu
@pytest.mark.parametrize("m,dsub,lcap", [(32, 4, 256), (24, 12, 320), (8, 16, 1024),
                                         (12, 3, 256), (10, 8, 2048), (340, 8, 128)])
def test_fused_keys_dsub_instances_and_widths(cuda_device, m, dsub, lcap):
    """Register codewords (dsub 4, 12, 16), the any-dsub instance (3), an M
    off a multiple of 8 with lists of two tiles (Lcap 2048), and an M as
    wide as the key kernel takes."""
    _fused_check(*_fused_case(16, 8, 40, m, dsub, lcap, seed=m * dsub, device=cuda_device,
                              bad=True), 100)


@pytest.mark.gpu
def test_fused_keys_scarce_lists_and_ties(cuda_device):
    """Fewer live lanes than kk (at most 12 rows a list), and a hot list
    every query probes, split into items of the plan's chunk."""
    fv, fi = _fused_check(*_fused_case(64, 16, 40, 16, 8, 256, seed=3, device=cuda_device,
                                       hot=True, scarce=True), 1024)
    assert bool((fi[:, -1] == -1).all()) and bool(torch.isneginf(fv[:, -1]).all())
    _fused_check(*_fused_case(256, 4, 12, 16, 8, 640, seed=4, device=cuda_device, hot=True),
                 100)


@pytest.mark.gpu
def test_fused_keys_in_a_cuda_graph(cuda_device):
    """No host sync: a captured call replays to the eager call's result."""
    from nvdb_tpu_torch.kernels import adc_scan

    args = _fused_case(32, 16, 40, 16, 8, 640, seed=5, device=cuda_device)
    want = adc_scan.adc_fused_keys_cuda(*args, 100)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adc_scan.adc_fused_keys_cuda(*args, 100)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = adc_scan.adc_fused_keys_cuda(*args, 100)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_fused_keys_rejects_bad_input(cuda_device):
    from nvdb_tpu_torch.kernels import adc_scan

    q, probes, cents, cb, codes, slot_ids = _fused_case(4, 3, 20, 16, 8, 256, seed=6,
                                                        device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_fused_keys_cuda(*(x.cpu() for x in (q, probes, cents, cb, codes,
                                                         slot_ids)), 10)
    with pytest.raises(ValueError, match="outside"):
        adc_scan.adc_fused_keys_cuda(q, probes, cents, cb, codes, slot_ids, 1025)
    with pytest.raises(TypeError):
        adc_scan.adc_fused_keys_cuda(q.double(), probes, cents, cb, codes, slot_ids, 10)
    with pytest.raises(ValueError, match="subspaces"):
        adc_scan.adc_fused_keys_cuda(q, probes, cents, cb[:8].contiguous(), codes, slot_ids,
                                     10)
    with pytest.raises(ValueError, match="16-bit"):
        adc_scan.adc_fused_keys_cuda(
            q[:1], probes[:1, :1], cents, cb,
            torch.zeros((20, 16, 65552), dtype=torch.uint8, device=cuda_device),
            torch.zeros((20, 65552), dtype=torch.int32, device=cuda_device), 10)
    with pytest.raises(ValueError, match="shared memory"):
        # one query's residual norms (M f32) past a CTA's shared memory
        adc_scan.fused_plan(65536, 8, cuda_device.index or 0)


# -- the fused ADC dma scan ---------------------------------------------------------

def _dma_case(b, p, nlist, m, dsub, lcap, seed, device, kind=""):
    """``_fused_case``'s index, every query on list 5, with ``kind``:
    "holes" frees slots below lists' fills; "replicas" also makes list 2 hold
    list 1's ids (probed by every query), list 5 repeat 30 of its rows with
    their codes and give 25 other rows the codes of 25 more (tied scores),
    list 7 repeat 30 ids with other codes and, in lists of two tiles, list 4
    repeat rows across its tiles; "bad": probes out of range."""
    q, probes, cents, cb, codes, sids = _fused_case(b, p, nlist, m, dsub, lcap, seed, device,
                                                    hot=True, bad="bad" in kind)
    if "holes" in kind or "replicas" in kind:
        sids[5, 1::3] = -1
        sids[6, :300:2] = -1
    if "replicas" in kind:
        sids[2] = sids[1]
        sids[5, :30] = sids[5, 40:70]
        codes[5, :, :30] = codes[5, :, 40:70]
        codes[5, :, 70:95] = codes[5, :, 95:120]        # other ids: tied scores
        sids[7, 1:61:2] = sids[7, 60:90]
        if lcap > 1100:
            sids[4, 1030:1060] = sids[4, :30]
        if p >= 3:
            probes[:, 1], probes[:, 2] = 1, 2
    return q, probes, cents, cb, codes, sids


def _dma_check(q_rot, probes, cents, cb, codes, slot_ids, kk, nq_max=None, dedup=True):
    """The fused dma scan bit for bit the staged route (the table kernel,
    then the dma kernel; where its ring plans the shape) and the dma scan's
    plain version on the same tables; one launch on its counter, one of the
    query-term pass and none of the table kernel; each id once a row.
    ``dedup=False`` where the index holds every id once."""
    from nvdb_tpu_torch.kernels import adc_scan

    fills = adc_scan.list_fills(slot_ids)
    lut = adc_scan.adc_tables_cuda(q_rot, probes, cents, cb, fills)
    try:   # the staged route's ring holds a table and a code tile a stage
        adc_scan.scan_plan(kk, codes.shape[1], codes.shape[2])
        sv, si = adc_scan.adc_topk_cuda(lut, probes, codes, slot_ids, kk, fills=fills)
    except ValueError:
        sv = si = None
    ok = (probes >= 0) & (probes < codes.shape[0])
    pv, pi = adc_scan.adc_topk_reference(lut, torch.where(ok, probes, 3), codes, slot_ids, kk)
    counts = lambda: (adc_scan.FUSED_DMA_LAUNCHES, adc_scan.TABLE_LAUNCHES,
                      adc_scan.QTERM_LAUNCHES)
    before = counts()
    fv, fi = adc_scan.adc_fused_topk_cuda(q_rot, probes, cents, cb, codes, slot_ids, kk,
                                          fills=fills, nq_max=nq_max, dedup=dedup)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2] + 1)
    if si is not None:
        assert torch.equal(fv, sv) and torch.equal(fi, si)
    assert torch.equal(fv, pv) and torch.equal(fi, pi)
    for row in fi.cpu().numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    return fv, fi


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(1, 1), (8, 7), (64, 32)])
@pytest.mark.parametrize("kk", [10, 100, 1024])
@pytest.mark.parametrize("kind", ["holes", "replicas bad"])
def test_fused_dma_scan_matches_the_staged_route(cuda_device, b, p, kk, kind):
    """Lists with holes (unique ids: also without the duplicate passes), and
    ids held by two lists and twice by one, with tied scores and probes out
    of range."""
    args = _dma_case(b, p, 64, 16, 8, 640, seed=b + p + kk, device=cuda_device, kind=kind)
    for dedup in (True, False) if kind == "holes" else (True,):
        _dma_check(*args, kk, dedup=dedup)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [256, 8, 1])
@pytest.mark.parametrize("kk", [10, 100])
def test_fused_dma_scan_at_the_flagship_shape(cuda_device, b, kk):
    """M = 96, dsub = 8, Lcap = 640, P = 64, on a replicated index with holes,
    at each chunk width the dma instances are built for."""
    args = _dma_case(b, 64, 512, 96, 8, 640, seed=b + kk, device=cuda_device,
                     kind="replicas")
    for nq_max in (None, 1, 4, 8):
        _dma_check(*args, kk, nq_max=nq_max)


@pytest.mark.gpu
@pytest.mark.parametrize("m,dsub,lcap", [(32, 4, 256), (24, 12, 320), (8, 16, 1024),
                                         (12, 3, 256), (10, 8, 2048), (340, 8, 128)])
def test_fused_dma_scan_dsub_instances_and_widths(cuda_device, m, dsub, lcap):
    """Register codewords (dsub 4, 12, 16), the any-dsub instance (3), lists
    of two tiles (Lcap 2048) whose repeated rows straddle the tiles, a wide
    M, kk 1024 above most lists' rows (at M 340 beyond what the staged
    route's ring holds: the plain version alone is the reference)."""
    for kk in (100, 1024):
        _dma_check(*_dma_case(16, 8, 40, m, dsub, lcap, seed=m * dsub, device=cuda_device,
                              kind="replicas bad"), kk)


@pytest.mark.gpu
def test_fused_dma_scan_plain_version_and_scarce_lists(cuda_device):
    """Against its own plain version (the plain tables: a rare entry one
    bf16 step off, so ids at >= 0.9 of a row's and values to 2^-8 of the
    largest), and with fewer live slots than kk ((-inf, -1) after them)."""
    from nvdb_tpu_torch.kernels import adc_scan

    args = _dma_case(32, 8, 40, 16, 8, 256, seed=7, device=cuda_device, kind="replicas")
    fv, fi = adc_scan.adc_fused_topk_cuda(*args, 50)
    pv, pi = adc_scan.adc_fused_topk_reference(*args, 50)
    assert torch.equal(fi >= 0, pi >= 0)
    fin = fi >= 0
    assert float((fv[fin] - pv[fin]).abs().max()) <= 2.0 ** -8 * float(pv[fin].abs().max())
    for x, y in zip(fi.cpu().numpy(), pi.cpu().numpy()):
        assert len(set(x.tolist()) & set(y.tolist())) >= int(0.9 * len(set(y.tolist())))
    for dedup in (True, False):   # unique ids: the merge's duplicate pass changes nothing
        fv, fi = _dma_check(*_fused_case(64, 16, 40, 16, 8, 256, seed=3, device=cuda_device,
                                         hot=True, scarce=True), 1024, dedup=dedup)
        assert bool((fi[:, -1] == -1).all()) and bool(torch.isneginf(fv[:, -1]).all())


@pytest.mark.gpu
def test_fused_dma_scan_in_a_cuda_graph(cuda_device):
    """No host sync: a captured call replays to the eager call's result."""
    from nvdb_tpu_torch.kernels import adc_scan

    args = _dma_case(32, 16, 40, 16, 8, 640, seed=5, device=cuda_device, kind="replicas")
    leads = adc_scan.tile_leads(args[5])
    want = adc_scan.adc_fused_topk_cuda(*args, 100, leads=leads)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adc_scan.adc_fused_topk_cuda(*args, 100, leads=leads)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = adc_scan.adc_fused_topk_cuda(*args, 100, leads=leads)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_fused_dma_scan_rejects_bad_input(cuda_device):
    from nvdb_tpu_torch.kernels import adc_scan

    q, probes, cents, cb, codes, slot_ids = _fused_case(4, 3, 20, 16, 8, 256, seed=6,
                                                        device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adc_scan.adc_fused_topk_cuda(*(x.cpu() for x in (q, probes, cents, cb, codes,
                                                         slot_ids)), 10)
    with pytest.raises(ValueError, match="outside"):
        adc_scan.adc_fused_topk_cuda(q, probes, cents, cb, codes, slot_ids, 1025)
    with pytest.raises(TypeError):
        adc_scan.adc_fused_topk_cuda(q.double(), probes, cents, cb, codes, slot_ids, 10)
    with pytest.raises(ValueError, match="subspaces"):
        adc_scan.adc_fused_topk_cuda(q, probes, cents, cb[:8].contiguous(), codes, slot_ids,
                                     10)
    with pytest.raises(ValueError, match="multiple of 4"):
        adc_scan.adc_fused_topk_cuda(q, probes, cents, cb, codes[:, :, :254].contiguous(),
                                     slot_ids[:, :254].contiguous(), 10)
    with pytest.raises(TypeError):
        adc_scan.adc_fused_topk_cuda(q, probes, cents, cb, codes, slot_ids, 10,
                                     leads=adc_scan.tile_leads(slot_ids).long())


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
@pytest.mark.parametrize("kind", ["adc-only", "replicated", "holes"])
def test_ivfpq_dma_route_is_the_fused_scan(cuda_device, kind):
    """The dma mode's default route on the card (an ADC-only search of a
    prefix-packed index, a replicated index's and a holed index's refine
    candidates): the fused dma scan (its warm-up and replay) and none of
    the table kernel or the staged scan; bit for bit the staged kernels
    called on the same probes (the table kernel, then the staged dma
    scan), each id once a row."""
    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.kernels import adc_scan

    idx, q = _ivfpq_on_card(cuda_device, replicas=2 if kind == "replicated" else 1)
    if kind == "holes":
        sids = idx.slot_ids.clone()
        sids[5, 1::3] = -1
        idx = IVFPQIndex(rotation=None, centroids=idx.centroids, codebooks=idx.codebooks,
                         codes=idx.codes, slot_ids=sids, n=idx.n, d=idx.d, m=idx.m)
    assert idx.ids_mode() == ("key" if kind == "adc-only" else "dma")
    counts = lambda: (adc_scan.FUSED_DMA_LAUNCHES, adc_scan.TABLE_LAUNCHES, adc_scan.LAUNCHES)
    kw = {} if kind == "adc-only" else {"for_refine": True}
    before = counts()
    fv, fi = idx.search_device(q, 50, 8, **kw)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(counts(), before)) == (FIRST_CALL_LAUNCHES, 0, 0)
    probes = _coarse_probes(q, idx.centroids, idx.slot_ids, 8,
                            terms=idx.coarse_terms()).to(torch.int32)
    fills = idx.fills()
    lut = adc_scan.adc_tables_cuda(q, probes, idx.centroids, idx.codebooks, fills)
    sv, si = adc_scan.adc_topk_cuda(lut, probes, idx.codes, idx.slot_ids, 50, fills=fills)
    assert tuple(a - c for a, c in zip(counts(), before)) == (FIRST_CALL_LAUNCHES, 1, 1)
    assert torch.equal(fv, sv) and torch.equal(fi, si)
    for row in fi.cpu().numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


@pytest.mark.gpu
def test_ivfpq_key_mode_on_a_replicated_index_raises(cuda_device):
    idx, q = _ivfpq_on_card(cuda_device, replicas=2)
    assert idx.ids_mode() == "dma"
    for mode in ("key", "gather"):
        with pytest.raises(ValueError, match="replicas == 1"):
            idx.search_device(q, 10, 8, ids_mode=mode)


def _adc_launches():
    from nvdb_tpu_torch.kernels import adc_scan

    return (adc_scan.TABLE_LAUNCHES, adc_scan.LAUNCHES, adc_scan.KEY_LAUNCHES,
            adc_scan.GATHER_LAUNCHES, adc_scan.FUSED_LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("kk", [10, 300])
@pytest.mark.parametrize("b", [256, 8, 1])
def test_ivfpq_gather_mode_reads_lists_in_place(cuda_device, b, kk):
    """``search_device(ids_mode="gather")`` on a CUDA index at P = 7 (not a
    multiple of the TPU kernel's 4 lists a step): the fused key scan (its
    warm-up and replay), and no table, dma, key or gather kernel, no ``index_select``
    and no tensor the size of the tables or of the code slab. Its values and
    ids are bit for bit the slab route's (the table kernel, then the key
    kernel over ``gather_codes``' slab, called on the same probes), the key
    mode's, and the plain scans' (the key mode's and the slab's) on the
    table kernel's tables; the torch path's within a bf16 step of a rare
    table entry."""
    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes
    from nvdb_tpu_torch.kernels import adc_scan

    p = 7
    idx, q = _ivfpq_on_card(cuda_device, b=b, p=p)
    before = _adc_launches()
    (gv, gi), ops_seen = _dispatched_ops(
        lambda: idx.search_device(q, kk, p, ids_mode="gather"))
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_adc_launches(), before)) == (
        0, 0, 0, 0, FIRST_CALL_LAUNCHES)
    assert not any("index_select" in name for name, _ in ops_seen)
    big = [(name, shape) for name, outs in ops_seen for shape, _ in outs
           if int(np.prod(shape)) >= b * p * idx.m * min(256, idx.lcap)]
    assert big == []
    probes = _coarse_probes(q, idx.centroids, idx.slot_ids, p,
                            terms=idx.coarse_terms()).to(torch.int32)
    fills = idx.fills()
    before = _adc_launches()
    lut = adc_scan.adc_tables_cuda(q, probes, idx.centroids, idx.codebooks, fills)
    tv, ti = adc_scan.adc_topk_keys_cuda(lut, probes, idx.codes, idx.slot_ids, kk, fills=fills,
                                         gathered=True)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_adc_launches(), before)) == (1, 0, 0, 1, 0)
    kv, ki = idx.search_device(q, kk, p, ids_mode="key")
    pv, pi = adc_scan.adc_topk_keys_reference(lut, probes, idx.codes, idx.slot_ids, kk,
                                              fills=fills)
    sv, si = adc_scan.adc_topk_keys_reference(lut, probes,
                                              adc_scan.gather_codes(idx.codes, probes),
                                              idx.slot_ids, kk, fills=fills, gathered=True)
    assert tuple(gv.shape) == tuple(gi.shape) == (b, kk)
    for v, i in ((tv, ti), (kv, ki), (pv, pi), (sv, si)):
        assert torch.equal(gv, v) and torch.equal(gi, i)
    cv, ci = idx.search_device(q, kk, p, backend="torch", ids_mode="gather")
    gv, gi, cv, ci = (x.cpu().numpy() for x in (gv, gi, cv, ci))
    live = np.isfinite(cv)
    assert (np.isfinite(gv) == live).all()
    np.testing.assert_allclose(gv[live], cv[live], atol=2.0 ** -8 * float(np.abs(cv[live]).max()),
                               rtol=0)
    for x, y in zip(gi, ci):
        assert len(set(x.tolist()) & set(y.tolist())) >= int(0.9 * len(set(y.tolist())))


@pytest.mark.gpu
def test_ivfpq_gather_mode_refuses_a_shape_the_fused_scan_cannot_plan(cuda_device):
    """One query's share of a CTA's shared memory past its limit (M 65,536:
    its residual norms alone are 256 KB): the gather mode raises by name, as
    the key and dma modes do, and launches no kernel; none takes its
    two-kernel route."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.kernels import adc_scan

    nlist, m, dsub, lcap = 4, 65536, 1, 16
    g = torch.Generator(device=cuda_device).manual_seed(7)
    cents = torch.randn((nlist, m * dsub), generator=g, device=cuda_device)
    cb = torch.randn((m, 256, dsub), generator=g, device=cuda_device)
    codes = torch.zeros((nlist, m, lcap), dtype=torch.uint8, device=cuda_device)
    slot_ids = torch.arange(nlist * lcap, dtype=torch.int32,
                            device=cuda_device).reshape(nlist, lcap)
    idx = IVFPQIndex(rotation=None, centroids=cents, codebooks=cb, codes=codes,
                     slot_ids=slot_ids, n=nlist * lcap, d=m * dsub, m=m)
    before = _adc_launches(), adc_scan.FUSED_DMA_LAUNCHES
    for mode in ("key", "gather", "dma"):
        with pytest.raises(ValueError, match="shared memory"):
            idx.search_device(cents[:2].contiguous(), 10, 2, ids_mode=mode)
    torch.cuda.synchronize()
    assert (_adc_launches(), adc_scan.FUSED_DMA_LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ivfpq_residual_refine_through_the_kernels(cuda_device, metric):
    """``search_device`` with a residual-int8 refine store on a CUDA index:
    the fused key scan and the rerank kernel, each launched by the call's
    warm-up and by the replay of its CUDA graph (no table kernel, no key
    kernel), and the result is the plain path's: ids at >=
    0.9 of positions (a rare table entry one bf16 step off may change a
    candidate), values where the ids agree to 1e-4."""
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
    counts = lambda: (adc_scan.TABLE_LAUNCHES, adc_scan.KEY_LAUNCHES,
                      adc_scan.FUSED_LAUNCHES, rerank.LAUNCHES)
    before = counts()
    kv, ki = idx.search_device(q, 10, 8, refine_k=50, refine_store=store,
                               refine_metric=metric)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(counts(), before)) == (0, 0, FIRST_CALL_LAUNCHES,
                                                               FIRST_CALL_LAUNCHES)
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


# the probe kernel at the shapes of chip_smoke.py's phase 10
PROBE_SHAPES = [(1, 1, 1), (1, 32, 128), (8, 7, 10), (8, 64, 50), (64, 32, 50), (64, 7, 128),
                (256, 64, 10), (256, 1, 128)]     # (B, P, k)


def _probe_index(dtype, lcap, seed, nlist=80, dp=768):
    """A random packed index of unit rows (padding slots too, so a missed
    mask shows): lists full or partly filled, list 0 dead, list 1 three
    live slots, list 2 a hole every 7th slot."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((nlist, lcap, dp)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        f = lcap if li % 4 == 3 else int(rng.integers(0, lcap + 1))
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[0] = -1
    slot_ids[1, 3:] = -1
    slot_ids[2, ::7] = -1
    sc = None
    if dtype == "f32":
        packed = torch.from_numpy(rows)
    elif dtype == "bf16":
        packed = vecbin.bf16_bits_to_torch(vecbin.to_bf16(rows.reshape(-1, dp))).reshape(
            nlist, lcap, dp)
    else:
        codes, s = vecbin.quantize_i8(rows.reshape(-1, dp))
        packed = torch.from_numpy(codes.reshape(nlist, lcap, dp))
        sc = torch.from_numpy(s.reshape(nlist, lcap))
    return packed, torch.from_numpy(slot_ids), sc


def _probe_table(rng, b, p, nlist=80):
    fixed = [0, 1] if p >= 2 else []
    return np.stack([np.r_[fixed, rng.choice(np.arange(2, nlist), p - len(fixed),
                                             replace=False)] for _ in range(b)]).astype(np.int32)


def _check_probe_kernel(cuda_device, q, probes, packed, sids, sc, k):
    """The list-major kernel against the plain version, one launch. Returns
    its result."""
    from nvdb_tpu_torch.kernels import ivf_scan

    args = [x.to(cuda_device) if x is not None else None for x in (q, probes, packed, sids, sc)]
    pv, pi = (x.cpu().numpy() for x in ivf_scan.ivf_probe_topk_reference(*args, k))
    before = ivf_scan.LAUNCHES
    kv, ki = ivf_scan.ivf_probe_topk_cuda(*args, k)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == before + 1
    kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
    assert ((ki >= 0) == (pi >= 0)).all()
    np.testing.assert_allclose(kv, pv, atol=1e-5, rtol=1e-5)
    assert np.mean(ki == pi) >= 0.99
    for row, vals in zip(ki, kv):
        assert np.all(np.diff(vals[np.isfinite(vals)]) <= 0)
        assert np.isneginf(vals[row < 0]).all()
    return kv, ki


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("lcap", [384, 992])
def test_probe_list_major_matches_plain(cuda_device, dtype, lcap):
    """The list-major kernel against the plain version at every shape of
    chip_smoke's phase 10."""
    packed, sids, sc = _probe_index(dtype, lcap, seed=lcap + len(dtype))
    rng = np.random.default_rng(lcap)
    for b, p, k in PROBE_SHAPES:
        q = torch.from_numpy(rng.standard_normal((b, 768)).astype(np.float32))
        _, ki = _check_probe_kernel(cuda_device, q, torch.from_numpy(_probe_table(rng, b, p)),
                                     packed, sids, sc, k)
        for row in ki:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)   # distinct lists: no id twice


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_probe_list_major_edge_cases(cuda_device, dtype):
    """B = 256 with every query on one full list (eight chunks of it); a
    query that probes one list twice (both copies score, as in the plain
    version); B = 1, P = 1; k = 128; holes inside a list, a dead list and
    out-of-range probes."""
    packed, sids, sc = _probe_index(dtype, 384, seed=7)
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((256, 768)).astype(np.float32))
    _check_probe_kernel(cuda_device, q, torch.full((256, 1), 3, dtype=torch.int32), packed,
                         sids, sc, 10)
    twice = _probe_table(rng, 256, 8)
    twice[:, 3] = twice[:, 2]
    _, ki = _check_probe_kernel(cuda_device, q, torch.from_numpy(twice), packed, sids, sc, 50)
    assert any(len(set(r[r >= 0].tolist())) < (r >= 0).sum() for r in ki)   # ids twice
    _check_probe_kernel(cuda_device, q[:1], torch.tensor([[5]], dtype=torch.int32), packed,
                         sids, sc, 1)
    holes = _probe_table(rng, 64, 6)
    holes[:, 0], holes[:, 2], holes[:, 3] = 2, -1, 10 ** 6
    _check_probe_kernel(cuda_device, q[:64], torch.from_numpy(holes), packed, sids, sc, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("b,p,nlist,q_chunk", [(1, 1, 10, 32), (8, 7, 30, 8), (256, 64, 100, 32),
                                               (64, 32, 4096, 16), (256, 1, 3, 32)])
def test_probe_grouping_matches_plain(cuda_device, b, p, nlist, q_chunk):
    """The kernel's pass 0 against group_pairs_reference: the same items (in
    its own order) and each list's pairs (in the atomics' order)."""
    from nvdb_tpu_torch.kernels import ivf_scan

    rng = np.random.default_rng(b + p)
    probes = torch.from_numpy(rng.integers(-2, nlist + 2, (b, p)).astype(np.int32))
    fills = torch.from_numpy(rng.integers(0, 3, nlist).astype(np.int32))
    order, items = ivf_scan.group_pairs_cuda(probes.to(cuda_device), fills.to(cuda_device),
                                             q_chunk)
    want_order, want_items = ivf_scan.group_pairs_reference(probes, fills, q_chunk)
    key = lambda t: t[torch.argsort(t[:, 0].long() * (1 << 32) + t[:, 1].long())]
    items = key(items.cpu())
    assert torch.equal(items, key(want_items))
    order = order.cpu()
    for lst in torch.unique(items[:, 0]).tolist():
        mine = items[items[:, 0] == lst]
        start, cnt = int(mine[0, 1]), int(mine[:, 2].sum())
        assert sorted(order[start:start + cnt].tolist()) == \
            want_order[start:start + cnt].tolist()


@pytest.mark.gpu
def test_probe_list_major_in_a_cuda_graph(cuda_device):
    """The list-major wrapper has no host sync: a call captured in a CUDA
    graph replays to the eager result, bit for bit."""
    from nvdb_tpu_torch.kernels import ivf_scan

    packed, sids, _ = _probe_index("bf16", 384, seed=3)
    rng = np.random.default_rng(4)
    args = (torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32)).to(cuda_device),
            torch.from_numpy(_probe_table(rng, 64, 16)).to(cuda_device), packed.to(cuda_device),
            sids.to(cuda_device), None, 50)
    fills = ivf_scan.list_fills(args[3])
    fn = lambda: ivf_scan.ivf_probe_topk_cuda(*args, fills=fills)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gv, gi = fn()
    graph.replay()
    ev, ei = fn()
    torch.cuda.synchronize()
    assert torch.equal(gv, ev) and torch.equal(gi, ei)


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
    results (R = 2 takes the fused dma scan with its duplicate pass)."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.kernels import adc_scan

    w = built_pq
    idx = IVFPQIndex.repack(w["idx"], w["base"], pad_factor=2.0, spill_candidates=8,
                            replicas=replicas)
    assert idx.replicas == replicas and idx.device.type == "cuda"
    assert idx.n_spilled < w["idx"].n_spilled
    assert idx.ids_mode() == ("key" if replicas == 1 else "dma")
    before = (adc_scan.FUSED_DMA_LAUNCHES, adc_scan.TABLE_LAUNCHES)
    _, ki = idx.search(w["q"], 10, 4, refine_k=50, refine_store=w["store"])
    _, pi = idx.search(w["q"], 10, 4, refine_k=50, refine_store=w["store"], backend="torch")
    assert float(np.mean(ki == pi)) >= 0.99
    _, cand = idx.search(w["q"], 40, 4)
    if replicas > 1:
        assert adc_scan.FUSED_DMA_LAUNCHES > before[0]
    assert adc_scan.TABLE_LAUNCHES == before[1]
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
    row-sharded refine store runs the fused key scan and the rerank kernel
    once a shard (no table kernel, no key kernel), and gives the plain
    path's answer (values to 1e-4 where the ids agree, ids at >= 0.9 of
    positions)."""
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
    counts = lambda: (adc_scan.TABLE_LAUNCHES, adc_scan.KEY_LAUNCHES,
                      adc_scan.FUSED_LAUNCHES, rerank.LAUNCHES)
    before = counts()
    kv, ki = sh.search_device(q, 10, 8, refine_k=50, refine_store=store, refine_metric=metric)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(counts(), before)) == (0, 0, 4, 4)
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


# -- the recorder's spans around the kernel wrappers ---------------------------------

def _wrapper_call(name, device):
    """(call, its arguments' note) of one kernel wrapper on a small case,
    with the caches a serving caller passes (fills, leads, norms2) made
    beforehand, so that the wrapper's own allocations are all it allocates.
    The probe wrapper gets int64 probes, as the coarse ranking gives them,
    and converts them itself."""
    from nvdb_tpu_torch.kernels import adc_scan, ivf_scan, rerank
    from nvdb_tpu_torch.store import VectorStore

    if name == "flat_topk_cuda":
        rows = synth.clustered(5000, 128, n_clusters=16, seed=35)
        store = VectorStore.from_numpy(rows, "bf16", device=device)
        q = torch.from_numpy(synth.sample_queries(rows, 37, seed=36,
                                                  perturb=0.05)[0]).to(device)
        return lambda: flat_scan.flat_topk_cuda(q, store.vectors, None, store.n, 10)
    if name == "adc_fused_keys_cuda":
        q, probes, cents, cb, codes, sids = _fused_case(64, 32, 40, 16, 8, 256, 31, device)
        fills = adc_scan.list_fills(sids)
        return lambda: adc_scan.adc_fused_keys_cuda(q, probes, cents, cb, codes, sids, 100,
                                                    fills=fills)
    if name == "adc_fused_topk_cuda":
        q, probes, cents, cb, codes, sids = _dma_case(64, 32, 40, 16, 8, 256, 32, device,
                                                      kind="replicas")
        fills, leads = adc_scan.list_fills(sids), adc_scan.tile_leads(sids)
        return lambda: adc_scan.adc_fused_topk_cuda(q, probes, cents, cb, codes, sids, 100,
                                                    fills=fills, leads=leads)
    if name == "ivf_probe_topk_cuda":
        q, probes, packed, sids, sc = (None if x is None else x.to(device)
                                       for x in _probe_case("bf16", 37, 12, 33))
        probes = probes.to(torch.int64)
        fills = adc_scan.list_fills(sids)
        return lambda: ivf_scan.ivf_probe_topk_cuda(q, probes, packed, sids, sc, 50,
                                                    fills=fills)
    q, cand, store, _ = _rerank_case("f32", 37, 100, 34)
    q, cand, store = (torch.from_numpy(x).to(device) if isinstance(x, np.ndarray)
                      else x.to(device) for x in (q, cand, store))
    norms2 = rerank.store_norms2(store)
    return lambda: rerank.rerank_topk_cuda(q, cand, store, None, 10, norms2=norms2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["adc_fused_keys_cuda", "adc_fused_topk_cuda",
                                  "ivf_probe_topk_cuda", "rerank_topk_cuda", "flat_topk_cuda"])
def test_wrapper_span_has_one_launch_and_counts_its_allocations(cuda_device, name):
    """Recorded, a wrapper is one span of its own name with exactly one
    ``launch`` child; its ``alloc_bytes`` is what the caching allocator was
    asked for during the call (the fused key scan's span also carries its
    plan's ``nq``); the answers are bit for bit the unrecorded call's."""
    from nvdb_tpu_torch.eval import trace

    call = _wrapper_call(name, cuda_device)
    v0, i0 = call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(cuda_device)["requested_bytes.all.allocated"]
    with trace.recording() as tr:
        v1, i1 = call()
    asked = torch.cuda.memory_stats(cuda_device)["requested_bytes.all.allocated"] - before
    torch.cuda.synchronize()
    assert [(r.name, r.parent) for r in tr.records] == [(name, -1), ("launch", 0)]
    root, launch = tr.records
    assert root.start_ns <= launch.start_ns <= launch.end_ns <= root.end_ns
    nq = {"nq": root.attrs.get("nq")} if name == "adc_fused_keys_cuda" else {}
    assert root.attrs == {"alloc_bytes": asked, **nq} and asked > 0
    assert nq.get("nq", 1) in (1, 4, 8, 16, 32)
    assert launch.attrs == {}
    assert torch.equal(i0, i1) and torch.equal(v0.view(torch.int32), v1.view(torch.int32))


def _served_on_card(cuda_device, n_queries=64):
    """A small IVF-PQ index with an f32 refine store and a partition index
    of one corpus on the card; ``n_queries`` queries; each served call, and
    its chain run eagerly as ``search_device`` resolves it."""
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.index.partition import PartitionRerankIndex
    from nvdb_tpu_torch.store import VectorStore

    rows = synth.clustered(6000, 128, n_clusters=32, seed=8)
    q = torch.from_numpy(synth.sample_queries(rows, n_queries, seed=9,
                                              perturb=0.05)[0]).to(cuda_device)
    pq_idx = IVFPQIndex.build(rows, nlist=32, m=16, train_size=4000, n_iters=4, opq_iters=2,
                              seed=0, device=cuda_device)
    store = VectorStore.from_numpy(rows, "f32", device=cuda_device)
    part = PartitionRerankIndex.build(rows, nlist=32, n_iters=4, seed=1, device=cuda_device)
    served = {
        "ivfpq": lambda x, **kw: pq_idx.search_device(x, 10, 8, refine_k=50,
                                                      refine_store=store, **kw),
        "partition": lambda x, **kw: part.search_device(x, 10, 8, rerank_k=50, **kw),
    }
    eager = {
        "ivfpq": lambda x, backend="auto": pq_idx._search_chain(
            x, 10, 8, 50, store, backend, "l2", pq_idx.ids_mode()),
        "partition": lambda x, backend="auto": part._search_chain(
            x, 10, 8, 50, part.refine_store, backend),
    }
    return {"ivfpq": pq_idx, "partition": part}, served, eager, q


def _same(a, b):
    """Bit for bit: ids equal, f32 values equal as their int32 bits."""
    return torch.equal(a[1], b[1]) and torch.equal(a[0].view(torch.int32),
                                                   b[0].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ivfpq", "partition"])
@pytest.mark.parametrize("b", [1, 8, 256])
def test_served_search_replays_bit_for_bit(cuda_device, kind, b):
    """Five distinct batches in a row through ``search_device``: one capture,
    then four replays, each answer bit for bit the eager chain's on its
    batch; each call's tensors unchanged by the calls after it. The launch
    counters count the kernels that ran: the capture call's warm-up and
    replay, then one a replay (IVF-PQ: the query-term pass as often as the
    fused scan)."""
    from nvdb_tpu_torch.index import graphs
    from nvdb_tpu_torch.kernels import adc_scan, ivf_scan, rerank

    idxs, served, eager, q = _served_on_card(cuda_device, n_queries=5 * b)
    counts = lambda: (rerank.LAUNCHES, adc_scan.FUSED_LAUNCHES + adc_scan.FUSED_DMA_LAUNCHES
                      if kind == "ivfpq" else ivf_scan.LAUNCHES,
                      adc_scan.QTERM_LAUNCHES if kind == "ivfpq" else ivf_scan.LAUNCHES)
    before = counts()
    graphs.reset_counts()
    got = []
    for j in range(5):
        x = q[j * b:(j + 1) * b]
        v, i = served[kind](x)
        got.append((x, (v, i), (v.clone(), i.clone())))
    torch.cuda.synchronize()
    assert (graphs.GRAPH_CAPTURES, graphs.GRAPH_REPLAYS, graphs.GRAPH_EAGER) == (1, 4, 0)
    assert tuple(a - c for a, c in zip(counts(), before)) == (FIRST_CALL_LAUNCHES + 4,) * 3
    assert len(idxs[kind]._graphs) == 1
    for x, out, kept in got:
        assert _same(out, kept)
        assert _same(out, eager[kind](x))
    assert not all(torch.equal(a[1][1], c[1][1]) for a, c in zip(got, got[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ivfpq", "partition"])
def test_served_search_captures_a_graph_a_batch_size(cuda_device, kind):
    """A second batch size captures a second graph; each size then
    replays its own."""
    from nvdb_tpu_torch.index import graphs

    idxs, served, eager, q = _served_on_card(cuda_device)
    graphs.reset_counts()
    for x in (q[:32], q[:8], q[32:], q[8:16]):
        assert _same(served[kind](x), eager[kind](x))
    assert (graphs.GRAPH_CAPTURES, graphs.GRAPH_REPLAYS, graphs.GRAPH_EAGER) == (2, 2, 0)
    assert len(idxs[kind]._graphs) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind,route", [
    (kind, route) for kind in ("ivfpq", "partition")
    for route in ("debug_nans", "torch", "force_torch", "refine_jnp")])
def test_served_search_eager_routes_capture_nothing(cuda_device, monkeypatch, kind, route):
    """``DEBUG_NANS``, ``backend="torch"``, ``NVDB_FORCE_TORCH=1`` and
    ``NVDB_REFINE_BACKEND=jnp`` run eagerly on the card: the root span's
    ``graph`` is ``"eager"``, no graph is captured, and the answers are bit
    for bit the chain's run directly on the same route."""
    from nvdb_tpu_torch.eval import trace
    from nvdb_tpu_torch.index import graphs

    idxs, served, eager, q = _served_on_card(cuda_device)
    kw = {"torch": {"backend": "torch"}}.get(route, {})
    if route == "debug_nans":
        monkeypatch.setattr(dispatch, "DEBUG_NANS", True)
    if route == "force_torch":
        monkeypatch.setenv("NVDB_FORCE_TORCH", "1")
    if route == "refine_jnp":
        monkeypatch.setenv("NVDB_REFINE_BACKEND", "jnp")
    graphs.reset_counts()
    with trace.recording() as tr:
        v, i = served[kind](q, **kw)
    torch.cuda.synchronize()
    assert (graphs.GRAPH_CAPTURES, graphs.GRAPH_REPLAYS, graphs.GRAPH_EAGER) == (0, 0, 1)
    assert len(idxs[kind]._graphs) == 0
    assert tr.records[0].attrs["graph"] == "eager"
    assert "replay" not in [r.name for r in tr.records]
    assert _same((v, i), eager[kind](q, kw.get("backend", "auto")))


@pytest.mark.gpu
def test_served_search_spans_on_the_card(cuda_device):
    """Both served paths on the card, recorded: a capture call's records
    nest root -> stage -> wrapper -> ``launch`` as an eager call's do, then
    one ``replay``; a replay call is its root (``graph="replay"``) and one
    ``replay`` child. One request a call; the answers are bit for bit an
    unrecorded replay's and the eager chain's."""
    from nvdb_tpu_torch.eval import trace

    idxs, served, eager, q = _served_on_card(cuda_device)
    scan = ("adc_fused_keys_cuda" if idxs["ivfpq"].ids_mode() == "key"
            else "adc_fused_topk_cuda")
    trees = {
        "ivfpq": [("ivfpq.search", None), ("rotate", "ivfpq.search"),
                  ("coarse", "ivfpq.search"), ("adc", "ivfpq.search"),
                  (scan, "adc"), ("launch", scan),
                  ("refine", "ivfpq.search"), ("rerank_topk_cuda", "refine"),
                  ("launch", "rerank_topk_cuda")],
        "partition": [("partition.search", None), ("ivfflat.search", "partition.search"),
                      ("coarse", "ivfflat.search"), ("probe", "ivfflat.search"),
                      ("ivf_probe_topk_cuda", "probe"), ("launch", "ivf_probe_topk_cuda"),
                      ("refine", "partition.search"), ("rerank_topk_cuda", "refine"),
                      ("launch", "rerank_topk_cuda")],
    }
    for kind, call in served.items():
        root = trees[kind][0][0]
        with trace.recording() as tr:
            v1, i1 = call(q)
            v2, i2 = call(q)
        v3, i3 = call(q)
        torch.cuda.synchronize()
        assert _same((v1, i1), (v3, i3)) and _same((v2, i2), (v3, i3))
        assert _same((v3, i3), eager[kind](q))
        names = [r.name for r in tr.records]
        tree = [(r.name, None if r.parent < 0 else names[r.parent]) for r in tr.records]
        assert tree == trees[kind] + [("replay", root), (root, None), ("replay", root)]
        assert [r.request for r in tr.records] == [0] * 10 + [1] * 2
        roots = [r for r in tr.records if r.parent < 0]
        assert [r.attrs["graph"] for r in roots] == ["capture", "replay"]
        assert all(r.attrs.get("alloc_bytes", 0) > 0 for r in tr.records
                   if r.name.endswith("_cuda"))


# -- the flat index on the served path ----------------------------------------------

FLAT_KINDS = ["bf16", "i8", "i8xi8_refine", "f32"]
FLAT_INSTANCE = {"bf16": "bf16", "i8": "int8", "i8xi8_refine": "int8_int8",
                 "f32": "f32_tensor_core"}


def _flat_on_card(cuda_device, kind, n_queries):
    """A ``FlatIndex`` of ``kind`` (its store type, or the exact-i8 mode:
    int8 x int8 scan, then the exact refine of its 50 best) over 20,000
    rows of 256 dims on the card, and ``n_queries`` queries."""
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import VectorStore

    rows = synth.clustered(20000, 256, n_clusters=32, seed=11)
    q = torch.from_numpy(synth.sample_queries(rows, n_queries, seed=12,
                                              perturb=0.05)[0]).to(cuda_device)
    store = VectorStore.from_numpy(rows, "i8" if kind.startswith("i8") else kind,
                                   device=cuda_device)
    return FlatIndex(store, quantize_queries=kind == "i8xi8_refine", refine_k=50), q


@pytest.mark.gpu
@pytest.mark.parametrize("kind", FLAT_KINDS)
@pytest.mark.parametrize("b", [1, 37, 512])
def test_served_flat_search_replays_bit_for_bit(cuda_device, kind, b):
    """Four distinct batches in a row through ``FlatIndex.search_device``:
    one capture, then three replays, each answer bit for bit the eager
    chain's on its batch and unchanged by the calls after it. The flat
    kernel's counters (and the rerank's in the exact-i8 mode) count the
    kernels that ran: the capture call's warm-up and replay, then one a
    replay."""
    from nvdb_tpu_torch.index import graphs
    from nvdb_tpu_torch.kernels import rerank

    idx, q = _flat_on_card(cuda_device, kind, 4 * b)
    inst = FLAT_INSTANCE[kind]
    counts = lambda: (flat_scan.LAUNCHES, flat_scan.LAUNCHES_BY_KERNEL[inst], rerank.LAUNCHES)
    graphs.reset_counts()
    got = []
    for j in range(4):
        before = counts()
        x = q[j * b:(j + 1) * b]
        v, i = idx.search_device(x, 10)
        step = FIRST_CALL_LAUNCHES if j == 0 else 1
        assert tuple(a - c for a, c in zip(counts(), before)) == (
            step, step, step if kind == "i8xi8_refine" else 0)
        got.append((x, (v, i), (v.clone(), i.clone())))
    torch.cuda.synchronize()
    assert (graphs.GRAPH_CAPTURES, graphs.GRAPH_REPLAYS, graphs.GRAPH_EAGER) == (1, 3, 0)
    assert len(idx._graphs) == 1
    for x, out, kept in got:
        assert _same(out, kept)
        assert _same(out, idx._search_chain(x, 10))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "i8xi8_refine"])
def test_served_flat_search_spans_on_the_card(cuda_device, kind):
    """Recorded, a capture call's records nest root -> wrapper -> ``launch``
    (in the exact-i8 mode then ``refine`` -> rerank wrapper -> ``launch``),
    then one ``replay``; the next call is its root (``graph="replay"``) and
    one ``replay`` child; the wrappers count their allocations."""
    from nvdb_tpu_torch.eval import trace

    idx, q = _flat_on_card(cuda_device, kind, 64)
    tree = [("flat.search", None), ("flat_topk_cuda", "flat.search"),
            ("launch", "flat_topk_cuda")]
    if kind == "i8xi8_refine":
        tree += [("refine", "flat.search"), ("rerank_topk_cuda", "refine"),
                 ("launch", "rerank_topk_cuda")]
    with trace.recording() as tr:
        a = idx.search_device(q, 10)
        b = idx.search_device(q, 10)
    torch.cuda.synchronize()
    assert _same(a, b) and _same(b, idx._search_chain(q, 10))
    names = [r.name for r in tr.records]
    got = [(r.name, None if r.parent < 0 else names[r.parent]) for r in tr.records]
    assert got == tree + [("replay", "flat.search"), ("flat.search", None),
                          ("replay", "flat.search")]
    roots = [r for r in tr.records if r.parent < 0]
    assert [r.attrs for r in roots] == [{"b": 64, "k": 10, "graph": "capture"},
                                        {"b": 64, "k": 10, "graph": "replay"}]
    assert all(r.attrs.get("alloc_bytes", 0) > 0 for r in tr.records
               if r.name.endswith("_cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["debug_nans", "torch", "l2"])
def test_served_flat_search_eager_routes_capture_nothing(cuda_device, monkeypatch, route):
    """``DEBUG_NANS``, ``backend="torch"`` and metric ``l2`` run eagerly on
    the card: no graph is captured, the root says ``eager``, and the
    answers are the chain's run directly."""
    from nvdb_tpu_torch.eval import trace
    from nvdb_tpu_torch.index import graphs
    from nvdb_tpu_torch.index.flat import FlatIndex

    idx, q = _flat_on_card(cuda_device, "f32", 16)
    if route == "debug_nans":
        monkeypatch.setattr(dispatch, "DEBUG_NANS", True)
    else:
        idx = FlatIndex(idx.store, backend="torch" if route == "torch" else "auto",
                        metric="l2" if route == "l2" else "dot")
    graphs.reset_counts()
    with trace.recording() as tr:
        out = idx.search_device(q, 10)
    torch.cuda.synchronize()
    assert (graphs.GRAPH_CAPTURES, graphs.GRAPH_REPLAYS, graphs.GRAPH_EAGER) == (0, 0, 1)
    assert len(idx._graphs) == 0 and tr.records[0].attrs["graph"] == "eager"
    assert _same(out, idx._search_chain(q, 10))


# -- the OpenAI width: cell ivfpq1536.b256's shapes ------------------------------

@pytest.mark.gpu
def test_fused_keys_at_m128_lcap1536(cuda_device):
    """The fused key scan at the cell's batch and widths (B 256, P 64,
    M 128, dsub 12, Lcap 1536): most lists filled past one 768-lane tile,
    so a pair's list spans two tile CTAs; bit for bit its plain version
    and the two-kernel key path, and the span carries the plan's width."""
    from nvdb_tpu_torch.eval import trace
    from nvdb_tpu_torch.kernels import adc_scan

    args = _fused_case(256, 64, 256, 128, 12, 1536, seed=1536, device=cuda_device, hot=True)
    assert int((adc_scan.list_fills(args[5]) > adc_scan.FUSED_TILE).sum()) > 128
    _fused_check(*args, 50)
    with trace.recording() as tr:
        adc_scan.adc_fused_keys_cuda(*args, 50)
    span = next(r for r in tr.records if r.name == "adc_fused_keys_cuda")
    assert span.attrs["nq"] == adc_scan.fused_plan(128, adc_scan.FUSED_NQ_MAX,
                                                    torch.cuda.current_device())


@pytest.mark.gpu
def test_rerank_reads_rows_past_2_31_elements(cuda_device):
    """A 1.5M x 1536 f32 store holds 2.3e9 elements: candidates whose row
    starts past 2^31 are read whole, as the plain version reads them (values
    within 1e-5, the same ids), and the last row wins where it is best."""
    from nvdb_tpu_torch.kernels import rerank

    n, dp, b, r, k = 1_500_000, 1536, 8, 50, 10
    g = torch.Generator(device=cuda_device).manual_seed(31)
    store = torch.randn((n, dp), generator=g, device=cuda_device)
    store /= torch.linalg.vector_norm(store, dim=1, keepdim=True)
    q = torch.randn((b, dp), generator=g, device=cuda_device)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    far = (1 << 31) // dp + 1                            # the first row past 2^31 elements
    cand = torch.randint(far, n, (b, r), generator=g, device=cuda_device).to(torch.int32)
    cand[:, :5] = torch.randint(0, far, (b, 5), generator=g, device=cuda_device).to(torch.int32)
    cand[0, 0] = n - 1
    store[n - 1] = q[0]                                  # the best row of query 0, at the end
    n2 = rerank.store_norms2(store)
    for metric in ("l2", "dot"):
        kv, ki = rerank.rerank_topk_cuda(q, cand, store, None, k, norms2=n2, metric=metric)
        pv, pi = rerank.rerank_topk_reference(q, cand, store, None, k, norms2=n2, metric=metric)
        torch.cuda.synchronize()
        torch.testing.assert_close(kv, pv, atol=1e-5, rtol=1e-5)
        assert torch.equal(ki, pi)
        assert int(ki[0, 0]) == n - 1


@pytest.mark.gpu
def test_ivfpq_build_on_the_card_and_the_host_path(cuda_device, monkeypatch):
    """The build with its padded corpus on the card (every span says
    ``device``, nothing crosses after the upload), and a repack of its
    rows with the corpus on the card or, with no memory to spare for it,
    on the host and streamed in chunks: the same slots and codes bit for
    bit (a build's k-means sums by atomics, so two builds differ), every
    row placed once, the spans saying where the corpus lived."""
    from nvdb_tpu_torch.eval import trace
    from nvdb_tpu_torch.index import ivf_pq

    rows = synth.normalized_gaussian(40_000, 1536, seed=15)
    with trace.recording() as tr:
        idx = ivf_pq.IVFPQIndex.build(rows, nlist=64, m=128, train_size=20_000, n_iters=4,
                                      opq_iters=2, seed=3, device=cuda_device)
    spans = [r for r in tr.records if r.name.startswith("build.")]
    assert len(spans) == 8 and {r.attrs["where"] for r in spans} == {"device"}
    assert sum(r.attrs["h2d_bytes"] + r.attrs["d2h_bytes"] for r in spans[1:]) == 0
    built = {}
    for where, budget in (("device", None), ("host", 0)):
        monkeypatch.setattr(ivf_pq, "_DEVICE_BUILD_BYTES", budget)
        with trace.recording() as tr:
            built[where] = ivf_pq.IVFPQIndex.repack(idx, rows, pad_factor=3.0)
        spans = [r for r in tr.records if r.name.startswith("build.")]
        assert {r.attrs["where"] for r in spans} == {where} and len(spans) == 5
        moved = sum(r.attrs["h2d_bytes"] + r.attrs["d2h_bytes"] for r in spans[1:])
        assert (moved > 0) == (where == "host")
    dev, host = built["device"], built["host"]
    assert torch.equal(dev.slot_ids, host.slot_ids) and torch.equal(dev.codes, host.codes)
    live = dev.slot_ids[dev.slot_ids >= 0]
    assert torch.equal(torch.sort(live).values,
                       torch.arange(40_000, device=cuda_device, dtype=torch.int32))
