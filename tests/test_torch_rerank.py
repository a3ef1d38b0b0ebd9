"""Exact-rerank parity of the PyTorch port against the JAX package: the plain
version of the rerank kernel (``rerank_topk_reference``) against
``pallas_rerank`` in interpret mode and ``ops.exact_rerank``, per store type
and metric, with -1 padding, B not a multiple of 8 and R not a multiple of
16; ``dispatch.exact_refine`` on each path; ``dedup_topk``; the store's
``norms2``.

Tolerances: values to atol 1e-5 / rtol 1e-5 (f32 sums in another order);
score regret <= 1e-5 against float64 over the stored rows as the store holds
them (bf16 values exactly, int8 dequantized). Ids are compared through the
regret, not position by position: ``lax.top_k`` ties to the lower index, the
port to the larger id. The CUDA kernel's own tests are in test_torch_gpu.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nvdb_tpu.kernels import ops as jops
from nvdb_tpu.kernels.rerank import pallas_rerank
from nvdb_tpu.store import VectorStore as JVectorStore
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.kernels import dispatch, ops, rerank
from nvdb_tpu_torch.store import VectorStore

N, D, B, R, K = 1024, 128, 12, 37, 10


def _case(dtype, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((N, D), dtype=np.float32)
    q = rng.standard_normal((B, D), dtype=np.float32)
    cand = np.stack([rng.choice(N, R, replace=False) for _ in range(B)]).astype(np.int32)
    cand[0, 20:] = -1            # padded candidates never rank
    cand[5, 3:] = -1             # fewer valid candidates than k
    sc = None
    if dtype == "f32":
        jv, tv, eff = base, torch.from_numpy(base), base.astype(np.float64)
    elif dtype == "bf16":
        bits = vecbin.to_bf16(base)
        jv, tv = bits.view(ml_dtypes.bfloat16), vecbin.bf16_bits_to_torch(bits)
        eff = vecbin.bf16_to_f32(bits).astype(np.float64)
    else:
        codes, sc = vecbin.quantize_i8(base)
        jv, tv = codes, torch.from_numpy(codes)
        eff = codes.astype(np.float64) * sc[:, None]
    return dict(q=q, cand=cand, jv=jv, tv=tv, sc=sc, eff=eff)


def _scores64(c, metric):
    rows = c["eff"][np.maximum(c["cand"], 0)]                      # [B, R, D]
    s = np.einsum("bd,brd->br", c["q"].astype(np.float64), rows)
    if metric == "l2":
        s = 2.0 * s - np.sum(rows * rows, axis=-1)
    return np.where(c["cand"] >= 0, s, -np.inf)


def _check(vals, ids, c, metric, k=K):
    """Sorted, regret <= 1e-5 against float64, values equal to the float64
    scores of the chosen ids, (-inf, -1) where too few candidates."""
    s64 = _scores64(c, metric)
    for b in range(B):
        live = int((c["cand"][b] >= 0).sum())
        kk = min(k, live)
        ref = np.sort(s64[b])[::-1][:kk]
        pos = {int(i): j for j, i in enumerate(c["cand"][b]) if i >= 0}
        got = np.array([s64[b, pos[int(i)]] for i in ids[b, :kk]])
        assert np.max(ref - np.sort(got)[::-1]) <= 1e-5
        np.testing.assert_allclose(vals[b, :kk], got, atol=1e-5, rtol=1e-5)
        assert np.all(np.diff(vals[b, :kk]) <= 0)
        assert (ids[b, kk:] == -1).all() and np.isneginf(vals[b, kk:]).all()
        assert len(set(ids[b, :kk].tolist())) == kk


def _port(c, metric):
    n2 = rerank.store_norms2(c["tv"]) if metric == "l2" else None
    sc = torch.from_numpy(c["sc"]) if c["sc"] is not None else None
    return rerank.rerank_topk_reference(torch.from_numpy(c["q"]),
                                        torch.from_numpy(c["cand"]), c["tv"], sc, K,
                                        norms2=n2, metric=metric)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_reference_matches_pallas_rerank(dtype, metric):
    c = _case(dtype)
    tv, ti = (x.numpy() for x in _port(c, metric))
    _check(tv, ti, c, metric)
    jsc = jnp.asarray(c["sc"]) if c["sc"] is not None else None
    pv, pi = pallas_rerank(jnp.asarray(c["q"]), jnp.asarray(c["cand"]),
                           jnp.asarray(c["jv"]), jsc, K, metric=metric, chunk=8, bq=4,
                           interpret=True)
    pv = np.asarray(pv)
    for b in range(B):
        kk = min(K, int((c["cand"][b] >= 0).sum()))
        np.testing.assert_allclose(tv[b, :kk], pv[b, :kk], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_reference_matches_exact_rerank(dtype, metric):
    c = _case(dtype, seed=8)
    tv, ti = (x.numpy() for x in _port(c, metric))
    rows = np.where(c["cand"][..., None] >= 0,
                    c["eff"].astype(np.float32)[np.maximum(c["cand"], 0)], 0)
    jv, ji = jops.exact_rerank(jnp.asarray(c["q"]), jnp.asarray(rows),
                               jnp.asarray(c["cand"]), K, metric=metric)
    jv = np.asarray(jv)
    for b in range(B):
        kk = min(K, int((c["cand"][b] >= 0).sum()))
        np.testing.assert_allclose(tv[b, :kk], jv[b, :kk], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_exact_refine_paths(backend, metric):
    """auto on the CPU (the JAX package's gather path) and torch (the
    kernel's plain version) give the same top-k; cuda raises on the CPU."""
    c = _case("i8", seed=9)
    st = VectorStore.from_numpy(c["jv"], dtype="i8", scales=c["sc"], row_block=256,
                                device="cpu")
    q, cand = torch.from_numpy(c["q"]), torch.from_numpy(c["cand"])
    n2 = st.norms2() if metric == "l2" else None
    v, i = dispatch.exact_refine(q, cand, st.vectors, st.scales, K, metric=metric,
                                 norms2=n2, backend=backend)
    _check(v.numpy(), i.numpy(), c, metric)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.exact_refine(q, cand, st.vectors, st.scales, K, metric=metric,
                              norms2=n2, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rerank.rerank_topk_cuda(q, cand, st.vectors, st.scales, K, norms2=n2,
                                metric=metric)


def test_repeated_id_taken_once():
    c = _case("f32", seed=10)
    c["cand"][2, 1] = c["cand"][2, 0]
    c["cand"][2, 7] = c["cand"][2, 0]
    tv, ti = (x.numpy() for x in _port(c, "dot"))
    assert len(set(ti[2].tolist())) == K
    # the repeated row counts once: the values are the k best distinct scores
    top = _scores64(c, "dot")[2]
    distinct = np.unique(top[np.isfinite(top)])[::-1][:K]
    np.testing.assert_allclose(tv[2], distinct, atol=1e-5, rtol=1e-5)


def test_dedup_topk_matches_jax():
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((6, 40)).astype(np.float32)
    ids = rng.integers(0, 15, (6, 40)).astype(np.int32)
    tv, ti = ops.dedup_topk(torch.from_numpy(vals), torch.from_numpy(ids), 8)
    jv, ji = jops.dedup_topk(jnp.asarray(vals), jnp.asarray(ids), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for row in ti.numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_store_norms2_matches_jax(dtype):
    base = np.random.default_rng(12).standard_normal((300, 100)).astype(np.float32)
    t = VectorStore.from_numpy(base, dtype=dtype, row_block=256, device="cpu")
    j = JVectorStore.from_numpy(base, dtype=dtype, row_block=256)
    np.testing.assert_allclose(t.norms2().numpy(), np.asarray(j.norms2()),
                               atol=1e-4, rtol=1e-6)
    assert t.norms2() is t.norms2()  # cached
