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
port to the larger id. ``_kernel_model`` is a plain-torch model of the CUDA
kernel's contract (the fold inside the kernel from scales / norms2 / qcent
and a metric flag, duplicates of an earlier slot struck, selection by rank
counting): it equals ``rerank_topk_reference`` bit for bit, since both take
the same products. The CUDA kernel's own tests are in test_torch_gpu.py."""

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


def _kernel_model(q, cand, vectors, scales, norms2, qcent, metric, k):
    """The CUDA kernel's contract in plain torch: per candidate, amul and
    boff from ``scales`` / ``norms2`` / ``qcent`` (any may be None) and the
    metric, with the kernel's own products in its order; ids outside
    [0, Np) never scored; an id that an earlier slot holds struck; then each
    candidate's rank is the number of candidates whose (score, id) beats
    it, and rank < k writes slot ``rank`` of a (-inf, -1) list."""
    B, R = cand.shape
    ok = (cand >= 0) & (cand < vectors.shape[0])
    safe = torch.where(ok, cand, 0).long()
    dots = torch.einsum("bd,brd->br", q, vectors[safe].to(torch.float32))
    sc = scales[safe] if scales is not None else None
    if metric == "dot":
        amul = sc if sc is not None else torch.ones((B, R))
        boff = -qcent if qcent is not None else torch.zeros((B, R))
    else:
        n2 = norms2[safe]
        if qcent is not None:
            amul, boff = 2.0 * sc, n2 - 2.0 * qcent
        elif sc is not None:
            amul, boff = 2.0 * sc, (sc * sc) * n2
        else:
            amul, boff = torch.full((B, R), 2.0), n2
    s = torch.where(ok, amul * dots - boff, float("-inf"))
    ids = torch.where(ok, cand, -1)
    same = (ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0)      # [B, r, r2]
    earlier = torch.tril(torch.ones((R, R), dtype=torch.bool), diagonal=-1)   # r2 < r
    s = torch.where((same & earlier).any(-1), float("-inf"), s)
    beats = (s[:, None, :] > s[:, :, None]) | ((s[:, None, :] == s[:, :, None])
                                               & (ids[:, None, :] > ids[:, :, None]))
    rank = beats.sum(-1)                                                      # [B, R]
    out_v = torch.full((B, k), float("-inf"))
    out_i = torch.full((B, k), -1, dtype=torch.int32)
    for b in range(B):
        sel = (ids[b] >= 0) & (s[b] > float("-inf")) & (rank[b] < k)
        assert len(set(rank[b][sel].tolist())) == int(sel.sum())   # every rank taken once
        out_v[b, rank[b][sel]] = s[b][sel]
        out_i[b, rank[b][sel]] = ids[b][sel]
    return out_v, out_i


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_kernel_model_matches_reference_and_pallas(dtype, metric):
    c = _case(dtype, seed=13)
    c["cand"][2, 1] = c["cand"][2, 0]            # a repeated id
    c["cand"][2, 30] = c["cand"][2, 0]
    c["cand"][4, 2] = N + 7                      # an id past the store
    q, cand = torch.from_numpy(c["q"]), torch.from_numpy(c["cand"])
    sc = torch.from_numpy(c["sc"]) if c["sc"] is not None else None
    n2 = rerank.store_norms2(c["tv"]) if metric == "l2" else None
    mv, mi = _kernel_model(q, cand, c["tv"], sc, n2, None, metric, K)
    c["cand"][4, 2] = -1                         # the plain version's fold indexes by id
    rv, ri = _port(c, metric)
    np.testing.assert_array_equal(mv.numpy(), rv.numpy())
    np.testing.assert_array_equal(mi.numpy(), ri.numpy())
    jsc = jnp.asarray(c["sc"]) if c["sc"] is not None else None
    c["cand"][2, 1] = c["cand"][2, 30] = -1      # the repeats count once: drop them
    _check(mv.numpy(), mi.numpy(), c, metric)    # for the oracles, which take unique ids
    pv, _ = pallas_rerank(jnp.asarray(c["q"]), jnp.asarray(c["cand"]), jnp.asarray(c["jv"]),
                          jsc, K, metric=metric, chunk=8, bq=4, interpret=True)
    pv = np.asarray(pv)
    for b in range(B):
        kk = min(K, int((c["cand"][b] >= 0).sum()))
        np.testing.assert_allclose(mv.numpy()[b, :kk], pv[b, :kk], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_kernel_model_residual_fold(metric):
    """Residual-int8 store: q.cent is gathered in torch (``residual_qcent``)
    and folded per candidate; the model equals the plain version bit for
    bit and ``pallas_rerank(res_cents=...)`` in interpret mode to 1e-5."""
    rng = np.random.default_rng(14)
    nlist = 8
    cents = rng.standard_normal((nlist, D)).astype(np.float32)
    list_of = rng.integers(0, nlist, N).astype(np.int32)
    rows = cents[list_of] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    codes, scn = vecbin.quantize_i8(rows - cents[list_of])
    deq = cents[list_of].astype(np.float64) + codes.astype(np.float64) * scn[:, None]
    n2 = (deq * deq).sum(1).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    cand = np.stack([rng.choice(N, R, replace=False) for _ in range(B)]).astype(np.int32)
    cand[0, 20:] = -1
    t = lambda a: torch.from_numpy(a)
    qcent = rerank.residual_qcent(t(q), t(cand), t(cents), t(list_of))
    mv, mi = _kernel_model(t(q), t(cand), t(codes), t(scn), t(n2) if metric == "l2" else None,
                           qcent, metric, K)
    rv, ri = rerank.rerank_topk_reference(t(q), t(cand), t(codes), t(scn), K,
                                          norms2=t(n2) if metric == "l2" else None,
                                          metric=metric, res_cents=t(cents),
                                          res_ids=t(list_of))
    np.testing.assert_array_equal(mv.numpy(), rv.numpy())
    np.testing.assert_array_equal(mi.numpy(), ri.numpy())
    pv, pi = pallas_rerank(jnp.asarray(q), jnp.asarray(cand), jnp.asarray(codes),
                           jnp.asarray(scn), K, metric=metric, chunk=8, bq=4,
                           norms2=jnp.asarray(n2) if metric == "l2" else None,
                           interpret=True, res_cents=jnp.asarray(cents),
                           res_ids=jnp.asarray(list_of))
    assert ((mi.numpy() >= 0) == (np.asarray(pi) >= 0)).all()
    np.testing.assert_allclose(mv.numpy(), np.asarray(pv), atol=1e-5, rtol=1e-5)
