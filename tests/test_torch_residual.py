"""Residual-int8 stores in the PyTorch port against the JAX package: a store
of int8 codes of (row - centroid) with row i = res_cents[res_ids[i]] +
scales[i] * codes[i]. Its dequantized ``norms2``, and the residual fold of
the rerank (score = amul * dot(q, codes) - boff with q.cent folded into
boff) in the kernel's plain version, against ``pallas_rerank(res_cents=...,
interpret=True)`` and the jnp branch of ``dispatch.exact_refine``, for
metrics dot and l2.

Tolerances: values 1e-5 abs + 1e-5 rel (f32 sums in another order; the fold
adds q.cent after the code dot where the jnp branch dequantizes first); ids
by float64 score regret <= 1e-5 over the dequantized rows (the packages
break ties differently).

End to end (``IVFPQIndex.search_device`` with a residual store, the port of
tests/test_residual_store.py::test_search_device_residual_end_to_end): on a
JAX-built index carried across, the residual store ranks at least as well
as a plain int8 store at a candidate depth where the ADC set is complete,
and the final ids agree with the JAX ``search_device`` on the same index,
store and queries at >= 0.95 of positions (values to 1e-4: the refine
scores rotated queries against the dequantized rows in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from nvdb_tpu.kernels import dispatch as jdispatch
from nvdb_tpu.kernels.rerank import pallas_rerank
from nvdb_tpu.store import VectorStore as JVectorStore
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.kernels import dispatch, rerank
from nvdb_tpu_torch.store import VectorStore

N, D, NLIST, B, R, K = 3000, 64, 16, 12, 40, 8
ATOL = RTOL = 1e-5
REGRET_TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    base = jsynth.clustered(N, D, n_clusters=NLIST, spread=0.4, seed=17)
    rng = np.random.default_rng(18)
    cents = base[rng.choice(N, NLIST, replace=False)] * 0.9
    list_of = np.argmax(base @ cents.T - 0.5 * (cents * cents).sum(1), axis=1).astype(np.int32)
    codes, sc = vecbin.quantize_i8(base - cents[list_of])
    j = JVectorStore.from_numpy(codes, "i8", scales=sc, row_block=128)
    j.attach_residual(cents, list_of)
    t = VectorStore.from_numpy(codes, "i8", scales=sc, row_block=128, device="cpu")
    t.attach_residual(cents, list_of)
    q = rng.standard_normal((B, t.d_padded)).astype(np.float32)
    q[:, D:] = 0.0
    cand = np.stack([rng.choice(N, R, replace=False) for _ in range(B)]).astype(np.int32)
    cand[0, 25:] = -1                    # padded candidates never rank
    cand[3, 5:] = -1                     # fewer valid candidates than k
    deq = cents[list_of].astype(np.float64) + codes.astype(np.float64) * sc[:, None]
    return dict(j=j, t=t, q=q, cand=cand, deq=deq, cents=cents, list_of=list_of)


def _regret(c, ids, metric, k=K):
    """Worst float64 regret of ``ids`` over each query's valid candidates."""
    worst = 0.0
    for b in range(B):
        live = c["cand"][b][c["cand"][b] >= 0]
        rows = c["deq"][live]
        s = rows @ c["q"][b, :D].astype(np.float64)
        if metric == "l2":
            s = 2.0 * s - (rows * rows).sum(1)
        score = dict(zip(live.tolist(), s.tolist()))
        ref = sorted(score.values(), reverse=True)[:k]
        got = sorted((score[i] for i in ids[b].tolist() if i >= 0), reverse=True)
        assert len(got) == len(ref)
        worst = max(worst, max((r - g for r, g in zip(ref, got)), default=0.0))
    return worst


def test_store_fields_and_norms2_match_jax(case):
    j, t = case["j"], case["t"]
    assert t.is_residual and j.is_residual
    np.testing.assert_array_equal(t.res_cents.numpy(), np.asarray(j.res_cents))
    np.testing.assert_array_equal(t.res_ids.numpy(), np.asarray(j.res_ids))
    n2 = t.norms2().numpy()
    np.testing.assert_allclose(n2, np.asarray(j.norms2()), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(n2[:N], (case["deq"] ** 2).sum(1), atol=ATOL, rtol=RTOL)
    assert t.norms2() is t.norms2()          # cached


def test_attach_residual_resets_norms_and_needs_int8(case):
    codes = case["t"].vectors[:N, :D].numpy()
    s = VectorStore.from_numpy(codes, "i8", scales=case["t"].scales[:N].numpy(),
                               row_block=128, device="cpu")
    plain = s.norms2().clone()
    s.attach_residual(case["cents"], case["list_of"])
    assert not torch.equal(s.norms2(), plain)
    f = VectorStore.from_numpy(np.zeros((4, D), np.float32), "f32", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        f.attach_residual(case["cents"], np.zeros(4, np.int32))


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_fold_matches_pallas_rerank(case, metric):
    j, t = case["j"], case["t"]
    pv, pi = pallas_rerank(jnp.asarray(case["q"]), jnp.asarray(case["cand"]), j.vectors,
                           j.scales, K, metric=metric,
                           norms2=j.norms2() if metric == "l2" else None,
                           res_cents=j.res_cents, res_ids=j.res_ids, interpret=True)
    tv, ti = rerank.rerank_topk_reference(
        torch.from_numpy(case["q"]), torch.from_numpy(case["cand"]), t.vectors, t.scales, K,
        norms2=t.norms2() if metric == "l2" else None, metric=metric,
        res_cents=t.res_cents, res_ids=t.res_ids)
    tv, ti, pv, pi = tv.numpy(), ti.numpy(), np.asarray(pv), np.asarray(pi)
    assert ((ti >= 0) == (pi >= 0)).all()
    np.testing.assert_allclose(tv, pv, atol=ATOL, rtol=RTOL)
    assert _regret(case, ti, metric) <= REGRET_TOL
    assert _regret(case, pi, metric) <= REGRET_TOL


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_exact_refine_matches_jax_jnp(case, metric, backend):
    """``auto`` on the CPU is the port of the jnp branch (dequantize, then
    rerank); ``torch`` is the kernel's plain version (the fold)."""
    j, t = case["j"], case["t"]
    n2j = j.norms2() if metric == "l2" else None
    jv, ji = jdispatch.exact_refine(jnp.asarray(case["q"]), jnp.asarray(case["cand"]),
                                    j.vectors, j.scales, K, metric=metric, norms2=n2j,
                                    backend="jnp", res_cents=j.res_cents, res_ids=j.res_ids)
    tv, ti = dispatch.exact_refine(torch.from_numpy(case["q"]), torch.from_numpy(case["cand"]),
                                   t.vectors, t.scales, K, metric=metric,
                                   norms2=t.norms2() if metric == "l2" else None,
                                   backend=backend, res_cents=t.res_cents,
                                   res_ids=t.res_ids)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, np.asarray(jv), atol=ATOL, rtol=RTOL)
    assert ((ti >= 0) == (np.asarray(ji) >= 0)).all()
    assert _regret(case, ti, metric) <= REGRET_TOL


def test_residual_l2_needs_dequantized_norms(case):
    t = case["t"]
    args = (torch.from_numpy(case["q"]), torch.from_numpy(case["cand"]), t.vectors, t.scales, K)
    with pytest.raises(ValueError, match="DEQUANTIZED norms2"):
        rerank.rerank_topk_reference(*args, metric="l2", res_cents=t.res_cents,
                                     res_ids=t.res_ids)
    with pytest.raises(ValueError, match="need scales and res_ids"):
        rerank.rerank_topk_reference(*args, metric="dot", res_cents=t.res_cents)


@pytest.fixture(scope="module")
def built():
    """A JAX-built IVF-OPQ-PQ index, the port's copy of it, and residual and
    plain int8 stores of its base in both packages (residual encode as
    ``tools.quantize_i8 --residual`` does it)."""
    base = jsynth.clustered(6000, 64, n_clusters=32, seed=17)
    j = JIVFPQIndex.build(base, nlist=16, m=16, use_opq=True, train_size=6000, seed=2)
    t = IVFPQIndex.from_reference(np.asarray(j.rotation), np.asarray(j.centroids),
                                  np.asarray(j.codebooks), np.asarray(j.codes),
                                  np.asarray(j.slot_ids), j.n, j.d, j.m, device="cpu")
    dp = t.centroids.shape[1]
    rows = np.pad(base, ((0, 0), (0, dp - base.shape[1]))) @ np.asarray(j.rotation)
    sids = np.asarray(j.slot_ids)
    li, si = np.nonzero(sids >= 0)
    list_of = np.zeros(base.shape[0], np.int32)
    list_of[sids[li, si]] = li.astype(np.int32)
    cents = np.asarray(j.centroids)
    codes, sc = vecbin.quantize_i8(rows - cents[list_of])
    stores = {}
    for name, cls, kw in (("j", JVectorStore, {}), ("t", VectorStore, {"device": "cpu"})):
        st = cls.from_numpy(codes, "i8", scales=sc, row_block=128, **kw)
        st.attach_residual(cents, list_of)
        pc, ps = vecbin.quantize_i8(base)
        stores[name] = (st, cls.from_numpy(pc, "i8", scales=ps, row_block=128, **kw))
    queries, _ = jsynth.sample_queries(base, 32, seed=19, perturb=0.03)
    qp = np.zeros((queries.shape[0], dp), np.float32)
    qp[:, :queries.shape[1]] = queries
    s64 = queries.astype(np.float64) @ base.T.astype(np.float64)
    ref_ids = np.argsort(-s64, axis=1, kind="stable")[:, :10]
    return dict(j=j, t=t, stores=stores, qp=qp, ref_ids=ref_ids)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_search_device_residual_end_to_end(built, backend):
    """At refine depth 256 the ADC candidate set is complete, so the
    residual store's recall isolates refine precision: at least the plain
    int8 store's, at least 0.95, and the JAX package's on the same inputs.
    ``auto`` on the CPU is the oracle (jnp) path, ``torch`` the kernels'
    plain versions (key-mode candidates, the fold of the rerank)."""
    res, plain = built["stores"]["t"]
    jres, _ = built["stores"]["j"]

    def rec(ids):
        return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                        for a, b in zip(np.asarray(ids), built["ref_ids"])])

    q = torch.from_numpy(built["qp"])
    kw = dict(refine_k=256, backend=backend)
    v_res, i_res = built["t"].search_device(q, 10, 16, refine_store=res, **kw)
    _, i_pl = built["t"].search_device(q, 10, 16, refine_store=plain, **kw)
    assert rec(i_res) >= rec(i_pl) - 1e-9
    assert rec(i_res) >= 0.95
    jv, ji = built["j"].search_device(jnp.asarray(built["qp"]), 10, 16, refine_k=256,
                                      refine_store=jres, backend="jnp")
    assert np.mean(i_res.numpy() == np.asarray(ji)) >= 0.95
    np.testing.assert_allclose(v_res.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-5)
    assert abs(rec(i_res) - rec(ji)) <= 0.01


def test_search_device_residual_l2_uses_dequantized_norms(built):
    """The l2 refine of a residual store folds the dequantized rows' norms
    (``store.norms2``): the torch path's values are 2 q_rot.r - ||r||^2 over
    r = cent + s * codes, as a float64 rescoring of its ids gives them."""
    res, _ = built["stores"]["t"]
    t = built["t"]
    q = torch.from_numpy(built["qp"][:8])
    v, i = t.search_device(q, 10, 16, refine_k=64, refine_store=res, backend="torch",
                           refine_metric="l2")
    q_rot = (q.double() @ t.rotation.double())
    rows = (res.res_cents[res.res_ids[i.long()].long()].double()
            + res.vectors[i.long()].double() * res.scales[i.long()].double()[..., None])
    want = 2.0 * torch.einsum("bd,bkd->bk", q_rot, rows) - (rows * rows).sum(-1)
    np.testing.assert_allclose(v.numpy(), want.numpy(), atol=1e-3, rtol=1e-5)
