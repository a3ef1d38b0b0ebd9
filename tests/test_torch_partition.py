"""Partition-then-rerank parity of the PyTorch port against
``nvdb_tpu.index.partition`` at the sizes of test_partition.py or smaller
(6000 x 64 "hard" rows, Dp 128, nlist 32, 16 queries): a JAX-built index
carried across with ``from_reference`` and searched by both packages with
the f32 and the residual-int8 refine, ``tune_nprobe``, save / load with
``refine_rows`` in both directions, and the port's own build.

Tolerances. Values: 1e-5 abs + 1e-5 rel (f32 sums in another order). Ids:
>= 99% equal (the packages break exact score ties differently). Builds draw
other random numbers than JAX: recall@10 within 0.02 of the JAX-built
index's, with the residual store's invariants exact (each row's list is the
list it is packed in; its codes are ``quantize_i8(row - cent[list])``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.index.partition import PartitionRerankIndex as JPartition
from nvdb_tpu_torch.index import partition
from nvdb_tpu_torch.index.partition import PartitionRerankIndex

N, D, DP, NLIST, Q, K, RERANK_K = 6000, 64, 128, 32, 16, 10, 50
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def world():
    base = jsynth.hard(N, D, intrinsic=16, topics=32, seed=3)
    queries, _ = jsynth.sample_queries(base, Q, seed=4, perturb=0.05)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    gt = np.argsort(-s64, axis=1, kind="stable")[:, :K]
    j = JPartition.build(base, nlist=NLIST, n_iters=6, seed=1)
    jres = JPartition(ivf=j.ivf, refine_store=JPartition._residual_store(base, j.ivf))
    return dict(base=base, q=queries, gt=gt, j={"f32": j, "res_i8": jres})


def _ivf_args(jivf):
    return dict(centroids=np.asarray(jivf.centroids), packed=np.asarray(jivf.packed),
                slot_ids=np.asarray(jivf.slot_ids),
                slot_scales=(None if jivf.slot_scales is None
                             else np.asarray(jivf.slot_scales)),
                n=jivf.n, d=jivf.d, dtype_code=jivf.dtype_code, n_spilled=jivf.n_spilled)


def _port_of(j):
    s = j.refine_store
    refine = dict(vectors=np.asarray(s.vectors),
                  scales=None if s.scales is None else np.asarray(s.scales),
                  n=s.n, d=s.d, dtype_code=s.dtype_code, src_dtype_code=s.src_dtype_code)
    if s.is_residual:
        refine.update(res_cents=np.asarray(s.res_cents), res_ids=np.asarray(s.res_ids))
    return PartitionRerankIndex.from_reference(_ivf_args(j.ivf), refine, device="cpu")


def _recall(ids, gt):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("n", [1000, 4000, 10 ** 6, 10 ** 9])
def test_auto_nlist_is_the_jax_rule(n):
    want = int(np.clip(2 ** int(np.round(np.log2(np.sqrt(n) * 2))), 16, 8192))
    assert partition.auto_nlist(n) == want
    assert partition.auto_nlist(10 ** 6) == 2048


def test_build_takes_the_auto_nlist(world):
    rows = world["base"][:1000]
    t = PartitionRerankIndex.build(rows, n_iters=2, with_refine=False, device="cpu")
    j = JPartition.build(rows, n_iters=2, with_refine=False)
    assert t.ivf.nlist == j.ivf.nlist == 64
    assert t.refine_store is None
    with pytest.raises(ValueError, match="refine_dtype"):
        PartitionRerankIndex.build(rows, refine_dtype="i4", device="cpu")


@pytest.mark.parametrize("refine", ["f32", "res_i8"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_search_matches_jax(world, refine, backend):
    j = world["j"][refine]
    t = _port_of(j)
    assert t.refine_store.is_residual == (refine == "res_i8")
    assert t.index_bytes == j.index_bytes and t.n == j.n == N
    for rerank_k in (0, RERANK_K):
        jv, ji = j.search(world["q"], K, 4, rerank_k=rerank_k)
        tv, ti = t.search(world["q"], K, 4, rerank_k=rerank_k, backend=backend)
        assert tv.shape == (Q, K)
        np.testing.assert_allclose(tv, np.asarray(jv), atol=ATOL, rtol=RTOL)
        assert np.mean(ti == np.asarray(ji)) >= 0.99


@pytest.mark.parametrize("refine", ["f32", "res_i8"])
def test_search_device_matches_jax(world, refine):
    j = world["j"][refine]
    t = _port_of(j)
    qp = np.zeros((Q, DP), np.float32)
    qp[:, :D] = world["q"]
    jv, ji = j.search_device(jnp.asarray(qp), K, 6, rerank_k=RERANK_K)
    tv, ti = t.search_device(torch.from_numpy(qp), K, 6, rerank_k=RERANK_K)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
    assert np.mean(ti.numpy() == np.asarray(ji)) >= 0.99
    # the rerank lifts recall over the bf16 probe alone
    _, pi = t.search(world["q"], K, 6)
    assert _recall(ti.numpy(), world["gt"]) >= _recall(pi, world["gt"])


def test_tune_nprobe_matches_jax(world):
    j = world["j"]["f32"]
    t = _port_of(j)
    for target in (0.5, 0.9, 1.01):
        assert t.tune_nprobe(world["q"], world["gt"], K, target_recall=target) == \
            j.tune_nprobe(world["q"], world["gt"], K, target_recall=target)


def test_save_load_with_refine_rows_both_ways(world, tmp_path):
    j = world["j"]["f32"]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j.save(jpath)
    t = PartitionRerankIndex.load(jpath, refine_rows=world["base"], device="cpu")
    assert t.refine_store.n == N and not t.refine_store.is_residual
    jv, ji = j.search(world["q"], K, 4, rerank_k=RERANK_K)
    tv, ti = t.search(world["q"], K, 4, rerank_k=RERANK_K)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=ATOL, rtol=RTOL)
    assert np.mean(ti == np.asarray(ji)) >= 0.99
    t.save(tpath)
    back = JPartition.load(tpath, refine_rows=world["base"])
    bv, bi = back.search(world["q"], K, 4, rerank_k=RERANK_K)
    np.testing.assert_array_equal(np.asarray(bi), np.asarray(ji))
    # without refine rows the index is probe-only
    bare = PartitionRerankIndex.load(tpath, device="cpu")
    assert bare.refine_store is None
    _, pi = bare.search(world["q"], K, 4, rerank_k=RERANK_K)
    _, jpi = j.search(world["q"], K, 4)
    assert np.mean(pi == np.asarray(jpi)) >= 0.99


@pytest.mark.parametrize("refine", ["f32", "res_i8"])
def test_port_build_recall_near_jax(world, refine):
    base = world["base"]
    t = PartitionRerankIndex.build(base, nlist=NLIST, n_iters=6, seed=1, refine_dtype=refine,
                                   device="cpu")
    j = world["j"][refine]
    assert (t.ivf.nlist, t.ivf.lcap) == (j.ivf.nlist, j.ivf.lcap)
    assert t.ivf.packed.dtype == torch.bfloat16
    store = t.refine_store
    if refine == "res_i8":
        sids = t.ivf.slot_ids.numpy()
        li, si = np.nonzero(sids >= 0)
        list_of = np.empty(N, np.int64)
        list_of[sids[li, si]] = li
        np.testing.assert_array_equal(store.res_ids.numpy()[:N], list_of)
        cents = t.ivf.centroids.numpy()
        rows = np.zeros((N, DP), np.float32)
        rows[:, :D] = base
        codes, sc = jvecbin.quantize_i8(rows - cents[list_of])
        np.testing.assert_array_equal(store.vectors.numpy()[:N], codes)
        np.testing.assert_array_equal(store.scales.numpy()[:N], sc)
        np.testing.assert_array_equal(store.res_cents.numpy(), cents)
    else:
        np.testing.assert_array_equal(store.vectors.numpy()[:N, :D], base)
    _, ti = t.search(world["q"], K, 4, rerank_k=RERANK_K)
    _, ji = j.search(world["q"], K, 4, rerank_k=RERANK_K)
    assert _recall(ti, world["gt"]) >= _recall(np.asarray(ji), world["gt"]) - 0.02


def test_coarse_terms_cached_and_search_unchanged(world):
    """The partition and its IVF-Flat index cache ||c||^2 and the live-list
    mask of the coarse ranking; probes and results are bit-equal to the
    ranking that recomputes them on every batch."""
    from nvdb_tpu_torch.index import ivf_flat

    t = _port_of(world["j"]["f32"])
    assert t.coarse_terms() is t.ivf.coarse_terms() is t.coarse_terms()
    ivf = t.ivf
    q = torch.zeros((Q, DP))
    q[:, :D] = torch.from_numpy(world["q"])
    before = ivf_flat._coarse_probes(q, ivf.centroids, ivf.slot_ids, 8)
    after = ivf_flat._coarse_probes(q, ivf.centroids, ivf.slot_ids, 8,
                                    terms=ivf.coarse_terms())
    np.testing.assert_array_equal(before.numpy(), after.numpy())
    v0, i0 = ivf_flat._ivf_search_block(q, ivf.centroids, ivf.packed, ivf.slot_ids,
                                        ivf.slot_scales, K, 8)
    v1, i1 = t.search_device(q, K, 8)
    np.testing.assert_array_equal(v0.numpy(), v1.numpy())
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
