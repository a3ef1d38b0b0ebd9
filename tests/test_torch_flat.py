"""Flat-scan parity of the PyTorch port against the JAX package: the port's
plain ops and dispatch against ``nvdb_tpu.kernels.ops.scan_topk`` and the
Pallas kernel in interpret mode, per store type, on the same seeded numpy
inputs; FlatIndex and ground truth against JAX ``FlatIndex(backend="pallas")``.

Tolerances: values to atol 1e-5 / rtol 1e-5 (f32 sums in another order),
score regret <= 1e-5 against float64 over the effective inputs (the
bf16-rounded query where the path rounds it, the dequantized store), and ids
equal at >= 95% of positions (near-ties may swap). The CUDA kernel's own
tests, which need a card and no JAX, are in test_torch_gpu.py."""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.index.flat import FlatIndex as JFlatIndex
from nvdb_tpu.index.flat import build_ground_truth as j_build_gt
from nvdb_tpu.kernels import ops as jops
from nvdb_tpu.kernels.flat_scan import pallas_flat_topk
from nvdb_tpu.store import VectorStore as JVectorStore
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index.flat import FlatIndex, build_ground_truth
from nvdb_tpu_torch.kernels import dispatch, flat_scan, ops
from nvdb_tpu_torch.store import VectorStore

N, NP, D, DP, B = 2000, 2048, 96, 128, 8
DTYPES = ["f32", "bf16", "i8", "i8xi8"]


@pytest.fixture(scope="module")
def data():
    base = jsynth.clustered(N, D, n_clusters=8, seed=31)
    queries, _ = jsynth.sample_queries(base, B, seed=32, perturb=0.05)
    base_p = np.zeros((NP, DP), np.float32)
    base_p[:N, :D] = base
    q_p = np.zeros((B, DP), np.float32)
    q_p[:, :D] = queries
    return base_p, q_p


def _case(data, dtype):
    """(numpy inputs for JAX, torch inputs for the port, f64 effective
    queries and store) for one store type."""
    base_p, q_p = data
    if dtype == "f32":
        jv, tv = base_p, torch.from_numpy(base_p)
        q_eff, store_eff = q_p, base_p
        sc = qq = qs = None
    elif dtype == "bf16":
        bits = vecbin.to_bf16(base_p)
        jv, tv = bits.view(ml_dtypes.bfloat16), vecbin.bf16_bits_to_torch(bits)
        q_eff = vecbin.bf16_to_f32(vecbin.to_bf16(q_p))
        store_eff = vecbin.bf16_to_f32(bits)
        sc = qq = qs = None
    else:
        codes, sc = vecbin.quantize_i8(base_p)
        jv, tv = codes, torch.from_numpy(codes)
        store_eff = codes.astype(np.float64) * sc[:, None]
        qq = qs = None
        q_eff = vecbin.bf16_to_f32(vecbin.to_bf16(q_p))
        if dtype == "i8xi8":
            qq, qs = vecbin.quantize_i8(q_p)
            q_eff = qq.astype(np.float64) * qs[:, None]
    return dict(jv=jv, tv=tv, sc=sc, qq=qq, qs=qs,
                q_eff=np.asarray(q_eff, np.float64),
                store_eff=np.asarray(store_eff, np.float64))


def _port_args(c, q_p, device="cpu"):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(device)
    q = t(c["qq"]) if c["qq"] is not None else t(q_p)
    return q, c["tv"].to(device), t(c["sc"]), t(c["qs"])


def _jax_args(c, q_p):
    j = lambda a: None if a is None else jnp.asarray(a)
    q = j(c["qq"]) if c["qq"] is not None else j(q_p)
    return q, j(c["jv"]), j(c["sc"]), j(c["qs"])


def _check_regret(vals, ids, c, n_valid, k):
    """Chosen ids hold the true top-k scores (float64, effective inputs)."""
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 10, 128])
def test_scan_topk_matches_jax(data, dtype, k):
    """ops.scan_topk and dispatch (torch and auto on the CPU) agree with the
    JAX oracle and the Pallas kernel in interpret mode, n_valid < Np."""
    _, q_p = data
    c = _case(data, dtype)
    q, v, sc, qs = _port_args(c, q_p)
    tv_, ti_ = ops.scan_topk(q, v, sc, N, k, row_block=256, query_scales=qs)
    tv_, ti_ = tv_.numpy(), ti_.numpy()
    _check_regret(tv_, ti_, c, N, k)
    for backend in ("torch", "auto"):
        dv, di = dispatch.flat_topk(q, v, sc, N, k, backend=backend, query_scales=qs)
        np.testing.assert_array_equal(dv.numpy(), tv_)
        np.testing.assert_array_equal(di.numpy(), ti_)

    jq, jv, jsc, jqs = _jax_args(c, q_p)
    ov, oi = jops.scan_topk(jq, jv, jsc, N, k, row_block=256, query_scales=jqs)
    pv, pi = pallas_flat_topk(jq, jv, jsc, N, k, tile_rows=256, interpret=True,
                              query_scales=jqs)
    for ref_v, ref_i in ((ov, oi), (pv, pi)):
        np.testing.assert_allclose(tv_, np.asarray(ref_v), atol=1e-5, rtol=1e-5)
        assert np.mean(ti_ == np.asarray(ref_i)) >= 0.95


@pytest.mark.parametrize("dtype", DTYPES)
def test_k_above_n_valid(data, dtype):
    """Fewer valid rows than k: the tail is (-inf, -1), as the Pallas kernel
    gives it (the jnp oracle returns padding ids there, with -inf scores)."""
    _, q_p = data
    c = _case(data, dtype)
    q, v, sc, qs = _port_args(c, q_p)
    vals, ids = ops.scan_topk(q, v, sc, 5, 10, row_block=256, query_scales=qs)
    vals, ids = vals.numpy(), ids.numpy()
    _check_regret(vals, ids, c, 5, 10)
    jq, jv, jsc, jqs = _jax_args(c, q_p)
    pv, pi = pallas_flat_topk(jq, jv, jsc, 5, 10, tile_rows=256, interpret=True,
                              query_scales=jqs)
    np.testing.assert_array_equal(ids, np.asarray(pi))
    np.testing.assert_allclose(vals, np.asarray(pv), atol=1e-5, rtol=1e-5)


def test_merge_topk_ties_go_to_larger_id():
    vals = torch.tensor([[1.0, 3.0, 3.0, 2.0]])
    ids = torch.tensor([[4, 1, 7, 2]], dtype=torch.int32)
    empty_v = torch.full((1, 3), float("-inf"))
    empty_i = torch.full((1, 3), -1, dtype=torch.int32)
    v, i = ops.merge_topk(empty_v, empty_i, vals, ids, 3)
    assert v.tolist() == [[3.0, 3.0, 2.0]]
    assert i.tolist() == [[7, 1, 2]]


def test_l2_metric_matches_jax(data):
    base_p, q_p = data
    scaled = base_p * np.linspace(0.5, 2.0, NP, dtype=np.float32)[:, None]
    tv_, ti_ = dispatch.flat_topk(torch.from_numpy(q_p), torch.from_numpy(scaled),
                                  None, N, 10, metric="l2")
    jv_, ji_ = jops.scan_topk(jnp.asarray(q_p), jnp.asarray(scaled), None, N, 10,
                              metric="l2")
    np.testing.assert_allclose(tv_.numpy(), np.asarray(jv_), atol=1e-5, rtol=1e-5)
    assert np.mean(ti_.numpy() == np.asarray(ji_)) >= 0.95


@pytest.mark.parametrize("dtype,qi8", [("f32", False), ("bf16", False),
                                        ("i8", False), ("i8", True)])
def test_flat_index_matches_jax_pallas(data, dtype, qi8):
    base_p, q_p = data
    base, queries = base_p[:N, :D], q_p[:, :D]
    j = JFlatIndex(JVectorStore.from_numpy(base, dtype=dtype, row_block=256),
                   backend="pallas", quantize_queries=qi8)
    t = FlatIndex(VectorStore.from_numpy(base, dtype=dtype, row_block=256, device="cpu"),
                  quantize_queries=qi8)
    jv_, ji_ = j.search(queries, 10)
    tv_, ti_ = t.search(queries, 10)
    np.testing.assert_allclose(tv_, jv_, atol=1e-5, rtol=1e-5)
    assert np.mean(ti_ == ji_) >= 0.95


def test_ground_truth_matches_jax(data):
    base_p, q_p = data
    base, queries = base_p[:N, :D], q_p[:, :D]
    jgt = j_build_gt(JVectorStore.from_numpy(base, row_block=256), queries, 10,
                     batch=4, backend="pallas")
    tgt = build_ground_truth(VectorStore.from_numpy(base, row_block=256, device="cpu"),
                             queries, 10, batch=4)
    assert tgt.dtype == np.uint32
    assert np.mean(tgt == jgt) >= 0.95


def test_ground_truth_chunked_matches_resident(data, tmp_path):
    from nvdb_tpu_torch.index.flat import build_ground_truth_chunked

    base_p, q_p = data
    base, queries = base_p[:N, :D], q_p[:, :D]
    path = str(tmp_path / "b.vecbin")
    vecbin.write_vecbin(path, base)
    got = build_ground_truth_chunked(path, queries, 10, row_chunk=700, device="cpu")
    want = build_ground_truth(VectorStore.from_numpy(base, device="cpu"), queries, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("refine_k", [16, 4])
def test_exact_i8_mode_matches_jax(data, refine_k):
    """FlatIndex(quantize_queries, refine_k): the int8 x int8 candidates of
    depth max(refine_k, k) re-scored with the f32 queries (metric dot)
    agree with JAX's exact-i8 mode, and reach the f32-query ranking over
    the dequantized store (float64 regret)."""
    base_p, q_p = data
    base, queries = base_p[:N, :D], q_p[:, :D]
    j = JFlatIndex(JVectorStore.from_numpy(base, dtype="i8", row_block=256),
                   backend="jnp", quantize_queries=True, refine_k=refine_k)
    t = FlatIndex(VectorStore.from_numpy(base, dtype="i8", row_block=256, device="cpu"),
                  quantize_queries=True, refine_k=refine_k)
    assert t.refine_k == refine_k
    jv_, ji_ = j.search(queries, 10)
    tv_, ti_ = t.search(queries, 10)
    np.testing.assert_allclose(tv_, jv_, atol=1e-5, rtol=1e-5)
    assert np.mean(ti_ == ji_) >= 0.95
    codes, sc = vecbin.quantize_i8(base_p)
    eff = codes.astype(np.float64)[:N] * sc[:N, None]
    s64 = q_p.astype(np.float64) @ eff.T
    got = np.take_along_axis(s64, ti_.astype(np.int64), axis=1)
    if refine_k >= 10:
        ref = -np.sort(-s64, axis=1)[:, :10]
        assert np.max(ref - got) <= 1e-5
    np.testing.assert_allclose(tv_, got, atol=1e-5, rtol=1e-5)


def test_refine_k_ignored_outside_quantize_mode(data):
    """As in nvdb_tpu: refine_k only acts with quantized queries."""
    base_p, q_p = data
    st = VectorStore.from_numpy(base_p[:N, :D], dtype="f32", device="cpu")
    t = FlatIndex(st, refine_k=16)
    assert t.refine_k == 0
    plain = FlatIndex(st)
    for a, b in zip(t.search(q_p[:, :D], 10), plain.search(q_p[:, :D], 10)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_cpu_tensor_runs_plain_version(data):
    """The kernel's wrapper never falls back to the plain version: on a CPU
    tensor it raises, directly and through dispatch(backend="cuda"); only
    backend="auto" sends CPU tensors to the plain ops."""
    base_p, q_p = data
    q, v = torch.from_numpy(q_p), torch.from_numpy(base_p)
    before = flat_scan.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat_scan.flat_topk_cuda(q, v, None, N, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.flat_topk(q, v, None, N, 10, backend="cuda")
    assert flat_scan.LAUNCHES == before
    got = dispatch.flat_topk(q, v, None, N, 10, backend="auto")
    want = ops.scan_topk(q, v, None, N, 10)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- the CUDA wrapper's host side (no card here: routing, grid, argument checks) --

@pytest.mark.parametrize("dtype,kernel", [(torch.float32, flat_scan.TENSOR_CORE),
                                          (torch.bfloat16, flat_scan.TENSOR_CORE),
                                          (torch.int8, flat_scan.TENSOR_CORE)])
def test_kernel_routing_is_by_store_type(dtype, kernel):
    """Every store type goes to the tensor-core kernel by default: f32 by
    the three-way bf16 split in six passes (the TPU's HIGHEST), bf16 and
    int8 stores with f32 or int8 queries alike; the SIMT kernel of f32 FMA
    is reachable only by an explicit argument (test_torch_f32_split.py)."""
    assert flat_scan.kernel_for(dtype) == kernel


def test_kernel_routing_rejects_other_types():
    with pytest.raises(TypeError):
        flat_scan.kernel_for(torch.float64)
    with pytest.raises(TypeError):
        flat_scan.kernel_for(torch.float16)


N_SM = 132   # an H100 SXM


@pytest.mark.parametrize("batch,simt,tensor", [(1, 264, 132), (8, 264, 132), (64, 264, 132),
                                               (512, 33, 33), (513, 30, 26)])
def test_slice_count_full_store(batch, simt, tensor):
    """1M rows: the SIMT kernel (64 queries x 64 rows a CTA) gets two CTAs
    per SM or a few more; the tensor-core kernel (128 queries x 256 rows,
    one CTA per SM) never more CTAs than SMs, so its grid is one wave."""
    n = 1_000_000
    assert flat_scan.slice_count(batch, n, N_SM, flat_scan.SIMT) == simt
    assert flat_scan.slice_count(batch, n, N_SM, flat_scan.TENSOR_CORE) == tensor
    assert -(-batch // 128) * tensor <= N_SM       # CTAs: query blocks x slices
    assert -(-batch // 64) * simt >= 2 * N_SM


@pytest.mark.parametrize("batch", [1, 8, 64, 512, 513])
@pytest.mark.parametrize("n_valid,simt_tiles,tensor_tiles", [(0, 1, 1), (5, 1, 1), (64, 1, 1),
                                                             (65, 2, 1), (300, 5, 2),
                                                             (4096, 64, 16)])
def test_slice_count_small_store(batch, n_valid, simt_tiles, tensor_tiles):
    """No slice is shorter than one tile of its kernel, and there is always
    one (an empty store still gets its (-inf, -1) lists)."""
    for kernel, tiles in ((flat_scan.SIMT, simt_tiles), (flat_scan.TENSOR_CORE, tensor_tiles)):
        s = flat_scan.slice_count(batch, n_valid, N_SM, kernel)
        assert 1 <= s <= tiles
    # more query blocks than SMs: one slice, the grid takes several waves
    assert flat_scan.slice_count(128 * (N_SM + 1), 10**6, N_SM, flat_scan.TENSOR_CORE) == 1


def test_tma_operand_checks():
    """What the tensor maps of the tensor-core kernel need of queries and
    store: contiguous dims, a 16-byte aligned base and row pitch, Dp % 64."""
    ok = torch.zeros((4, 128), dtype=torch.int8)
    flat_scan.check_tma_operand(ok, "vectors")
    flat_scan.check_tma_operand(torch.zeros((4, 64), dtype=torch.bfloat16), "vectors")
    with pytest.raises(ValueError, match="multiple of 64"):
        flat_scan.check_tma_operand(torch.zeros((4, 96)), "vectors")
    with pytest.raises(ValueError, match="row pitch"):
        flat_scan.check_tma_operand(torch.zeros((4, 72), dtype=torch.int8)[:, :64], "vectors")
    with pytest.raises(ValueError, match="contiguous"):
        flat_scan.check_tma_operand(torch.zeros((64, 64)).T, "queries")
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat_scan.check_tma_operand(torch.zeros(4 * 64 + 1, dtype=torch.int8)[1:].view(4, 64),
                                    "vectors")
    with pytest.raises(ValueError, match="2-D"):
        flat_scan.check_tma_operand(torch.zeros(64), "queries")


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_raises_on_cpu_tensor_every_store_type(data, dtype):
    """Whichever kernel a store type routes to, a CPU tensor is refused and
    no launch is counted."""
    _, q_p = data
    q, v, sc, qs = _port_args(_case(data, dtype), q_p)
    before = flat_scan.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat_scan.flat_topk_cuda(q, v, sc, N, 10, query_scales=qs)
    assert flat_scan.LAUNCHES == before
