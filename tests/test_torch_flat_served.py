"""The exact flat index on the served path, as far as the CPU can see it:
``FlatIndex.search_device`` on the kernels' plain path against a float64
plain-torch reference of the same semantics (the query and the rows as the
store type scores them, a float64 dot product, the exact top-k), and the
CUDA-graph engagement rule refusing every call the CPU can make, metric
``l2`` and ``DEBUG_NANS``. The captures and replays are held on the card in
``tests/test_torch_gpu.py``. Imports no JAX."""

import numpy as np
import pytest
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.index import graphs
from nvdb_tpu_torch.index.flat import FlatIndex, quantize_queries_i8
from nvdb_tpu_torch.kernels import dispatch
from nvdb_tpu_torch.store import VectorStore

N, D, B = 3000, 96, 12
STORES = ["f32", "bf16", "i8", "i8xi8"]


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, D)).astype(np.float32)
    x = centers[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal((n, D)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _rows(N, 41), torch.from_numpy(_rows(B, 42))


def _index(rows, kind, **kw):
    store = VectorStore.from_numpy(rows, "i8" if kind == "i8xi8" else kind, device="cpu")
    return FlatIndex(store, quantize_queries=kind == "i8xi8", **kw)


def reference_scores(idx: FlatIndex, queries: torch.Tensor) -> torch.Tensor:
    """[B, n] float64 scores of every row as the store type defines them:
    f32 rows and queries; bf16 rows and bf16-rounded queries; int8 codes
    times their scales, with bf16-rounded queries or (int8 x int8) the
    queries' own int8 codes times their scales."""
    st = idx.store
    dp = st.d_padded
    q = torch.nn.functional.pad(queries, (0, dp - queries.shape[1]))
    rows = st.vectors[:st.n].to(torch.float64)
    if st.scales is not None:
        rows = rows * st.scales[:st.n, None].to(torch.float64)
    if idx.quantize_queries:
        q8, qs = quantize_queries_i8(q)
        q = q8.to(torch.float64) * qs[:, None].to(torch.float64)
    elif st.vectors.dtype == torch.float32:
        q = q.to(torch.float64)
    else:
        q = q.to(torch.bfloat16).to(torch.float64)
    return q @ rows.T


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("kind", STORES)
def test_flat_index_is_the_exact_top_k(data, kind, k):
    """The answer is the reference's top k: distinct real ids, each score
    the reference's score of its id within the band of f32 accumulation,
    sorted descending, and no row outside it scores above the k-th by more
    than two bands (ties inside the band may fall either side)."""
    rows, queries = data
    idx = _index(rows, kind)
    qp = torch.nn.functional.pad(queries, (0, idx.store.d_padded - D))
    v, i = idx.search_device(qp, k)
    s = reference_scores(idx, queries)
    assert v.shape == (B, k) and i.shape == (B, k) and i.dtype == torch.int32
    il = i.long()
    assert bool(((il >= 0) & (il < N)).all())
    assert all(len(set(r.tolist())) == k for r in il)
    assert bool((v[:, 1:] <= v[:, :-1]).all())
    # f32 accumulation of D products, each at most |q_j r_j|: D 2^-24 |q| |r|
    band = D * 2.0 ** -24 * float(torch.abs(s).max().clamp(min=1.0))
    got = torch.gather(s, 1, il)
    assert float((v.to(torch.float64) - got).abs().max()) <= band
    kth = torch.topk(s, k, dim=1).values[:, -1:]
    assert bool((got >= kth - 2 * band).all())
    outside = s.clone()
    outside.scatter_(1, il, -torch.inf)
    assert bool((outside.max(1, keepdim=True).values <= got[:, -1:] + 2 * band).all())


def test_cpu_calls_stay_eager_and_keep_no_graph(data):
    rows, queries = data
    idx = _index(rows, "bf16")
    qp = torch.nn.functional.pad(queries, (0, idx.store.d_padded - D))
    graphs.reset_counts()
    with trace.recording() as tr:
        v, i = idx.search_device(qp, 10)
    assert (graphs.GRAPH_CAPTURES, graphs.GRAPH_REPLAYS, graphs.GRAPH_EAGER) == (0, 0, 1)
    assert len(idx._graphs) == 0
    assert [r.name for r in tr.records] == ["flat.search"]
    assert tr.records[0].attrs == {"b": B, "k": 10, "graph": "eager"}
    cv, ci = idx._search_chain(qp, 10)
    assert torch.equal(i, ci) and torch.equal(v.view(torch.int32), cv.view(torch.int32))


class _CudaLike:
    """What ``graphs.engages`` reads of a batch of CUDA queries."""
    is_cuda = True
    shape = (B, 128)


def test_engagement_refuses_metric_l2_and_debug_nans(data, monkeypatch):
    """With every stage asked onto the kernels (``backend="cuda"``), metric
    dot resolves every stage to ``cuda``; metric l2 runs the plain ops, and
    ``DEBUG_NANS`` reads back to the host: neither engages."""
    rows, _ = data
    assert _index(rows, "bf16", backend="cuda")._paths() == ["cuda"]
    assert _index(rows, "i8xi8", backend="cuda", refine_k=40)._paths() == ["cuda", "cuda"]
    l2 = _index(rows, "bf16", backend="cuda", metric="l2")
    assert l2._paths() == ["torch"] and not graphs.engages(_CudaLike(), l2._paths())
    monkeypatch.setattr(dispatch, "DEBUG_NANS", True)
    assert not graphs.engages(_CudaLike(), ["cuda"])


@pytest.mark.parametrize("route", ["l2", "debug_nans"])
def test_eager_routes_answer_as_the_chain(data, monkeypatch, route):
    rows, queries = data
    idx = _index(rows, "f32", metric="l2" if route == "l2" else "dot")
    if route == "debug_nans":
        monkeypatch.setattr(dispatch, "DEBUG_NANS", True)
    qp = torch.nn.functional.pad(queries, (0, idx.store.d_padded - D))
    graphs.reset_counts()
    v, i = idx.search_device(qp, 10)
    assert graphs.GRAPH_EAGER == 1 and len(idx._graphs) == 0
    cv, ci = idx._search_chain(qp, 10)
    assert torch.equal(i, ci) and torch.equal(v.view(torch.int32), cv.view(torch.int32))


@pytest.mark.parametrize("change", ["k", "backend", "metric", "quantize", "refine_k", "batch"])
def test_cache_key_tells_the_arguments_apart(data, change):
    rows, queries = data
    base_idx = _index(rows, "i8xi8", refine_k=40)
    base = graphs.key(queries, base_idx._graph_parts(10))
    assert graphs.key(queries, base_idx._graph_parts(10)) == base
    if change == "batch":
        assert graphs.key(queries[:B - 1], base_idx._graph_parts(10)) != base
        return
    if change == "k":
        assert graphs.key(queries, base_idx._graph_parts(11)) != base
        return
    other = {"backend": lambda: _index(rows, "i8xi8", refine_k=40, backend="cuda"),
             "metric": lambda: _index(rows, "i8", metric="l2"),
             "quantize": lambda: _index(rows, "i8"),
             "refine_k": lambda: _index(rows, "i8xi8", refine_k=20)}[change]()
    assert graphs.key(queries, other._graph_parts(10)) != base
