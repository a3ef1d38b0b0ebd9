"""The CUDA-graph replay of the served searches (``nvdb_tpu_torch.index.graphs``)
as far as the CPU can see it: on CPU tensors no graph engages and each call
counts as eager, with today's answers; the cache key tells apart every
argument that changes the captured chain; a capture's launch counts are
taken back and replayed. The captures and replays are held on the card in
``tests/test_torch_gpu.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.index import graphs
from nvdb_tpu_torch.index.flat import FlatIndex
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.index.partition import PartitionRerankIndex
from nvdb_tpu_torch.kernels import adc_scan, flat_scan, ivf_scan, rerank
from nvdb_tpu_torch.store import VectorStore

N, D, NLIST, B, K, NPROBE, REFINE = 3000, 128, 16, 8, 10, 6, 30


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, D)).astype(np.float32)
    return (centers[rng.integers(0, 32, n)]
            + 0.3 * rng.standard_normal((n, D)).astype(np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    rows = _rows(N, 3)
    pq = IVFPQIndex.build(rows, nlist=NLIST, m=16, use_opq=True, train_size=2000, n_iters=4,
                          opq_iters=2, seed=0, device="cpu")
    store = VectorStore.from_numpy(rows, "f32", device="cpu")
    part = PartitionRerankIndex.build(rows, nlist=NLIST, n_iters=4, seed=1, device="cpu")
    return {"pq": pq, "store": store, "part": part, "q": torch.from_numpy(_rows(B, 7)),
            "flat": {b: FlatIndex(VectorStore.from_numpy(rows, "bf16", device="cpu"), backend=b)
                     for b in ("auto", "torch")}}


def _call(built, kind, backend):
    q = built["q"]
    if kind == "flat":
        return built["flat"][backend].search_device(q, K)
    if kind == "ivfpq":
        return built["pq"].search_device(q, K, NPROBE, refine_k=REFINE,
                                         refine_store=built["store"], backend=backend)
    return built["part"].search_device(q, K, NPROBE, rerank_k=REFINE, backend=backend)


def _chain(built, kind, backend):
    """The call's chain run directly, as ``search_device`` resolves it."""
    q = built["q"]
    if kind == "flat":
        return built["flat"][backend]._search_chain(q, K)
    if kind == "ivfpq":
        pq = built["pq"]
        return pq._search_chain(q, K, NPROBE, REFINE, built["store"], backend, "l2",
                                pq.ids_mode())
    part = built["part"]
    return part._search_chain(q, K, NPROBE, REFINE, part.refine_store, backend)


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("kind", ["ivfpq", "partition", "flat"])
def test_cpu_calls_stay_eager_and_count(built, kind, backend):
    """On CPU tensors no graph engages: ``GRAPH_EAGER`` counts each call, no
    graph is kept, and each answer is bit for bit the chain's run directly."""
    graphs.reset_counts()
    for n in range(1, 4):
        v, i = _call(built, kind, backend)
        assert (graphs.GRAPH_CAPTURES, graphs.GRAPH_REPLAYS, graphs.GRAPH_EAGER) == (0, 0, n)
    cv, ci = _chain(built, kind, backend)
    assert torch.equal(i, ci) and torch.equal(v.view(torch.int32), cv.view(torch.int32))
    idx = {"ivfpq": built["pq"], "partition": built["part"], "flat": built["flat"][backend]}
    assert len(idx[kind]._graphs) == 0


@pytest.mark.parametrize("kind", ["ivfpq", "partition", "flat"])
def test_root_span_says_eager_on_the_cpu(built, kind):
    with trace.recording() as tr:
        _call(built, kind, "torch")
    roots = [r for r in tr.records if r.parent < 0]
    assert len(roots) == 1 and roots[0].attrs["graph"] == "eager"
    assert "replay" not in [r.name for r in tr.records]


def test_engages_never_on_cpu_tensors_or_another_path():
    q = torch.zeros((4, 8))
    assert not graphs.engages(q, ["cuda"])
    assert not graphs.engages(q[:0], ["cuda"])
    assert not graphs.engages(q, ["cuda", "torch"])


def _pq_parts(built, **over):
    """``IVFPQIndex._graph_parts`` at the served call's resolved arguments,
    ``over`` changing some."""
    a = dict(k=K, nprobe=NPROBE, refine_k=REFINE, refine_store=built["store"],
             refine_metric="l2", mode="key")
    a.update(over)
    return built["pq"]._graph_parts(**a)


# each argument that changes the captured chain, at another value
PQ_CHANGES = {
    "k": {"k": K + 1},
    "nprobe": {"nprobe": NPROBE + 1},
    "refine_k": {"refine_k": REFINE + 1},
    "no_refine": {"refine_k": 0},
    "ids_mode": {"mode": "dma"},
    "refine_metric": {"refine_metric": "dot"},
    "refine_store": "store",
}


def _other_store(store):
    """The same rows in another store: another tensor, another graph."""
    other = VectorStore.from_numpy(store.vectors.numpy()[:N], "f32", device="cpu")
    assert torch.equal(other.vectors, store.vectors)
    return other


@pytest.mark.parametrize("change", list(PQ_CHANGES))
def test_ivfpq_cache_key_tells_the_arguments_apart(built, change):
    q = built["q"]
    base = graphs.key(q, _pq_parts(built))
    assert graphs.key(q, _pq_parts(built)) == base
    if PQ_CHANGES[change] == "store":
        over = {"refine_store": _other_store(built["store"])}
    else:
        over = PQ_CHANGES[change]
    assert graphs.key(q, _pq_parts(built, **over)) != base


@pytest.mark.parametrize("change", ["k", "nprobe", "rerank_k", "no_rerank", "batch", "dtype",
                                    "store", "ivf"])
def test_partition_cache_key_tells_the_arguments_apart(built, change):
    part, q = built["part"], built["q"]
    a = dict(k=K, nprobe=NPROBE, rerank_k=REFINE, store=part.refine_store)
    base = graphs.key(q, part._graph_parts(**a))
    assert graphs.key(q, part._graph_parts(**a)) == base
    if change == "batch":
        assert graphs.key(q[:B - 1], part._graph_parts(**a)) != base
        return
    if change == "dtype":
        assert graphs.key(q.double(), part._graph_parts(**a)) != base
        return
    if change == "ivf":
        # the partition's probe index swapped for a copy: another graph
        other = dataclasses.replace(part, ivf=dataclasses.replace(part.ivf))
        assert graphs.key(q, other._graph_parts(**a)) != base
        return
    if change == "store":
        assert graphs.key(q, part._graph_parts(**{**a, "store": _other_store(
            part.refine_store)})) != base
        return
    over = {"k": {"k": K + 1}, "nprobe": {"nprobe": NPROBE + 1},
            "rerank_k": {"rerank_k": REFINE + 1}, "no_rerank": {"store": None}}[change]
    assert graphs.key(q, part._graph_parts(**{**a, **over})) != base


def test_cache_key_holds_nprobe_as_resolved(built):
    """nprobe past nlist probes every list: one chain, one key."""
    part, q = built["part"], built["q"]
    a = dict(k=K, rerank_k=REFINE, store=part.refine_store)
    assert (graphs.key(q, part._graph_parts(nprobe=NLIST, **a))
            == graphs.key(q, part._graph_parts(nprobe=4 * NLIST, **a)))


def test_partition_cache_key_ignores_rerank_k_without_a_rerank(built):
    """rerank_k <= k runs the probe alone: one chain, one key."""
    part, q = built["part"], built["q"]
    assert (graphs.key(q, part._graph_parts(K, NPROBE, 0, None))
            == graphs.key(q, part._graph_parts(K, NPROBE, K, None)))


def test_cache_key_holds_scalars_by_value_and_the_rest_by_identity():
    q = torch.zeros((4, 8))
    t = torch.ones(3)
    assert graphs.key(q, (3, "dma", None, 0.5, True)) == graphs.key(q, (3, "dma", None, 0.5, True))
    assert graphs.key(q, (t,)) == graphs.key(q, (t,))
    assert graphs.key(q, (t,)) != graphs.key(q, (t.clone(),))


@pytest.mark.parametrize("kind", ["ivfpq", "partition"])
def test_a_replaced_index_gets_its_own_graph_cache(built, kind):
    """``dataclasses.replace`` makes a new index whose tensors may differ:
    it never shares the graphs of the index it came from."""
    idx = built["pq" if kind == "ivfpq" else "part"]
    other = dataclasses.replace(idx)
    assert other._graphs is not idx._graphs and len(other._graphs) == 0


# every kernel wrapper's launch counter a served chain may move
COUNTERS = [(adc_scan, "FUSED_LAUNCHES", None), (adc_scan, "FUSED_DMA_LAUNCHES", None),
            (adc_scan, "QTERM_LAUNCHES", None),
            (adc_scan, "TABLE_LAUNCHES", None), (adc_scan, "LAUNCHES", None),
            (adc_scan, "KEY_LAUNCHES", None), (adc_scan, "GATHER_LAUNCHES", None),
            (ivf_scan, "LAUNCHES", None), (rerank, "LAUNCHES", None),
            (flat_scan, "LAUNCHES", None), (flat_scan, "LAUNCHES_BY_KERNEL", "bf16"),
            (flat_scan, "LAUNCHES_BY_KERNEL", "int8")]


def _value(counter):
    mod, name, sub = counter
    v = getattr(mod, name)
    return v if sub is None else v[sub]


@pytest.mark.parametrize("counter", COUNTERS,
                         ids=[f"{m.__name__.split('.')[-1]}.{n}{'.' + s if s else ''}"
                              for m, n, s in COUNTERS])
def test_a_capture_counts_nothing_and_each_replay_counts_its_launches(counter, monkeypatch):
    """``launch_counts`` sees the counter; what a capture added to it
    (``moved``) is taken back, and each replay adds it again."""
    mod, name, sub = counter
    if sub is None:
        monkeypatch.setattr(mod, name, 5)
    else:
        monkeypatch.setitem(getattr(mod, name), sub, 5)
    before = graphs.launch_counts()
    assert before[counter] == 5
    # a capture records two launches of the wrapper
    graphs.add_counts([(counter, 2)])
    deltas = graphs.moved(before)
    assert deltas == [(counter, 2)]
    graphs.add_counts(deltas, -1)
    assert _value(counter) == 5 and graphs.moved(before) == []
    for n in range(1, 4):
        graphs.add_counts(deltas)
        assert _value(counter) == 5 + 2 * n
