"""The port's recorder (``nvdb_tpu_torch.eval.trace``) and the spans of the
served path: outside ``recording()`` a span is the shared no-op and nothing
is kept; inside it each ``search_device`` call is one request whose records
nest as the stages run (root, ``rotate``, ``coarse``, ``adc`` / ``probe``,
``refine``; the flat index's root alone, or with its exact-i8 ``refine``),
and the answers are bit for bit those of an unrecorded call.
The CPU reaches the kernels' plain versions (``backend="torch"``); the
wrapper spans and their ``launch`` children are held on the card in
``tests/test_torch_gpu.py``."""

import time

import numpy as np
import pytest
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.index.flat import FlatIndex
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.index.partition import PartitionRerankIndex
from nvdb_tpu_torch.store import VectorStore

N, D, NLIST, B, K, NPROBE, REFINE = 3000, 128, 16, 8, 10, 6, 30


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, D)).astype(np.float32)
    return (centers[rng.integers(0, 32, n)]
            + 0.3 * rng.standard_normal((n, D)).astype(np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    """The served indexes of one corpus, each a ``search(q)`` of the port's
    ``search_device`` on the plain path, and the records one call leaves."""
    rows = _rows(N, 3)
    pq = IVFPQIndex.build(rows, nlist=NLIST, m=16, use_opq=True, train_size=2000, n_iters=4,
                          opq_iters=2, seed=0, device="cpu")
    store = VectorStore.from_numpy(rows, "f32", device="cpu")
    part = PartitionRerankIndex.build(rows, nlist=NLIST, n_iters=4, seed=1, device="cpu")
    flat = FlatIndex(VectorStore.from_numpy(rows, "bf16", device="cpu"))
    flat_i8 = FlatIndex(VectorStore.from_numpy(rows, "i8", device="cpu"), quantize_queries=True,
                        refine_k=REFINE)
    return {
        "ivfpq": lambda q: pq.search_device(q, K, NPROBE, refine_k=REFINE, refine_store=store,
                                            backend="torch"),
        "partition": lambda q: part.search_device(q, K, NPROBE, rerank_k=REFINE,
                                                  backend="torch"),
        "flat": lambda q: flat.search_device(q, K),
        "flat_i8_refine": lambda q: flat_i8.search_device(q, K),
    }


@pytest.fixture(scope="module")
def queries():
    return torch.from_numpy(_rows(B, 7))


# the records of one request, in opening order: (name, the parent's name)
TREES = {
    "ivfpq": [("ivfpq.search", None), ("rotate", "ivfpq.search"),
              ("coarse", "ivfpq.search"), ("adc", "ivfpq.search"),
              ("refine", "ivfpq.search")],
    "partition": [("partition.search", None), ("ivfflat.search", "partition.search"),
                  ("coarse", "ivfflat.search"), ("probe", "ivfflat.search"),
                  ("refine", "partition.search")],
    "flat": [("flat.search", None)],
    "flat_i8_refine": [("flat.search", None), ("refine", "flat.search")],
}
# each root's attributes besides b, k and graph
ROOT_ATTRS = {"ivfpq": {"nprobe": NPROBE, "refine_k": REFINE},
              "partition": {"nprobe": NPROBE, "rerank_k": REFINE},
              "flat": {}, "flat_i8_refine": {}}
KINDS = list(TREES)


def test_span_without_a_recorder_is_the_shared_noop(served, queries):
    assert trace.span("coarse") is trace.OFF
    assert trace.span("ivfpq.search", b=8, k=10) is trace.OFF
    with trace.span("coarse") as sp:
        assert not sp
    served["ivfpq"](queries)
    with trace.recording() as tr:
        pass
    assert tr.records == [] and trace._active is None


@pytest.mark.parametrize("kind", KINDS)
def test_results_bit_for_bit_with_the_recorder_on(served, queries, kind):
    v0, i0 = served[kind](queries)
    with trace.recording() as tr:
        v1, i1 = served[kind](queries)
    assert tr.records
    assert torch.equal(i0, i1)
    assert torch.equal(v0.view(torch.int32), v1.view(torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_records_nest_as_the_stages_run(served, queries, kind):
    with trace.recording() as tr:
        served[kind](queries)
    recs = tr.records
    names = [r.name for r in recs]
    assert [(r.name, None if r.parent < 0 else names[r.parent]) for r in recs] == TREES[kind]
    assert {r.request for r in recs} == {0}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            up = recs[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
    # siblings run one after another
    for a, b in zip(recs, recs[1:]):
        if a.parent == b.parent:
            assert a.end_ns <= b.start_ns
    # the CPU path runs eagerly: no CUDA graph serves it (index/graphs.py)
    assert recs[0].attrs == {"b": B, "k": K, **ROOT_ATTRS[kind], "graph": "eager"}


def test_each_call_is_the_next_request(served, queries):
    with trace.recording() as tr:
        served["partition"](queries)
        served["ivfpq"](queries)
        served["partition"](queries)
    roots = [r for r in tr.records if r.parent < 0]
    assert [(r.name, r.request) for r in roots] == [
        ("partition.search", 0), ("ivfpq.search", 1), ("partition.search", 2)]
    assert all(r.request == tr.records[r.parent].request for r in tr.records if r.parent >= 0)
    assert [sum(r.request == q for r in tr.records) for q in range(3)] == [5, 5, 5]


def test_recording_restores_the_recorder_it_found():
    with trace.recording() as outer:
        with trace.span("a"):
            with trace.recording() as inner:
                with trace.span("b"):
                    pass
        with trace.span("c"):
            pass
    assert trace._active is None
    assert [(r.name, r.parent, r.request) for r in outer.records] == [("a", -1, 0),
                                                                      ("c", -1, 1)]
    assert [(r.name, r.parent, r.request) for r in inner.records] == [("b", -1, 0)]


def test_paused_records_nothing_and_restores_the_recorder():
    with trace.recording() as tr:
        with trace.span("a"):
            with trace.paused():
                assert trace.span("b") is trace.OFF
            with trace.span("c"):
                pass
    assert trace._active is None
    assert [(r.name, r.parent) for r in tr.records] == [("a", -1), ("c", 0)]


def test_tracer_span_sync_feeds_samples_and_tsv(tmp_path):
    tr = trace.Tracer()
    synced = []
    with tr.span("stage", sync=lambda: (time.sleep(0.004), synced.append(1))):
        with tr.span("inner"):
            pass
    with tr.span("stage"):
        pass
    assert synced == [1]
    assert [(r.name, r.parent) for r in tr.records] == [("stage", -1), ("inner", 0),
                                                        ("stage", -1)]
    samples = tr.samples_ms
    assert len(samples["stage"]) == 2 and samples["stage"][0] >= 4.0
    assert samples["stage"][0] == (tr.records[0].end_ns - tr.records[0].start_ns) / 1e6
    assert samples["absent"] == []
    out = tmp_path / "t.tsv"
    tr.dump_tsv(str(out))
    assert out.read_text().splitlines()[0] == "span\tsample\tms"
    assert len(out.read_text().splitlines()) == 4
    assert "stage: total=" in tr.render() and set(tr.totals()) == {"stage", "inner"}


def test_count_alloc_adds_the_bytes_of_the_tensors_given():
    with trace.recording():
        with trace.span("w") as sp:
            sp.count_alloc(torch.empty(4, 3, dtype=torch.int64), None)
            sp.count_alloc(torch.empty(5, dtype=torch.float32))
    assert sp.attrs == {"alloc_bytes": 4 * 3 * 8 + 5 * 4}
