"""The program's spans on the trace's clock (``portbench/spans.py``): the
four readers on a synthetic trace against hand-computed values, None
without program spans; idle gaps labelled by the innermost span inside
``search_device`` and unchanged without spans; the clock checks; and one
traced run of each tiny cell on the CPU with the recorder on."""

import pytest

from portbench import spans
from portbench.tests.conftest import tiny_cell
from portbench.trace import Trace

MS = 1_000_000
REQ = {"submit": (0, 1 * MS), "search_device": (1 * MS, 5 * MS), "fetch": (5 * MS, 9 * MS)}
# one partition request: root, stages, the two wrappers and their C calls
SPANS = [
    ("partition.search", 1.1, 4.9, -1, {"b": 256}),
    ("ivfflat.search", 1.2, 3.0, 0, {}),
    ("coarse", 1.3, 1.8, 1, {}),
    ("probe", 1.9, 2.9, 1, {}),
    ("ivf_probe_topk_cuda", 2.0, 2.8, 3, {"alloc_bytes": 3_000_000}),
    ("launch", 2.6, 2.7, 4, {}),
    ("refine", 3.1, 4.8, 0, {}),
    ("rerank_topk_cuda", 3.2, 4.7, 6, {"alloc_bytes": 1_000_000}),
    ("launch", 4.5, 4.6, 7, {}),
]
# (name, start, end, kind, launch start) in ms
ACTS = [
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8", 1.5, 1.6, "kernel", 1.4),
    ("void at::native::sbtopk::gatherTopK<float>()", 1.7, 1.75, "kernel", 1.65),
    ("void probe_list_kernel<1, 8>(float const*)", 2.65, 3.5, "kernel", 2.65),
    ("void rerank_kernel<0>(float const*)", 4.55, 4.6, "kernel", 4.55),
    ("Memcpy DtoH (Device -> Pinned)", 5.0, 5.5, "copy", None),
]


def _trace(spans=SPANS, acts=ACTS):
    ns = lambda x: round(x * MS)
    return spans_trace(
        activities=[(n, ns(s), ns(e), k) for n, s, e, k, _ in acts],
        launch_ns=[None if ln is None else ns(ln) for *_, ln in acts],
        spans=[(n, ns(s), ns(e), p, 0, a) for n, s, e, p, a in spans])


def spans_trace(**kw):
    return spans.SpanTrace(requests=[REQ], t0_ns=0, t1_ns=10 * MS, **kw)


def test_readers_on_a_trace_with_program_spans():
    t = _trace()
    assert spans.host_ms(t) == pytest.approx(3.8)
    assert spans.wrapper_host_ms(t) == pytest.approx(0.8 + 1.5)
    assert spans.alloc_mb_per_req(t) == pytest.approx(4.0)
    assert spans.coarse_ms(t) == pytest.approx(0.1 + 0.05)   # the GEMM and the top-k


def test_coarse_ms_needs_the_other_kernels_matched():
    acts = list(ACTS)
    acts[1] = acts[1][:4] + (None,)          # half the others with no launch record
    assert spans.coarse_ms(_trace(acts=acts)) is None
    acts = list(ACTS)
    acts[2] = acts[2][:4] + (None,)          # a port kernel unmatched: no matter
    assert spans.coarse_ms(_trace(acts=acts)) == pytest.approx(0.15)


def test_readers_read_nothing_without_program_spans():
    plain = Trace(activities=[a[:4] for a in _trace().activities], requests=[REQ], t0_ns=0,
                  t1_ns=10 * MS)
    for t in (plain, _trace(spans=[])):
        for name, (read, _) in spans.METRICS.items():
            assert read(t) is None, name


def test_idle_gaps_name_the_innermost_span_in_search_device():
    t = _trace()
    gaps = dict(t.idle_gaps(20))
    assert gaps == pytest.approx({
        "host in fetch": 0.0045, "host in submit": 0.0015,
        "host in search_device: coarse": 0.0001,
        "host in search_device: ivf_probe_topk_cuda": 0.0009,
        "host in search_device: rerank_topk_cuda": 0.00105,
        "host in search_device: partition.search": 0.0004,
    })
    assert "host in search_device" not in gaps
    bare = _trace(spans=[])
    want = Trace(activities=bare.activities, requests=[REQ], t0_ns=0,
                 t1_ns=10 * MS).idle_gaps()
    assert bare.idle_gaps() == want
    assert dict(want)["host in search_device"] == pytest.approx(0.00245)


def test_a_gap_outside_every_span_keeps_the_phase_label():
    gaps = dict(_trace(spans=[("partition.search", 2.0, 4.9, -1, {})]).idle_gaps(20))
    assert gaps["host in search_device"] == pytest.approx(0.0001)
    assert gaps["host in search_device: partition.search"] == pytest.approx(0.0009 + 0.00145)


def test_clock_checks_on_a_trace():
    c = spans.clock_checks(_trace())
    assert (c["kernels"], c["kernels_matched"]) == (4, 4)
    assert c["matched_share_port"] == 1.0 and c["matched_share_other"] == 1.0
    assert c["launch_in_root_share"] == 1.0
    assert c["port_launch_in_launch_span_share"] == 1.0
    assert c["requests_with_one_root_share"] == 1.0
    assert c["root_cover_of_search_device"] == pytest.approx(3.8 / 4.0)
    assert c["idle_in_search_device_named_share"] == pytest.approx(1.0)
    split = spans.stage_split(_trace())
    assert split["partition.search"] == pytest.approx(3.8 - 1.8 - 1.7)
    assert split["ivf_probe_topk_cuda"] == pytest.approx(0.8 - 0.1)
    assert sum(split.values()) == pytest.approx(3.8)


@pytest.mark.parametrize("name", ["tiny.ivfpq", "tiny.partition"])
def test_a_traced_run_with_the_recorder_on_the_cpu(name):
    result, extra = spans.traced_run(tiny_cell(name), 5, 0.2, device="cpu")
    assert result["correct"]
    m = result["metrics"]
    assert m["index.host_ms"]["value"] > 0 and m["index.host_ms"]["unit"] == "ms/req"
    # the CPU path reaches no kernel wrapper and no device kernel
    assert m["dispatch.wrapper_host_ms"]["value"] == 0.0
    assert m["dispatch.alloc_mb_per_req"]["value"] == 0.0
    assert "index.coarse_ms" not in m
    c = extra["checks"]
    assert c["requests_with_one_root_share"] == 1.0
    assert 0.5 < c["root_cover_of_search_device"] <= 1.0
    root = {"tiny.ivfpq": "ivfpq.search", "tiny.partition": "partition.search"}[name]
    assert root in extra["stage_ms"] and "coarse" in extra["stage_ms"]


def test_an_untraced_run_splits_the_host_time():
    result, extra = spans.traced_run(tiny_cell("tiny.ivfpq"), 6, 0.2, device="cpu",
                                     trace=False)
    assert result["correct"] and "qps" in result["metrics"]
    assert extra["index.host_ms"] == pytest.approx(sum(extra["stage_ms"].values()))
    assert extra["dispatch.wrapper_host_ms"] == 0.0
    assert {"ivfpq.search", "coarse", "adc", "refine"} <= set(extra["stage_ms"])
