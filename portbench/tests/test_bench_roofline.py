"""The frozen bound arithmetic reproduces chip_smoke's flagship bounds, the
work counts agree with brute force, and the readers read a trace."""

import pytest
import torch

from portbench import roofline, spec
from portbench.trace import Trace


def test_bound_ms_reproduces_the_flagship_bounds():
    # the fused key scan: 8.857 GFLOP at the f32 rate (PERF.md, row 3b)
    assert roofline.bound_ms(0.0308e9, 8.857e9, "f32") == (pytest.approx(0.1322, abs=1e-4),
                                                           "operations")
    # the partition probe: 1.008 GB of distinct lists (PERF.md, row 4)
    assert roofline.bound_ms(1.008e9, 1e9, "bf16") == (pytest.approx(0.3009, abs=1e-4), "bytes")


def test_adc_fused_bound_counts_tables_and_lookups():
    c = {"pairs": 16384, "lists": 780, "rows": 200_000, "slots": 8_374_000}
    ms = roofline.adc_fused_bound(c, 256, 64, 96, 8, 768, 100, 96 * 256 * 8)
    flops = 16384 * 96 * 256 * 20 + 8_374_000 * 96
    assert ms == pytest.approx(flops / 67e12 * 1e3)
    assert flops / 1e9 == pytest.approx(8.857, abs=0.01)


def test_probe_counts_count_a_list_once_a_batch():
    fills = torch.tensor([5, 0, 3, 7])
    probes = torch.tensor([[[0, 2], [0, 1]], [[3, 3], [2, 0]]])     # [NB=2, B=2, P=2]
    c = roofline.probe_counts(probes, fills, 4)
    assert c["pairs"].tolist() == [3, 4]          # list 1 is empty
    assert c["lists"].tolist() == [2, 3]
    assert c["rows"].tolist() == [8, 15]
    assert c["slots"].tolist() == [13, 22]


def _trace():
    ms = 1_000_000
    acts = [("void ns::adc_fused_kernel<0, 8, 8>(float const*)", 0, 4 * ms, "kernel"),
            ("void at::native::reduce_kernel<512>()", 5 * ms, 6 * ms, "kernel"),
            ("void ns::rerank_kernel<0>(float const*)", 6 * ms, 7 * ms, "kernel"),
            ("Memcpy DtoH (Device -> Pinned)", 7 * ms, 8 * ms, "copy")]
    req = {"submit": (0, ms), "search_device": (ms, 5 * ms), "fetch": (5 * ms, 9 * ms)}
    return Trace(activities=acts, requests=[req], t0_ns=0, t1_ns=10 * ms)


def test_readers_on_a_trace():
    t = _trace()
    r = spec.metric_readers(["device.idle_pct", "dispatch.launches_per_req",
                             "index.plain_torch_ms", "rerank_roofline", "probe_roofline"])
    assert r["device.idle_pct"].read(t) == pytest.approx(30.0)
    assert r["dispatch.launches_per_req"].read(t) == 3
    assert r["index.plain_torch_ms"].read(t) == pytest.approx(1.0)
    assert r["probe_roofline"].read(t) is None        # no probe kernel ran
    assert r["rerank_roofline"].read(t) is None       # no work shape given
    assert t.idle_gaps() == [["between requests", 0.002], ["host in search_device", 0.001]]
    assert t.top_ops(2)[0] == ["void ns::adc_fused_kernel<0, 8, 8>(float const*)", 0.004]
