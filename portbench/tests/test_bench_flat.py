"""The exact flat cell (``flat-bf16-1m768``) at a CPU size, built in code
from the real configuration with its corpus cut: the adapter's answers read
``correct``, and each planted fault fails on the number named: scores
rounded to fp8 (``score_err``), the last eighth of the rows never scanned
(``missed``), an id repeated (``bad_results``), one stored bf16 row altered
(``payload_mismatch``). The reader of ``flat_roofline`` reads a trace, and
on the card the tiny cell runs through the flat kernel."""

import copy
import dataclasses
import json

import pytest
import torch

from portbench import run, spec
from portbench.trace import Trace

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def tiny_flat_cell() -> spec.Cell:
    """``flat.b512`` with 4,096 rows of 128 dims and batches of 8."""
    cfg = json.loads((spec.HERE / "configs" / "flat-bf16-1m768.json").read_text())
    cfg["corpus"].update(n=4096, dim=128, clusters=64)
    mix = {"loop": "closed", "clients": 1, "batch": 8, "pool": 64, "perturb": 0.05}
    return spec.Cell(name="tiny.flat", config=cfg, traffic=mix, chips=1,
                     end_to_end=BENCH["end_to_end"],
                     per_layer=[m for m in BENCH["per_layer"] if m["name"] == "flat_roofline"])


def _served(cfg, rows, seed, device):
    return spec.index_adapter(cfg["index"]["kind"]).Served(cfg, rows, seed, device)


class _Fault:
    """The adapter's index with ``fault`` planted in what it serves or holds."""

    def __init__(self, fault, cfg, rows, seed, device):
        self.inner, self.fault = _served(cfg, rows, seed, device), fault
        st = self.inner.store
        if fault == "rows_skipped":
            self.inner.idx = copy.copy(self.inner.idx)
            self.inner.idx.store = dataclasses.replace(st, n=st.n - st.n // 8)
        elif fault == "payload_altered":
            st.vectors[5, 3] = -st.vectors[5, 3] + 0.5

    def search(self, q):
        v, i = self.inner.search(q)
        if self.fault == "fp8_scores":
            v = v.to(torch.float8_e4m3fn).to(torch.float32)
        elif self.fault == "repeated_id":
            v, i = v.clone(), i.clone()
            v[0, 1], i[0, 1] = v[0, 0], i[0, 0]
        return v, i

    def state(self, seed):
        return self.inner.state(seed)

    def shape(self, batch):
        return self.inner.shape(batch)


CAUGHT_BY = {"fp8_scores": "score_err", "rows_skipped": "missed",
             "repeated_id": "bad_results", "payload_altered": "payload_mismatch"}


def test_the_flat_cell_is_correct_on_the_plain_path():
    res = run.run_cell(tiny_flat_cell(), 31, 0.2, False, device="cpu")
    c = res["checks"]
    assert res["correct"] is True, c
    assert c["missed"]["value"] == 0 and c["score_err"]["value"] <= 4e-3
    assert c["unplaced_rows"]["value"] == 0 and c["payload_mismatch"]["value"] == 0
    assert res["metrics"]["recall_at_10"]["value"] >= 0.95


@pytest.mark.parametrize("fault", sorted(CAUGHT_BY))
def test_a_planted_fault_is_not_correct(fault):
    res = run.run_cell(tiny_flat_cell(), 32, 0.2, False, device="cpu",
                       served_factory=lambda *a: _Fault(fault, *a))
    assert res["correct"] is False, res["checks"]
    c = res["checks"][CAUGHT_BY[fault]]
    assert c["value"] > c["limit"], res["checks"]


def test_the_adapter_holds_every_row_in_one_list():
    cell = tiny_flat_cell()
    rows = torch.randn(100, 128, generator=torch.Generator().manual_seed(3)).numpy()
    served = _served(cell.config, rows, 3, "cpu")
    st = served.state(3)
    assert st.slot_ids.shape == (1, 100) and st.slot_ids.dtype == torch.int32
    assert torch.equal(st.slot_ids[0], torch.arange(100, dtype=torch.int32))
    assert st.centroids.shape == (1, 128) and not st.centroids.any()
    assert torch.equal(st.sample_payload, served.store.vectors[st.sample_slots[:, 1]])
    assert served.shape(8) == {"b": 8, "p": 1, "n": 100, "d": 128, "dp": 128, "k": 10,
                               "row_bytes": 256}


def test_the_flat_roofline_reads_a_trace():
    ms = 1_000_000
    acts = [("void round_queries_kernel(float const*)", 0, ms // 10, "kernel"),
            ("void (anonymous namespace)::scan_wgmma_kernel<1>(CUtensorMap)", ms // 10,
             2 * ms, "kernel"),
            ("void nvdb::merge_kernel(float const*, int const*)", 2 * ms, 2 * ms + ms // 10,
             "kernel"),
            ("void nvdb::adc_merge_kernel<true>()", 3 * ms, 4 * ms, "kernel")]
    req = {"submit": (0, ms), "search_device": (ms, 2 * ms), "fetch": (2 * ms, 3 * ms)}
    shape = {"b": 512, "p": 1, "n": 1_000_000, "d": 768, "dp": 768, "k": 10}
    t = Trace(activities=acts, requests=[req, req], t0_ns=0, t1_ns=5 * ms,
              inputs={"shape": shape})
    reader = spec.metric_readers(["flat_roofline"])["flat_roofline"]
    # 2 x 512 x 1M x 768 operations at 989 TFLOP/s a request, two requests
    # in 2.1 ms of the stage's kernels (not the ADC merge)
    assert reader.read(t) == pytest.approx(100 * 2 * 786.432e9 / 989e12 * 1e3 / 2.1)
    t.activities = [a for a in acts if "scan_wgmma" not in a[0]]
    assert reader.read(t) is None
    t.activities, t.inputs = acts, {}
    assert reader.read(t) is None


@pytest.mark.gpu
def test_tiny_flat_cell_on_the_card(cuda_device):
    res = run.run_cell(tiny_flat_cell(), 33, 0.5, True, device=cuda_device)
    assert res["correct"] is True and res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["flat_roofline"]["value"] <= 100
