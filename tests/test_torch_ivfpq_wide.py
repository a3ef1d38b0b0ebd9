"""IVF-OPQ-PQ at the OpenAI width (1536 dims, m 128, dsub 12), the shape of
cell ``ivfpq1536.b256`` cut to a small corpus: a 2,500-row clustered
corpus in 8 lists of 896 slots (two of the fused scan's 768-lane tiles
on the card), each answer of ``search_device`` judged by the benchmark's
float64 reference (``portbench.reference``), and the build with its padded
corpus on the device against the build that streams it from the host.
Imports no JAX."""

import numpy as np
import pytest
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.index import ivf_pq
from nvdb_tpu_torch.index.ivf_flat import place_rows
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.store import VectorStore
from portbench import queries, reference
from portbench.corpora import clustered

N, D, NLIST, M, B = 2500, 1536, 8, 128, 32
SEARCH = {"k": 10, "nprobe": 4, "refine_k": 20, "metric": "l2", "candidate_score": "pq"}
BUILD = dict(nlist=NLIST, m=M, use_opq=True, train_size=N, n_iters=3, opq_iters=1,
             cb_iters=3, seed=5, device="cpu")
STAGES = ["build.upload", "build.opq", "build.rotate", "build.kmeans", "build.assign",
          "build.pack", "build.codebooks", "build.encode"]


def _state(idx):
    return reference.IndexState(rotation=idx.rotation, centroids=idx.centroids,
                                slot_ids=idx.slot_ids, codes=idx.codes,
                                codebooks=idx.codebooks)


@pytest.fixture(scope="module")
def world():
    gen = torch.Generator().manual_seed(28)
    corpus = clustered.generate({"n": N, "dim": D, "clusters": 48, "spread": 0.25}, gen, "cpu")
    pool = queries.make_pool({"pool": B, "perturb": 0.05}, corpus, gen)
    with trace.recording() as rec:
        idx = IVFPQIndex.build(corpus.numpy(), **BUILD)
    return {"corpus": corpus, "q": pool, "idx": idx, "records": rec.records,
            "store": VectorStore.from_numpy(corpus.numpy(), "f32", device="cpu")}


def test_wide_build_shape_and_stages(world):
    idx = world["idx"]
    assert (idx.m, idx.codebooks.shape[2], idx.lcap, idx.nlist) == (M, 12, 896, NLIST)
    assert idx.ids_mode() == "key"
    spans = [r for r in world["records"] if r.name.startswith("build.")]
    assert [r.name for r in spans] == STAGES
    for r in spans:
        assert r.attrs["where"] == "device" and r.attrs["h2d_bytes"] == r.attrs["d2h_bytes"] == 0
        assert r.end_ns >= r.start_ns
    assert {r.name: r.attrs["rows"] for r in spans}["build.encode"] == N


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_wide_search_judged_by_the_reference(world, backend):
    """The oracle path (f32 tables) and the kernels' plain versions (bf16
    tables, the key mode) each answer every query soundly: no bad, off-probe
    or missed result, scores within 1e-5 of float64, every row placed once
    and every code a nearest codeword."""
    idx = world["idx"]
    v, i = idx.search_device(world["q"], SEARCH["k"], SEARCH["nprobe"],
                             refine_k=SEARCH["refine_k"], refine_store=world["store"],
                             backend=backend)
    got = reference.judge(world["q"], v, i, world["corpus"], _state(idx), SEARCH)
    assert got["score_err"] <= 1e-5
    assert {key: got[key] for key in ("bad_results", "off_probe", "missed", "failed_rows")} \
        == dict.fromkeys(("bad_results", "off_probe", "missed", "failed_rows"), 0.0)
    assert reference.start_checks(world["corpus"], _state(idx)) == {
        "unplaced_rows": 0.0, "code_mismatch": 0.0}


def test_host_path_build_equals_the_device_path(world, monkeypatch):
    """With no device memory to spare the padded corpus stays on the host
    and every stage streams it: the same slots and codes, every code a
    nearest codeword, the spans saying so."""
    monkeypatch.setattr(ivf_pq, "_DEVICE_BUILD_BYTES", 0)
    with trace.recording() as rec:
        host = IVFPQIndex.build(world["corpus"].numpy(), **BUILD)
    assert {r.attrs["where"] for r in rec.records if r.name.startswith("build.")} == {"host"}
    dev = world["idx"]
    assert torch.equal(host.slot_ids, dev.slot_ids)
    assert torch.equal(host.codes, dev.codes)
    assert reference.start_checks(world["corpus"], _state(host))["code_mismatch"] == 0.0


def _place_loop(alts, nlist, lcap):
    """The packing rule one row at a time: each pass over the rows left
    gives a row its candidate list's next slot while it has one; rows left
    after the last pass fill the free slots of the lists in list order."""
    n = alts.shape[0]
    fill = [0] * nlist
    where = {}
    left = list(range(n))
    spilled = 0
    for s in range(alts.shape[1]):
        rest = []
        for r in left:
            c = int(alts[r, s])
            if fill[c] < lcap:
                where[r] = (c, fill[c])
                fill[c] += 1
                spilled += s > 0
            else:
                rest.append(r)
        left = rest
    for c in range(nlist):
        while left and fill[c] < lcap:
            where[left.pop(0)] = (c, fill[c])
            fill[c] += 1
            spilled += 1
    return where, spilled


@pytest.mark.parametrize("seed", [0, 1])
def test_place_rows_against_a_row_loop(seed):
    """The vectorized placement the IVF-PQ build runs on its device (and
    ``_pack_lists`` on the host) gives the row loop's slots and spill
    count, the last-resort pour included."""
    rng = np.random.default_rng(seed)
    alts = rng.integers(0, 12, (4000, 3))
    alts[:600] = 5                                       # one list overfull past every spill
    want, spilled = _place_loop(alts, 12, 384)
    list_of, slot_of, got_spilled = place_rows(torch.from_numpy(alts), 12, 384)
    assert got_spilled == spilled > 0
    assert {r: (int(list_of[r]), int(slot_of[r])) for r in range(4000)} == want
