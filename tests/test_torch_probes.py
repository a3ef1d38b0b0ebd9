"""The port's recall probes against the JAX package's scripts on the same
files: ``tools.coverage_probe`` against ``scripts/coverage_probe.py`` and
``tools.adc_rank_probe --device cpu`` against ``scripts/adc_rank_probe.py``,
on a small JAX-built IVF-PQ index (OPQ, 2,000 x 128 rows in 16 lists of
128 slots, one spill candidate, so 455 rows spill out of their nearest list
into whatever list has room). The JAX scripts run in this process through
``runpy``. Tolerances: the ``placed`` and ``coverage`` lines equal, the
probe-rank percentiles within one rank (f32 products in another order can
swap two lists of near-equal score), ``FINAL`` within 2 / (Q k) (scores
that tie, at bf16 above all, may be taken in another order). Also a
replicated index (each row in its two nearest lists), where a row is
covered when any of its lists is probed, and the exit without a card."""

import contextlib
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from nvdb_tpu.formats import gtbin as jgtbin
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.tools import adc_rank_probe, coverage_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, Q, K = 2000, 128, 40, 10


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probes")
    base = jsynth.clustered(N, D, n_clusters=6, seed=3)
    queries, _ = jsynth.sample_queries(base, Q, seed=5, perturb=0.05)
    jvecbin.write_vecbin(str(tmp / "q.vecbin"), queries)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    jgtbin.write_gtbin(str(tmp / "gt.gtbin"), np.argsort(-s64, axis=1)[:, :K].astype(np.int32),
                       dim=D, N=N)
    idx = JIVFPQIndex.build(base, nlist=16, m=8, use_opq=True, train_size=N, n_iters=3,
                            opq_iters=1, pad_factor=0.9, spill_candidates=1, seed=7,
                            cb_iters=2, cb_train_size=N)
    assert idx.n_spilled > 0 and idx.rotation is not None
    idx.save(str(tmp / "idx.npz"))
    return {name: str(tmp / name) for name in ("idx.npz", "q.vecbin", "gt.gtbin")}, base


def run_script(name, argv):
    """A JAX script's stdout, run in this process as ``__main__``."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "scripts", name), run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def run_port(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return buf.getvalue(), out


def split_lines(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    head = [ln for ln in lines if ln.startswith("N=")]
    cov = [ln for ln in lines if ln.startswith("nprobe=")]
    pct = [ln for ln in lines if ln.startswith("gt-list")]
    return head, cov, pct


@pytest.mark.parametrize("metric", ["l2", "dot", "corr:0.5"])
def test_coverage_probe_matches_jax(files, metric):
    f, _ = files
    argv = [f["idx.npz"], f["q.vecbin"], f["gt.gtbin"], "--nprobe", "1", "2", "4", "8",
            "--metric", metric]
    want = split_lines(run_script("coverage_probe.py", argv))
    text, res = run_port(coverage_probe.main, argv + ["--device", "cpu"])
    got = split_lines(text)
    assert got[0] == want[0] and got[1] == want[1], (text, want)
    assert len(want[1]) == 4 and res["placed"] == 1.0
    assert res["coverage"][8] > res["coverage"][1]
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        gv = [float(x) for x in g.split(":")[1].split()]
        wv = [float(x) for x in w.split(":")[1].split()]
        assert np.max(np.abs(np.subtract(gv, wv))) <= 1, (g, w)


@pytest.mark.parametrize("mode", ["f32", "bf16lut", "bf16score"])
def test_adc_rank_probe_matches_jax(files, mode):
    f, _ = files
    argv = [f["idx.npz"], f["q.vecbin"], f["gt.gtbin"], "--nprobe", "4", "--rk", "8", "32",
            "128", "--chunk", "16", "--score-mode", mode]
    want = run_script("adc_rank_probe.py", argv)
    text, final = run_port(adc_rank_probe.main, argv + ["--device", "cpu"])
    parse = lambda t: {int(r): float(v) for r, v in re.findall(r"recall@rk=(\d+)=([0-9.]+)", t)}
    w, g = parse(want.splitlines()[-1]), parse(text.splitlines()[-1])
    assert set(w) == set(g) == {8, 32, 128}
    for r in w:
        assert abs(w[r] - g[r]) <= 2.0 / (Q * K) + 1e-9, (mode, r, w, g)
        assert abs(final[r] - g[r]) <= 5e-5
    # the progress lines: one per chunk of 16 queries
    assert sum(ln.startswith("[") for ln in text.splitlines()) == -(-Q // 16)


def test_coverage_probe_replicated_index(files, tmp_path):
    """A port-built repack with each row in its two nearest lists: a
    neighbour is covered when either of its lists is probed; the JAX
    script, which keeps one list per row, counts no more."""
    f, base = files
    one = IVFPQIndex.load(f["idx.npz"], device="cpu")
    rep = IVFPQIndex.repack(one, base, pad_factor=2.0, replicas=2)
    assert rep.replicas == 2
    path = str(tmp_path / "rep.npz")
    rep.save(path)
    argv = [path, f["q.vecbin"], f["gt.gtbin"], "--nprobe", "1", "2", "4"]
    _, res = run_port(coverage_probe.main, argv + ["--device", "cpu"])
    want = split_lines(run_script("coverage_probe.py", argv))[1]
    jax_cov = {int(m.group(1)): float(m.group(2))
               for m in (re.search(r"nprobe=\s*(\d+) coverage=([0-9.]+)", ln) for ln in want)}
    # brute force: the lists of each row, and each query's probe order
    sids = rep.slot_ids.numpy()
    lists_of = [set() for _ in range(N)]
    for li, lane in zip(*np.nonzero(sids >= 0)):
        lists_of[sids[li, lane] % N].add(li)
    q = coverage_probe.load_queries(torch, f["q.vecbin"], rep.centroids.shape[1],
                                    rep.rotation, "cpu")
    order = coverage_probe.list_ranking(torch, q, rep, "l2").numpy()
    gt = np.asarray(jgtbin.read_gtbin(f["gt.gtbin"])[1])
    for np_ in (1, 2, 4):
        hit = np.mean([[bool(lists_of[g] & set(order[i, :np_].tolist())) for g in gt[i]]
                       for i in range(Q)])
        assert res["coverage"][np_] == pytest.approx(hit, abs=1e-12)
        assert res["coverage"][np_] >= jax_cov[np_] - 1e-4
    assert max(len(s) for s in lists_of) == 2


def test_probes_fail_without_card(files, monkeypatch, capsys):
    f, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (coverage_probe.main, adc_rank_probe.main):
        with pytest.raises(SystemExit) as e:
            main([f["idx.npz"], f["q.vecbin"], f["gt.gtbin"]])
        assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_coverage_probe_sharded_probe_set(files):
    """``--shards 4``: each block of 4 lists probes ceil(nprobe / 4) of its
    own by the serving ranking; brute force over the blocks of
    ``_coarse_probes``; at nprobe = nlist every list is probed."""
    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes

    f, _ = files
    argv = [f["idx.npz"], f["q.vecbin"], f["gt.gtbin"], "--nprobe", "4", "8", "16",
            "--device", "cpu"]
    _, one = run_port(coverage_probe.main, argv)
    _, four = run_port(coverage_probe.main, argv + ["--shards", "4"])
    assert four["coverage"][16] == one["coverage"][16] and four["percentiles"] is None
    idx = IVFPQIndex.load(f["idx.npz"], device="cpu")
    q = coverage_probe.load_queries(torch, f["q.vecbin"], idx.centroids.shape[1],
                                    idx.rotation, "cpu")
    held = coverage_probe.lists_of_rows(idx.slot_ids.numpy(), N)[:, 0]
    gt = np.asarray(jgtbin.read_gtbin(f["gt.gtbin"])[1])
    for np_, per in ((4, 1), (8, 2)):
        probed = torch.cat([_coarse_probes(q, idx.centroids[s:s + 4], idx.slot_ids[s:s + 4],
                                           per) + s for s in range(0, 16, 4)], 1).numpy()
        hit = np.mean([[held[g] in set(probed[i].tolist()) for g in gt[i]] for i in range(Q)])
        assert four["coverage"][np_] == pytest.approx(hit, abs=1e-12)
