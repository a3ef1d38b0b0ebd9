"""The port's tools in a process group (the counterpart of
``tests/test_multiprocess.py::test_two_process_ivf_eval_tool``). With
``NVDB_COORD`` / ``NVDB_NPROC`` / ``NVDB_PROC_ID`` set, a tool joins the
group in ``tools._common.setup_device`` and ``tool_mesh`` spans the
processes, each holding its share of the shards and loading only its rows:

- ``ivf_eval --device cpu --shards 8`` (sharded IVF-PQ and the sharded
  refine) on a JAX-built index, two gloo ranks of four CPU shards each
  against one process of eight: rank 0's recall equals the single run's;
- ``bench --shards 2`` under two ranks returns the one-process ids (the
  one-process ids are the ground truth the ranks are scored against, so
  recall 1 means equal id sets per query);
- without the env, ``setup_device`` joins nothing; in a group, shards that
  do not split over the processes fail by name;
- ``multiproc_bench --device cpu`` at a tiny size prints both runtimes'
  RESULT lines, with equal recall.

Each rank is a subprocess on localhost with a 120 s timeout and one
thread."""

import contextlib
import io
import re

import numpy as np
import pytest

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from nvdb_tpu_torch.dist import _worker, multihost
from nvdb_tpu_torch.formats import gtbin, vecbin
from nvdb_tpu_torch.tools import _common, bench, gt_build, ivf_eval, multiproc_bench


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return buf.getvalue(), out


@pytest.fixture
def one_thread(monkeypatch):
    """Each rank on one thread: the ranks share the host with other tests."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k in multihost.ENV + ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


def check_ranks(runs, world_devices):
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"process {rank}/2" in out and "backend=gloo" in out, out
        assert f"global_devices={world_devices}" in out, out


def test_two_rank_ivf_eval_tool(tmp_path, one_thread):
    n, d, q_n, k = 2048, 64, 16, 10
    base = jsynth.clustered(n, d, n_clusters=16, seed=11)
    base_path = str(tmp_path / "base.vecbin")
    vecbin.write_vecbin(base_path, base.astype(np.float32))
    queries, _ = jsynth.sample_queries(base, q_n, seed=13, perturb=0.05)
    q_path = str(tmp_path / "q.vecbin")
    vecbin.write_vecbin(q_path, queries.astype(np.float32))
    JIVFPQIndex.build(base, nlist=32, m=8, use_opq=False, train_size=n, n_iters=3,
                      seed=7).save(str(tmp_path / "idx.npz"))
    gt_path = str(tmp_path / "gt.gtbin")
    run(gt_build.main, [base_path, q_path, gt_path, "--k", str(k), "--device", "cpu"])

    argv = [str(tmp_path / "idx.npz"), base_path, q_path, "--k", str(k), "--nprobe", "32",
            "--refine-k", "64", "--gt", gt_path, "--device", "cpu", "--shards", "8"]
    _, single = run(ivf_eval.main, argv)
    assert single[0]["kind"] == "ivfpq-sharded8"
    runs = _worker.run_ranks(argv, nproc=2, timeout=120, module="nvdb_tpu_torch.tools.ivf_eval")
    check_ranks(runs, 8)
    m = re.search(r"RESULT .* recall=([0-9.]+)", runs[0][1])
    assert m, runs[0][1]
    # full probing, a deterministic program: the same recall in both runtimes
    assert abs(single[0]["recall"] - float(m.group(1))) < 1e-6
    assert "kind=ivfpq-sharded8" in runs[1][1]


def test_two_rank_bench_returns_the_one_process_ids(tmp_path, one_thread):
    n, d, q_n, k = 3000, 48, 12, 10
    base = jsynth.clustered(n, d, n_clusters=12, seed=2)
    base_path, q_path = str(tmp_path / "base.vecbin"), str(tmp_path / "q.vecbin")
    vecbin.write_vecbin(base_path, base.astype(np.float32))
    queries, _ = jsynth.sample_queries(base, q_n, seed=4, perturb=0.05)
    vecbin.write_vecbin(q_path, queries.astype(np.float32))

    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex
    from nvdb_tpu_torch.store import ShardedVectorStore

    import torch

    mesh = meshmod.row_mesh(2, devices=[torch.device("cpu")] * 2)
    _, ids = ShardedFlatIndex(ShardedVectorStore.from_vecbin(base_path, mesh)).search(queries, k)
    ids_path = str(tmp_path / "one.gtbin")
    gtbin.write_gtbin(ids_path, ids.astype(np.int32), dim=d, N=n)
    argv = [base_path, q_path, str(k), "--gt", ids_path, "--device", "cpu", "--shards", "2",
            "--batch-q", "4"]
    assert run(bench.main, argv)[1] == 1.0
    runs = _worker.run_ranks(argv, nproc=2, timeout=120, module="nvdb_tpu_torch.tools.bench")
    check_ranks(runs, 2)
    for _, out in runs:
        assert "recall=1.000000" in out and "shards=2" in out, out


def test_setup_device_joins_nothing_without_env(one_thread):
    args = _common.make_parser("t").parse_args(["--device", "cpu"])
    assert str(_common.setup_device(args)) == "cpu"
    assert not multihost.joined()
    mesh = _common.tool_mesh(args, 3)
    assert mesh.backend is None and mesh.shape["rows"] == 3


def test_multiproc_bench_cpu(tmp_path, one_thread):
    out_path = str(tmp_path / "mp.txt")
    text, recs = run(multiproc_bench.main, ["--device", "cpu", "--n", "4096", "--dim", "64",
                                            "--q", "64", "--nlist", "16", "--pq-m", "8",
                                            "--nprobe", "8", "--refine-k", "32",
                                            "--batch-q", "16", "--timeout", "120",
                                            "--out", out_path])
    lines = [ln for ln in text.splitlines() if ln.startswith("RESULT")]
    assert [ln.split()[-1] for ln in lines] == ["runtime=1proc", "runtime=2proc"]
    assert [r["runtime"] for r in recs] == ["1proc", "2proc"]
    assert recs[0]["kind"] == recs[1]["kind"] == "ivfpq-sharded2"
    assert recs[0]["recall"] == recs[1]["recall"]
    with open(out_path) as fh:
        assert fh.read().splitlines() == lines


def test_tool_mesh_refuses_shards_that_do_not_split(monkeypatch, capsys):
    """In a group of two processes, three shards fail by name (each process
    must hold as many)."""
    import torch.distributed as dist

    monkeypatch.setattr(multihost, "joined", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    args = _common.make_parser("t").parse_args(["--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        _common.tool_mesh(args, 3)
    assert e.value.code == 1
    assert "3 shards do not split over 2 processes" in capsys.readouterr().err
