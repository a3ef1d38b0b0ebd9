"""The port's CLIs against the JAX package's on the same files (``bench``,
``ivf_build`` + ``ivf_eval``), and the no-fallback rule: without a card the
port's measurement entry points fail unless the CPU is asked for."""

import re

import numpy as np
import pytest
import torch

from nvdb_tpu.formats import gtbin as jgtbin
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.tools import bench as jbench
from nvdb_tpu_torch import bench as headline
from nvdb_tpu_torch.tools import bench, ivf_build, ivf_eval


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tools")
    base = jsynth.clustered(3000, 64, n_clusters=8, spread=1.0, seed=51)
    queries, _ = jsynth.sample_queries(base, 16, seed=52, perturb=0.05)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    gt = np.argsort(-s64, axis=1, kind="stable")[:, :5]
    paths = {"f32": str(d / "base.vecbin"), "i8": str(d / "base_i8.vecbin"),
             "bf16": str(d / "base_bf16.vecbin"), "q": str(d / "q.vecbin"),
             "gt": str(d / "gt.gtbin")}
    jvecbin.write_vecbin(paths["f32"], base)
    codes, sc = jvecbin.quantize_i8(base)
    jvecbin.write_vecbin(paths["i8"], codes, scales=sc)
    jvecbin.write_vecbin(paths["bf16"], jvecbin.to_bf16(base))
    jvecbin.write_vecbin(paths["q"], queries)
    jgtbin.write_gtbin(paths["gt"], gt, dim=64, N=3000)
    return paths


def _recall(out: str) -> float:
    return float(out.split("recall@5=")[1].split()[0])


@pytest.mark.parametrize("dtype,extra", [("f32", []), ("bf16", []), ("i8", []),
                                         ("i8", ["--quantize-queries"])])
def test_bench_recall_matches_jax(files, capsys, dtype, extra):
    args = [files[dtype], files["q"], "5", "--gt", files["gt"], "--batch-q", "8", *extra]
    jbench.main(args + ["--cpu", "--backend", "jnp"])
    want = _recall(capsys.readouterr().out)
    got = bench.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _recall(out) == want == got
    assert "RESULT mode=flat" in out and "payload_equiv_bandwidth_GBps=" in out
    if dtype == "f32":
        assert got == 1.0


def test_bench_torch_backend_on_cpu(files, capsys):
    bench.main([files["f32"], files["q"], "5", "--gt", files["gt"],
                "--device", "cpu", "--backend", "torch"])
    assert "recall@5=1.0000" in capsys.readouterr().out


def test_tools_bench_fails_without_card(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(SystemExit) as e:
        bench.main([files["f32"], files["q"], "5"])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


def test_headline_fails_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the headline runs")
    with pytest.raises(SystemExit) as e:
        headline.main(["--n", "1000", "--d", "64", "--batch", "8"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.fixture(scope="module")
def ivf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ivf_tools")
    base = jsynth.clustered(3000, 64, n_clusters=16, spread=0.5, seed=61)
    queries, _ = jsynth.sample_queries(base, 12, seed=62, perturb=0.05)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    gt = np.argsort(-s64, axis=1, kind="stable")[:, :10]
    paths = {"base": str(d / "base.vecbin"), "q": str(d / "q.vecbin"),
             "gt": str(d / "gt.gtbin"), "idx": str(d / "idx.npz")}
    jvecbin.write_vecbin(paths["base"], base)
    jvecbin.write_vecbin(paths["q"], queries)
    jgtbin.write_gtbin(paths["gt"], gt, dim=64, N=3000)
    ivf_build.main([paths["base"], paths["idx"], "--kind", "ivfpq", "--nlist", "8",
                    "--pq-m", "8", "--train", "3000", "--opq-iters", "2",
                    "--device", "cpu"])
    return paths


def test_ivf_build_writes_an_index_jax_loads(ivf_files, capsys):
    from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex

    idx = JIVFPQIndex.load(ivf_files["idx"])
    assert (idx.n, idx.d, idx.m, idx.nlist) == (3000, 64, 8, 8)
    live = np.asarray(idx.slot_ids)
    assert sorted(live[live >= 0].tolist()) == list(range(3000))


@pytest.mark.parametrize("mode", [[], ["--chained", "--wave", "1"]])
def test_ivf_eval_recall_matches_jax(ivf_files, capsys, mode):
    """The port's ivf_eval and the JAX package's on the same index, base,
    queries and ground truth: the same recall@10 (the exact refine makes
    the two paths agree) and RESULT lines."""
    from nvdb_tpu.tools import ivf_eval as jivf_eval

    args = [ivf_files["idx"], ivf_files["base"], ivf_files["q"], "--gt", ivf_files["gt"],
            "--nprobe", "4", "--refine-k", "0", "40", "--k", "10", "--batch-q", "4",
            "--warmup", "1", *mode]
    got = ivf_eval.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("RESULT kind=ivfpq") == 2 and "device=cpu" in out
    jivf_eval.main(args + ["--cpu", "--ivf-backend", "jnp"])
    jout = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"^RESULT .* recall=([0-9.]+) ", jout, re.M)]
    assert len(want) == 2
    assert [round(r["recall"], 6) for r in got] == want
    assert got[1]["recall"] >= got[0]["recall"]
    if mode:
        assert got[1]["wave"] == 1 and got[1]["wave_p99_ms"] > 0
    else:
        assert got[1]["cand_recall"] >= got[1]["recall"]


def test_ivf_eval_torch_backend_on_cpu(ivf_files, capsys):
    got = ivf_eval.main([ivf_files["idx"], ivf_files["base"], ivf_files["q"], "--gt",
                         ivf_files["gt"], "--nprobe", "4", "--refine-k", "40",
                         "--batch-q", "4", "--chained", "--device", "cpu",
                         "--ivf-backend", "torch"])
    assert got[0]["recall"] > 0.5


@pytest.mark.parametrize("argv", [["--shards", "2"], ["--residual-refine"],
                                  ["--ids-mode", "key"]])
def test_ivf_eval_unported_flags_exit(ivf_files, capsys, argv):
    with pytest.raises(SystemExit) as e:
        ivf_eval.main([ivf_files["idx"], ivf_files["base"], ivf_files["q"],
                       "--device", "cpu", *argv])
    assert e.value.code != 0
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--kind", "ivfflat"], ["--replicas", "2"],
                                  ["--corpus-refine", "1"]])
def test_ivf_build_unported_flags_exit(ivf_files, tmp_path, capsys, argv):
    with pytest.raises(SystemExit) as e:
        ivf_build.main([ivf_files["base"], str(tmp_path / "x.npz"), "--device", "cpu",
                        *argv])
    assert e.value.code != 0
    assert "not ported" in capsys.readouterr().err
