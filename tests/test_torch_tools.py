"""The port's bench CLI against the JAX package's on the same files, and the
no-fallback rule: without a card the port's measurement entry points fail
unless the CPU is asked for."""

import numpy as np
import pytest
import torch

from nvdb_tpu.formats import gtbin as jgtbin
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.tools import bench as jbench
from nvdb_tpu_torch import bench as headline
from nvdb_tpu_torch.tools import bench


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
