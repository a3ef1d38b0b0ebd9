"""The port's CLIs against the JAX package's on the same files (``bench``,
``ivf_build`` + ``ivf_eval`` for IVF-PQ and IVF-Flat, ``quantize_i8``,
``pr_build`` / ``pr_search`` / ``pr_eval``): flags, RESULT keys (the port's
add the device name) and recall; and the no-fallback rule: without a card
the port's measurement entry points fail unless the CPU is asked for, and
the card-only tools (``hbm_probe``, ``gpu_sanity``, ``flat_breakdown``,
``adc_breakdown``) always fail."""

import argparse
import re

import numpy as np
import pytest
import torch

from nvdb_tpu.formats import gtbin as jgtbin
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.tools import bench as jbench
from nvdb_tpu_torch import bench as headline
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools import (adc_breakdown, bench, flat_breakdown, gpu_sanity,
                                  hbm_probe, ivf_build, ivf_eval, pr_build, pr_eval,
                                  pr_search, quantize_i8)

# flags of one package's parsers only: the JAX tools' platform switches, the
# port's device choice
_OWN_FLAGS = {"--cpu", "--debug-nans", "--device", "-h", "--help"}


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


def _result_keys(out: str):
    """The key sets of the RESULT lines in ``out``."""
    return [{kv.split("=", 1)[0] for kv in line.split()[1:]}
            for line in out.splitlines() if line.startswith("RESULT ")]


class _Parsed(Exception):
    pass


def _flags(main, monkeypatch):
    """The option strings of the parser ``main`` builds (it stops there)."""
    seen = {}

    def stop(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        main(["x"])
    monkeypatch.undo()
    return {o for a in seen["parser"]._actions for o in a.option_strings} - _OWN_FLAGS


def test_bench_flags_match_jax(monkeypatch):
    assert _flags(bench.main, monkeypatch) == _flags(jbench.main, monkeypatch)


def test_bench_result_keys_match_jax(files, capsys):
    args = [files["i8"], files["q"], "5", "--gt", files["gt"], "--batch-q", "8",
            "--quantize-queries", "--refine-k", "20"]
    bench.main(args + ["--device", "cpu"])
    ours = _result_keys(capsys.readouterr().out)
    jbench.main(args + ["--cpu", "--backend", "jnp"])
    theirs = _result_keys(capsys.readouterr().out)
    assert len(ours) == len(theirs) == 1
    assert ours[0] - {"device"} == theirs[0] and "refine_k" in ours[0]


@pytest.mark.parametrize("extra", [[], ["--device-queries"]])
def test_bench_exact_i8_refine_k_matches_jax(files, capsys, extra):
    """The exact-i8 mode (int8 x int8 scan, f32-query rerank of its top
    REFINE_K) gives the JAX tool's recall, at least the plain int8 x int8
    scan's; with the query pool staged on the device as well."""
    args = [files["i8"], files["q"], "5", "--gt", files["gt"], "--batch-q", "8",
            "--quantize-queries", *extra]
    plain = bench.main(args + ["--device", "cpu"])
    got = bench.main(args + ["--refine-k", "20", "--device", "cpu"])
    jbench.main(args + ["--refine-k", "20", "--cpu", "--backend", "jnp"])
    want = _recall(capsys.readouterr().out.split("RESULT")[-2])
    assert got == want and got >= plain


def test_bench_shards_not_ported(files, capsys):
    """``--shards`` once exited by name; since dist is ported it runs: on two
    CPU shards, the single-device recall."""
    args = [files["f32"], files["q"], "5", "--gt", files["gt"], "--batch-q", "8",
            "--device", "cpu"]
    single = bench.main(args)
    sharded = bench.main(args + ["--shards", "2"])
    assert sharded == single and "shards=2" in capsys.readouterr().out


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


@pytest.mark.parametrize("argv", [["--shards", "2"], ["--force-sharded"]])
def test_ivf_eval_unported_flags_exit(ivf_files, capsys, argv):
    """The flags once exited by name; since dist is ported they run the
    sharded path on CPU shards."""
    got = ivf_eval.main([ivf_files["idx"], ivf_files["base"], ivf_files["q"], "--gt",
                         ivf_files["gt"], "--nprobe", "4", "--refine-k", "40", "--batch-q",
                         "4", "--device", "cpu", *argv])
    shards = argv[1] if len(argv) > 1 else "1"
    assert got[0]["kind"] == f"ivfpq-sharded{shards}" and got[0]["recall"] > 0.5
    capsys.readouterr()


@pytest.fixture(scope="module")
def res_files(ivf_files, tmp_path_factory):
    """ivf_files plus the residual int8 codes of its base against its index,
    written by the port's ``quantize_i8 --residual``."""
    d = tmp_path_factory.mktemp("torch_res_tools")
    paths = dict(ivf_files, res=str(d / "res.vecbin"))
    quantize_i8.main([ivf_files["base"], paths["res"], "--residual", ivf_files["idx"]])
    return paths


@pytest.mark.parametrize("argv", [["--residual-refine"], ["--ids-mode", "key"]])
def test_ivf_eval_ported_modes_run(res_files, capsys, argv):
    """The flags that once exited run: the residual refine (on the residual
    codes) and the key-mode candidate generator, on both paths."""
    base = res_files["res"] if argv == ["--residual-refine"] else res_files["base"]
    for backend in ("auto", "torch"):
        got = ivf_eval.main([res_files["idx"], base, res_files["q"], "--gt", res_files["gt"],
                             "--nprobe", "4", "--refine-k", "40", "--batch-q", "4",
                             "--device", "cpu", "--ivf-backend", backend, *argv])
        assert got[0]["recall"] > 0.5 and got[0]["refine_enabled"] == 1
        assert got[0]["refine_backend"] == ("oracle" if backend == "auto" else "torch")
        assert got[0].get("ids_mode") == (argv[1] if len(argv) > 1 else None)
    capsys.readouterr()


@pytest.mark.parametrize("mode", [[], ["--chained"]])
def test_ivf_eval_result_keys_match_jax(ivf_files, capsys, mode):
    """Both tools' RESULT lines carry the same keys (the port's add the
    device), ``ids_mode`` among them when ``--ids-mode`` is given."""
    from nvdb_tpu.tools import ivf_eval as jivf_eval

    args = [ivf_files["idx"], ivf_files["base"], ivf_files["q"], "--gt", ivf_files["gt"],
            "--nprobe", "4", "--refine-k", "0", "40", "--batch-q", "4", "--warmup", "0",
            "--ids-mode", "key", *mode]
    ivf_eval.main(args + ["--device", "cpu"])
    ours = _result_keys(capsys.readouterr().out)
    jivf_eval.main(args + ["--cpu", "--ivf-backend", "jnp"])
    theirs = _result_keys(capsys.readouterr().out)
    assert len(ours) == len(theirs) == 2
    assert [o - {"device"} for o in ours] == theirs
    assert all({"ids_mode", "refine_backend"} <= o for o in ours)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_ivf_eval_residual_key_recall_matches_jax(res_files, capsys, backend):
    """``--residual-refine --ids-mode key`` on the residual codes: ``auto`` on
    the CPU (the JAX package's jnp semantics) gives the JAX tool's recall;
    ``torch`` (key-mode candidates, the fold of the rerank) within 0.02."""
    from nvdb_tpu.tools import ivf_eval as jivf_eval

    args = [res_files["idx"], res_files["res"], res_files["q"], "--gt", res_files["gt"],
            "--nprobe", "4", "--refine-k", "40", "--batch-q", "4", "--warmup", "0",
            "--residual-refine", "--ids-mode", "key"]
    got = ivf_eval.main(args + ["--device", "cpu", "--ivf-backend", backend])
    capsys.readouterr()
    jivf_eval.main(args + ["--cpu", "--ivf-backend", "jnp"])
    want = [float(x) for x in re.findall(r"^RESULT .* recall=([0-9.]+) ",
                                         capsys.readouterr().out, re.M)]
    if backend == "auto":
        assert [round(got[0]["recall"], 6)] == want
    else:
        assert abs(got[0]["recall"] - want[0]) <= 0.02


@pytest.mark.parametrize("residual", [False, True])
def test_quantize_i8_byte_equal_to_jax_fallback(ivf_files, tmp_path, capsys, monkeypatch,
                                                residual):
    """The port's quantize_i8 writes the JAX tool's file byte for byte when
    that tool runs its numpy fallback (NVDB_FORCE_PY_HOST=1)."""
    from nvdb_tpu import native
    from nvdb_tpu.tools import quantize_i8 as jquantize_i8

    monkeypatch.setenv("NVDB_FORCE_PY_HOST", "1")
    monkeypatch.setattr(native, "_load", lambda: None)
    extra = ["--residual", ivf_files["idx"]] if residual else []
    ours, theirs = str(tmp_path / "t.vecbin"), str(tmp_path / "j.vecbin")
    out = quantize_i8.main([ivf_files["base"], ours, *extra])
    jquantize_i8.main([ivf_files["base"], theirs, *extra, "--cpu"])
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert (out.count, out.dim) == (3000, 128 if residual else 64)
    assert ("residual-i8" in capsys.readouterr().out) == residual


def test_quantize_i8_residual_matches_native(res_files):
    """Against the JAX package's native quantizer (``nvdb_tpu.native``, its
    numpy fallback where the library is not built) on the same residual
    rows: codes equal, scales within rtol 1e-6 (tests/test_native.py)."""
    from nvdb_tpu import native

    cents, rot, list_of = quantize_i8.residual_params(res_files["idx"])
    rows = vecbin.VecbinFile(res_files["base"]).rows_f32()
    rows = np.pad(rows, ((0, 0), (0, cents.shape[1] - rows.shape[1]))) @ rot
    rows = rows - cents[list_of]
    f = vecbin.VecbinFile(res_files["res"])
    codes, scales = native.quantize_i8(rows)
    np.testing.assert_array_equal(np.asarray(f.vectors), codes)
    np.testing.assert_allclose(np.asarray(f.scales), scales, rtol=1e-6)


def test_quantize_i8_rejects_a_foreign_index(files, ivf_files, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        quantize_i8.main([files["q"], str(tmp_path / "x.vecbin"), "--residual",
                          ivf_files["idx"]])
    assert e.value.code != 0
    assert "wrong index" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--repack-from", "--replicas", "--corpus-refine"])
def test_ivf_build_build_side_flags(ivf_files, tmp_path, capsys, flag):
    """The flags that once exited run and write an index the JAX package
    loads and searches: ``--repack-from`` (pad 4.0, 8 spill candidates by
    default) and ``--repack-from --replicas 2`` give the JAX tool's arrays
    from the same index; ``--corpus-refine 1`` builds."""
    from nvdb_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
    from nvdb_tpu.tools import ivf_build as jivf_build

    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    if flag == "--corpus-refine":
        argv = ["--kind", "ivfpq", "--nlist", "8", "--pq-m", "8", "--train", "3000",
                "--opq-iters", "2", "--corpus-refine", "1"]
    else:
        argv = ["--kind", "ivfpq", "--repack-from", ivf_files["idx"]]
        argv += ["--replicas", "2"] if flag == "--replicas" else []
    ivf_build.main([ivf_files["base"], ours, *argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "built ivfpq" in out and "spilled=" in out
    t = JIVFPQIndex.load(ours)
    live = np.asarray(t.slot_ids)
    counts = np.bincount(live[live >= 0], minlength=3000)
    assert counts.min() >= 1 and counts.max() == t.replicas
    assert t.replicas == (2 if flag == "--replicas" else 1)
    queries = jvecbin.VecbinFile(ivf_files["q"]).rows_f32()
    _, ids = t.search(queries, 10, 4)
    assert ((np.asarray(ids) >= 0) & (np.asarray(ids) < 3000)).all()
    if flag != "--corpus-refine":
        jivf_build.main([ivf_files["base"], theirs, *argv, "--cpu"])
        capsys.readouterr()
        zt, zj = np.load(ours), np.load(theirs)
        assert sorted(zt.files) == sorted(zj.files)
        for name in zj.files:
            np.testing.assert_array_equal(zt[name], zj[name])
        assert t.lcap == {1: 1536, 2: 3072}[t.replicas]   # round_up(3000 R / 8 * 4, 128)


def test_ivf_build_replicas_on_ivfflat_refused(flat_files, tmp_path, capsys):
    """``--replicas`` is ivfpq-only, with the JAX tool's error."""
    from nvdb_tpu.tools import ivf_build as jivf_build

    argv = [flat_files["base"], str(tmp_path / "x.npz"), "--kind", "ivfflat",
            "--repack-from", flat_files["idx"], "--replicas", "2"]
    errs = []
    for main, extra in ((ivf_build.main, ["--device", "cpu"]), (jivf_build.main, ["--cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1])
    assert errs[0] == errs[1] and "ivfpq-only" in errs[0]


def test_ivf_build_ivfflat_repack_matches_jax(flat_files, tmp_path, capsys):
    """``--kind ivfflat --repack-from`` (pad 2.5, 8 spill candidates by
    default) writes the JAX tool's arrays from the same index."""
    from nvdb_tpu.tools import ivf_build as jivf_build

    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    argv = ["--kind", "ivfflat", "--repack-from", flat_files["idx"]]
    ivf_build.main([flat_files["base"], ours, *argv, "--device", "cpu"])
    jivf_build.main([flat_files["base"], theirs, *argv, "--cpu"])
    capsys.readouterr()
    zt, zj = np.load(ours), np.load(theirs)
    for name in zj.files:
        np.testing.assert_array_equal(zt[name], zj[name])
    assert zt["packed"].shape[1] == 480          # round_up(ceil(3000 / 16 * 2.5), 32)


# -- IVF-Flat and the partition index --------------------------------------------

@pytest.fixture(scope="module")
def flat_files(tmp_path_factory, ivf_files):
    """An IVF-Flat index of ivf_files' base, built by the port's tool."""
    d = tmp_path_factory.mktemp("torch_ivfflat_tools")
    paths = dict(ivf_files, idx=str(d / "flat.npz"))
    ivf_build.main([paths["base"], paths["idx"], "--kind", "ivfflat", "--nlist", "16",
                    "--dtype", "bf16", "--spill-candidates", "3", "--device", "cpu"])
    return paths


def test_ivf_build_ivfflat_writes_an_index_jax_loads(flat_files):
    from nvdb_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex

    idx = JIVFFlatIndex.load(flat_files["idx"])
    assert (idx.n, idx.d, idx.nlist, idx.dtype_code) == (3000, 64, 16, jvecbin.DTYPE_BF16)
    assert idx.lcap == 288                       # round_up(ceil(3000 / 16 * 1.5), 32)
    live = np.asarray(idx.slot_ids)
    assert sorted(live[live >= 0].tolist()) == list(range(3000))


@pytest.mark.parametrize("mode", [[], ["--chained", "--wave", "1"]])
def test_ivf_eval_ivfflat_recall_matches_jax(flat_files, capsys, mode):
    """An IVF-Flat index through both packages' ivf_eval: the same recall@10,
    and the refine_k > 0 grid point skipped by both."""
    from nvdb_tpu.tools import ivf_eval as jivf_eval

    args = [flat_files["idx"], flat_files["base"], flat_files["q"], "--gt", flat_files["gt"],
            "--nprobe", "2", "6", "--refine-k", "0", "40", "--k", "10", "--batch-q", "4",
            "--warmup", "1", *mode]
    got = ivf_eval.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("RESULT kind=ivfflat") == 2 and "refine_k=40" not in out
    jivf_eval.main(args + ["--cpu", "--ivf-backend", "jnp"])
    jout = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"^RESULT .* recall=([0-9.]+) ", jout, re.M)]
    assert [round(r["recall"], 6) for r in got] == want
    assert got[1]["recall"] >= got[0]["recall"] and got[1]["recall"] > 0.8


def test_ivf_eval_ivfflat_torch_backend_on_cpu(flat_files):
    got = ivf_eval.main([flat_files["idx"], flat_files["base"], flat_files["q"], "--gt",
                         flat_files["gt"], "--nprobe", "6", "--batch-q", "4", "--chained",
                         "--device", "cpu", "--ivf-backend", "torch"])
    assert got[0]["recall"] > 0.8


def test_pr_build_and_search_match_jax(ivf_files, tmp_path, capsys):
    """pr_build's file loads in both packages, and pr_search on it prints the
    same ids as the JAX package's pr_search (exact rerank on both)."""
    from nvdb_tpu.tools import pr_search as jpr_search

    path = str(tmp_path / "pr.npz")
    idx = pr_build.main([ivf_files["base"], path, "--nlist", "16", "--iters", "4",
                         "--device", "cpu"])
    assert "built partitions=16" in capsys.readouterr().out
    assert idx.ivf.dtype_code == jvecbin.DTYPE_BF16
    args = [path, ivf_files["q"], "--k", "5", "--nprobe", "4", "--base", ivf_files["base"],
            "--rerank-k", "20"]
    _, ids = pr_search.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    jpr_search.main(args + ["--cpu"])
    jout = capsys.readouterr().out
    assert out.count("query ") == 12
    got = [re.findall(r"(\d+)\(", line) for line in out.splitlines()]
    want = [re.findall(r"(\d+)\(", line) for line in jout.splitlines()]
    agree = np.mean([a == b for ga, wa in zip(got, want) for a, b in zip(ga, wa)])
    assert agree >= 0.99 and ids.shape == (12, 5)


@pytest.mark.parametrize("mode", [[], ["--chained", "--wave", "1"]])
@pytest.mark.parametrize("refine", ["f32", "res_i8"])
def test_pr_eval_on_cpu(ivf_files, capsys, mode, refine):
    got = pr_eval.main([ivf_files["base"], ivf_files["q"], "--gt", ivf_files["gt"],
                        "--nlist", "16", "--nprobe", "2", "8", "--rerank-k", "40",
                        "--batch-q", "4", "--warmup", "1", "--refine-dtype", refine,
                        "--tune", "0.9", "--device", "cpu", *mode])
    out = capsys.readouterr().out
    assert out.count("RESULT kind=partition-rerank") == 2 and "tuned nprobe" in out
    assert got[1]["recall"] >= got[0]["recall"] and got[1]["recall"] > 0.8
    if mode:
        assert got[1]["chained"] == 1 and got[1]["wave_p99_ms"] > 0


def test_pr_eval_torch_backend_matches_auto(ivf_files, capsys):
    args = [ivf_files["base"], ivf_files["q"], "--gt", ivf_files["gt"], "--nlist", "16",
            "--nprobe", "4", "--rerank-k", "40", "--batch-q", "6", "--chained",
            "--device", "cpu"]
    a = pr_eval.main(args)
    t = pr_eval.main(args + ["--backend", "torch"])
    assert a[0]["recall"] == t[0]["recall"]


def test_pr_eval_shards_not_ported(ivf_files, capsys):
    """``--shards`` once exited by name; since dist is ported it runs on CPU
    shards, and refuses ``--chained`` by name as the JAX tool does."""
    args = [ivf_files["base"], ivf_files["q"], "--gt", ivf_files["gt"], "--nprobe", "8",
            "--rerank-k", "40", "--shards", "2", "--device", "cpu"]
    got = pr_eval.main(args)
    assert got[0]["kind"] == "partition-rerank-sharded2" and got[0]["recall"] > 0.5
    with pytest.raises(SystemExit) as e:
        pr_eval.main(args + ["--chained"])
    assert e.value.code != 0
    assert "single-device serving loop" in capsys.readouterr().err


def _flat_counts(**kw):
    counts = dict.fromkeys(flat_breakdown.COUNTERS, 0)
    counts.update(kw)
    return counts


def test_flat_breakdown_split_puts_the_time_above_the_ring_into_parts():
    """``split`` divides the kernel's time above the ring in proportion to
    the warps' cycles in each part, cumulatively: ring, + compares, + walk;
    the drains and rescans make up the rest, and the rescans' share is of
    the whole kernel."""
    counts = _flat_counts(cyc_compare=100, cyc_walk=300, cyc_drain=400, cyc_rescan=200,
                          cyc_wait=999, cyc_tile=10_000)
    got = flat_breakdown.split(1.0, 2.0, counts)
    assert got["ring_ms"] == 1.0 and got["kernel_ms"] == 2.0
    assert got["compares_ms"] == pytest.approx(1.1)
    assert got["walk_ms"] == pytest.approx(1.4)
    assert got["rescan_ms"] == pytest.approx(0.2)
    assert got["rescan_share"] == pytest.approx(0.1)
    # no cycles in any part: nothing above the ring is placed
    empty = flat_breakdown.split(1.0, 2.0, _flat_counts())
    assert empty["compares_ms"] == empty["walk_ms"] == 1.0 and empty["rescan_ms"] == 0.0


def test_flat_breakdown_counter_fields_are_shares_of_warp_tiles_and_cycles():
    counts = _flat_counts(tiles=200, tightened=150, overflow_tiles=2, drained=900,
                          walked_groups=100, cyc_tile=1000, cyc_wait=50, cyc_compare=100,
                          cyc_walk=30, cyc_drain=20, cyc_rescan=10)
    got = flat_breakdown.counter_fields(counts)
    assert got["tiles"] == 200
    assert got["tightened_share"] == 0.75 and got["overflow_share"] == 0.01
    assert got["drained_per_tile"] == 4.5 and got["walked_groups_per_tile"] == 0.5
    assert [got[f"{p}_cyc_share"] for p in ("wait", "compare", "walk", "drain", "rescan")] == [
        0.05, 0.1, 0.03, 0.02, 0.01]
    # the tool reads the kernel's counters in the order of its enum
    assert len(flat_breakdown.COUNTERS) == len(set(flat_breakdown.COUNTERS)) == 11


@pytest.mark.parametrize("tool", [hbm_probe, gpu_sanity, flat_breakdown, adc_breakdown])
def test_card_only_tools_fail_without_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs")
    with pytest.raises(SystemExit) as e:
        tool.main([])
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_ivf_build_defaults_match_jax(ivf_files, tmp_path, capsys):
    """Without ``--kind`` both packages' ivf_build write an f32 IVF-Flat index
    at pad 1.5 (the port's default was ivfpq while IVF-Flat was unported)."""
    from nvdb_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex
    from nvdb_tpu.tools import ivf_build as jivf_build

    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ivf_build.main([ivf_files["base"], ours, "--nlist", "8", "--device", "cpu"])
    jivf_build.main([ivf_files["base"], theirs, "--nlist", "8", "--cpu"])
    capsys.readouterr()
    t, j = JIVFFlatIndex.load(ours), JIVFFlatIndex.load(theirs)
    assert "codebooks" not in np.load(ours).files
    assert (t.dtype_code, t.lcap, t.nlist) == (j.dtype_code, j.lcap, j.nlist)
    assert t.dtype_code == jvecbin.DTYPE_F32 and t.lcap == 576   # round_up(3000 / 8 * 1.5, 32)


# -- the JAX tools' platform flags (--cpu, --backend, --debug-nans) ----------

_TOOLS = ("ab_compare", "bench", "convert_bf16", "dump", "embed", "gt_build", "ivf_build",
          "ivf_eval", "make_query", "pr_build", "pr_eval", "pr_search", "quantize_i8",
          "sanity", "search", "slice", "synth")
# the port's own flags: its device choice, and a few options the JAX tools lack
_PORT_ONLY = {"--device", "-h", "--help"}
_PORT_EXTRAS = {"ivf_eval": {"--one-device"}, "pr_eval": {"--seed"}}


def _all_flags(main, monkeypatch):
    """Every option string of the parser ``main`` builds."""
    seen = {}

    def stop(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        main(["x"])
    monkeypatch.undo()
    return {o for a in seen["parser"]._actions for o in a.option_strings}


@pytest.mark.parametrize("tool", _TOOLS)
def test_tool_flags_match_jax_with_platform_flags(tool, monkeypatch):
    """Each of the 17 CLIs takes every flag of its JAX counterpart, the JAX
    tools' ``--cpu``, ``--backend`` and ``--debug-nans`` included; beyond
    them only ``--device`` and the options named in ``_PORT_EXTRAS``."""
    import importlib

    ours = _all_flags(importlib.import_module(f"nvdb_tpu_torch.tools.{tool}").main, monkeypatch)
    theirs = _all_flags(importlib.import_module(f"nvdb_tpu.tools.{tool}").main, monkeypatch)
    assert {"--cpu", "--backend", "--debug-nans"} <= ours
    assert ours - _PORT_ONLY - _PORT_EXTRAS.get(tool, set()) == theirs - {"-h", "--help"}


def test_cpu_flag_is_device_cpu(files, capsys):
    """A JAX command line (``--cpu``) runs the port on the CPU, as
    ``--device cpu`` does."""
    args = [files["f32"], files["q"], "5", "--gt", files["gt"], "--batch-q", "8"]
    assert bench.main(args + ["--cpu"]) == bench.main(args + ["--device", "cpu"]) == 1.0
    assert "device=cpu" in capsys.readouterr().out


def test_debug_nans_names_the_stage(files, tmp_path, capsys, monkeypatch):
    """``--debug-nans`` on a store with a NaN row exits non-zero naming the
    first stage that is not finite; a clean store passes the checks."""
    from nvdb_tpu_torch.kernels import dispatch

    monkeypatch.setattr(dispatch, "DEBUG_NANS", False)
    base = vecbin.VecbinFile(files["f32"]).rows_f32()
    base[17] = np.nan
    bad = str(tmp_path / "nan.vecbin")
    vecbin.write_vecbin(bad, base)
    with pytest.raises(SystemExit) as e:
        bench.main([bad, files["q"], "5", "--batch-q", "8", "--device", "cpu", "--debug-nans"])
    assert e.value.code != 0 and "flat_topk payload" in str(e.value.code)
    assert bench.main([files["f32"], files["q"], "5", "--gt", files["gt"], "--batch-q", "8",
                       "--device", "cpu", "--debug-nans"]) == 1.0
