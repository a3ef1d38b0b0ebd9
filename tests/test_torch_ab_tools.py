"""The port's paired A/B tools on the CPU (``--device cpu``, where each arm
runs its kernel's plain version) at a tiny size: ``tools.kernel_ab``,
``tools.refine_ab`` and ``tools.adc_ab`` print RESULT lines with the JAX
scripts' keys (``arm`` for ``merge``; ``cuda`` / ``oracle`` for ``pallas``
/ ``jnp``) and pass ``--check``; ``tools._ab`` takes its samples in the
JAX scripts' order and its CI and delta are the scripts' formula on fixed
samples; ``dispatch.oracle_refine`` (the refine A/B's gather arm) equals the
JAX package's ``_refine_block(backend="jnp")``; the TPU-only arms and modes
are refused by name; and without a card every tool exits 1."""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nvdb_tpu.index.ivf_pq import _refine_block
from nvdb_tpu_torch.kernels import dispatch
from nvdb_tpu_torch.tools import _ab, adc_ab, kernel_ab, refine_ab

SMALL = ["--device", "cpu", "--n", "3000", "--d", "64"]


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return buf.getvalue(), out


def result_keys(text):
    return [[kv.split("=", 1)[0] for kv in ln.split()[1:]]
            for ln in text.splitlines() if ln.startswith("RESULT ")]


def jax_ci(s):
    """The JAX scripts' interval (scripts/kernel_ab.py:185-189)."""
    s = np.asarray(s)
    return 1.96 * s.std(ddof=1) / np.sqrt(len(s)) if len(s) > 1 else 0.0


def test_ab_summary_is_the_jax_formula():
    a = [1.0, 1.2, 0.9, 1.1, 1.05]
    b = [0.7, 0.95, 0.6, 0.8, 0.74]
    summ = _ab.summary({"a": a, "b": b})
    assert summ["a"]["ms"] == pytest.approx(np.mean(a))
    assert summ["a"]["ci95_ms"] == pytest.approx(jax_ci(a))
    assert summ["a"]["delta_ms"] == 0.0 and summ["a"]["delta_ci95_ms"] == 0.0
    d = np.subtract(b, a)
    assert summ["b"]["delta_ms"] == pytest.approx(d.mean())
    assert summ["b"]["delta_ci95_ms"] == pytest.approx(jax_ci(d))
    assert _ab.ci95([2.0]) == 0.0


def test_ab_paired_interleaves_after_one_warm_call():
    calls = []
    arms = {name: (lambda name=name: calls.append(name) or torch.zeros(1)) for name in "AB"}
    samples = _ab.paired(arms, pairs=3, chain=2, device=torch.device("cpu"))
    assert calls == ["A", "B"] + ["A", "A", "B", "B"] * 3
    assert [len(s) for s in samples.values()] == [3, 3]
    assert all(t >= 0 for s in samples.values() for t in s)
    assert _ab.device_fields(torch.device("cpu")) == {"device": "cpu", "power_limit_w": "none"}


@pytest.mark.parametrize("dtype,arms", [("bf16", "kernel,library,plain"),
                                        ("f32", "kernel,simt,library,plain"),
                                        ("i8", "kernel,plain")])
def test_kernel_ab_cpu(dtype, arms):
    text, recs = run(kernel_ab.main, SMALL + ["--dtype", dtype, "--batches", "16,4", "--ks",
                                              "10", "--arms", arms, "--iters", "2",
                                              "--pairs", "3", "--check"])
    first = arms.split(",")[0]
    want = ["arm", "B", "k", "dtype", "n", "d", "pairs", "iters", "ms", "ci95_ms",
            f"delta_vs_{first}_ms", "delta_ci95_ms", "qps", "gbps", "device", "power_limit_w"]
    keys = result_keys(text)
    assert len(keys) == 2 * len(arms.split(",")) and all(k == want for k in keys)
    assert [r["arm"] for r in recs[:len(arms.split(","))]] == arms.split(",")
    assert all(r["device"] == "cpu" and r["ms"] > 0 for r in recs)
    assert text.count("# check arm=") == len(keys)


def test_kernel_ab_cpu_qi8_one_sample():
    text, recs = run(kernel_ab.main, SMALL + ["--dtype", "i8", "--qi8", "--batches", "8",
                                              "--arms", "kernel,plain", "--iters", "2",
                                              "--pairs", "0", "--check"])
    assert result_keys(text)[0] == ["arm", "B", "k", "dtype", "n", "d", "qi8", "ms", "qps",
                                    "gbps", "device", "power_limit_w"]
    assert len(recs) == 2


def test_refine_ab_cpu():
    text, recs = run(refine_ab.main, SMALL + ["--batches", "8,32", "--rs", "20,50",
                                              "--pairs", "3", "--chain", "2", "--check"])
    want = ["stage", "B", "R", "k", "dtype", "n", "pairs", "chain", "cuda_ms", "oracle_ms",
            "delta_ms", "ci95", "cuda_ms_q", "oracle_ms_q", "device", "power_limit_w"]
    assert result_keys(text) == [want] * 4
    for r in recs:
        assert r["delta_ms"] == pytest.approx(r["cuda_ms"] - r["oracle_ms"], abs=1e-9)
    assert text.count("# check B=") == 8


@pytest.mark.parametrize("mode,arms", [("gen4", ("full", "live")), ("gen5", ("dma", "key")),
                                       ("gen6", ("key", "gather", "gather_slab"))])
def test_adc_ab_cpu(mode, arms):
    text, recs = run(adc_ab.main, ["--device", "cpu", "--mode", mode, "--nlist", "64",
                                   "--m", "8", "--lcap", "64", "--b", "4", "--p", "8",
                                   "--k", "20", "--pairs", "3", "--chain", "2"])
    assert len(recs) == len(arms) - 1
    for nb, keys in zip(arms[1:], result_keys(text)):
        assert keys == ["stage", "mode", "B", "P", "m", "lcap", "k", "pairs", "chain",
                        "fill_frac", f"{arms[0]}_ms", f"{nb}_ms", "delta_ms", "ci95",
                        f"{nb}_ms_q", "id_match", "device", "power_limit_w"]
    if mode != "gen5":
        assert all(r["id_match"] == 1.0 for r in recs)


def test_oracle_refine_matches_jax_jnp_refine():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((500, 64), dtype=np.float32)
    q = rng.standard_normal((6, 64), dtype=np.float32)
    cand = rng.integers(0, 500, (6, 30)).astype(np.int32)
    cand[0, :5] = -1
    for metric in ("l2", "dot"):
        tv, ti = dispatch.oracle_refine(torch.from_numpy(q), torch.from_numpy(cand),
                                        torch.from_numpy(v), None, 10, metric=metric)
        jv, ji = _refine_block(jnp.asarray(q), jnp.asarray(cand), jnp.asarray(v), None, 10,
                               backend="jnp", metric=metric)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("main,argv,code,msg", [
    (adc_ab.main, ["--mode", "slim"], 2, "not ported"),
    (adc_ab.main, ["--mode", "gen5diag"], 2, "wrong by design"),
    (kernel_ab.main, ["--dtype", "bf16", "--arms", "kernel,simt"], 1, "f32 stores only"),
    (kernel_ab.main, ["--dtype", "i8", "--arms", "kernel,library"], 1, "library arm"),
    (kernel_ab.main, [], 1, "no CUDA device"),
    (refine_ab.main, [], 1, "no CUDA device"),
    (adc_ab.main, [], 1, "no CUDA device"),
])
def test_ab_tools_refuse_by_name(monkeypatch, capsys, main, argv, code, msg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == code
    assert msg in capsys.readouterr().err
