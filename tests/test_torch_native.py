"""The port's binding of the native host library (``nvdb_tpu_torch.native``)
against ``nvdb_tpu.native`` on the same rows, mirroring tests/test_native.py:
bf16 bits equal, int8 codes equal with scales to rtol 1e-6, top-k ids equal;
the numpy fallbacks under ``NVDB_FORCE_PY_HOST=1``; and the build: two
processes that build at once leave one library and no partial file, and a
failed build raises with the compiler's message. These tests need a C++
compiler and skip without one."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nvdb_tpu import native as jnative
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu_torch import native
from nvdb_tpu_torch.formats import vecbin

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cxx():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler: the native library cannot be built")
    assert native.available()


def test_bf16_bits_equal_jax(cxx):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(10000).astype(np.float32) * 100
    x[:6] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -3.0e38]
    got = native.convert_f32_to_bf16(x)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, np.asarray(jnative.convert_f32_to_bf16(x)).view(np.uint16))
    np.testing.assert_array_equal(got, vecbin.to_bf16(x))


def test_bf16_nan_stays_nan(cxx):
    got = native.convert_f32_to_bf16(np.array([np.nan, 1.0], dtype=np.float32))
    assert np.isnan(vecbin.bf16_to_f32(got)[0]) and vecbin.bf16_to_f32(got)[1] == 1.0


def test_quantize_matches_jax(cxx):
    x = jsynth.normalized_gaussian(500, 96, seed=5)
    q, s = native.quantize_i8(x)
    jq, js = jnative.quantize_i8(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_allclose(s, js, rtol=1e-6)
    pq, ps = vecbin.quantize_i8(x)
    np.testing.assert_array_equal(q, pq)
    np.testing.assert_allclose(s, ps, rtol=1e-6)


def test_topk_ids_equal_jax(cxx):
    base = jsynth.clustered(5000, 64, n_clusters=16, seed=7)
    queries, _ = jsynth.sample_queries(base, 16, seed=8, perturb=0.05)
    sv, si = native.topk_dot_f32(base, queries, 10, threads=4)
    jv, ji = jnative.topk_dot_f32(base, queries, 10, threads=4)
    np.testing.assert_array_equal(si, ji)
    np.testing.assert_allclose(sv, jv, atol=1e-5, rtol=0)
    s64 = queries.astype(np.float64) @ base.T.astype(np.float64)
    got64 = np.take_along_axis(s64, si.astype(np.int64), axis=1)
    want64 = np.take_along_axis(s64, np.argsort(-s64, axis=1)[:, :10], axis=1)
    np.testing.assert_allclose(got64, want64, atol=1e-5)
    assert np.all(np.diff(sv, axis=1) <= 1e-6)


def test_topk_k_exceeds_n(cxx):
    base = jsynth.normalized_gaussian(5, 16, seed=9)
    sv, si = native.topk_dot_f32(base, base[:2], 8)
    assert (si[:, 5:] == 0xFFFFFFFF).all() and np.isneginf(sv[:, 5:]).all()
    assert (si[:, :5] < 5).all()


def test_forced_numpy_fallbacks_agree(cxx, monkeypatch):
    """``NVDB_FORCE_PY_HOST=1``: the numpy paths, equal to the native ones."""
    x = jsynth.clustered(800, 32, n_clusters=4, seed=3)
    native_out = (native.convert_f32_to_bf16(x), native.quantize_i8(x),
                  native.topk_dot_f32(x, x[:5], 7))
    monkeypatch.setenv("NVDB_FORCE_PY_HOST", "1")
    assert not native.available()
    np.testing.assert_array_equal(native.convert_f32_to_bf16(x), native_out[0])
    q, s = native.quantize_i8(x)
    np.testing.assert_array_equal(q, native_out[1][0])
    np.testing.assert_allclose(s, native_out[1][1], rtol=1e-6)
    v, i = native.topk_dot_f32(x, x[:5], 7)
    np.testing.assert_array_equal(i, native_out[2][1])
    np.testing.assert_allclose(v, native_out[2][0], atol=1e-5, rtol=0)


_BUILD = """
import sys
from pathlib import Path
from nvdb_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.build())
print(native.available())
"""


def test_parallel_builds_share_one_library(cxx, tmp_path):
    """Two processes that start building at once: the file lock makes one
    compile and the other load its library; no temporary file is left, and
    nothing is written under ``native/``."""
    before = sorted(os.listdir(ROOT / "native"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("NVDB_FORCE_PY_HOST", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].splitlines()[0] for o in outs}
    assert len(paths) == 1 and all(o[0].splitlines()[1] == "True" for o in outs)
    libs = [p for p in os.listdir(tmp_path) if p.endswith(".so")]
    assert libs == [Path(paths.pop()).name]
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    assert sorted(os.listdir(ROOT / "native")) == before


def test_failed_build_raises_with_the_compiler_message(cxx, tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native host library failed") as e:
        native.build()
    assert "error" in str(e.value) and "broken.cpp" in str(e.value)
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith((".so", ".tmp"))]
