"""Format parity of the PyTorch port with the JAX package: vecbin and gtbin
files written by either package read identically by the other, bf16 bits
equal to ml_dtypes', and the port free of jax and ml_dtypes."""

import os
import re
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest

from nvdb_tpu.formats import gtbin as jgtbin
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu_torch.formats import gtbin, synth, vecbin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nvdb_tpu_torch")


def test_to_bf16_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200_000).astype(np.float32)
    with np.errstate(over="ignore"):
        x *= np.float32(2.0) ** rng.integers(-140, 128, x.size).astype(np.float32)
    specials = np.array([np.inf, -np.inf, 0.0, -0.0, 3.4e38, -3.4e38, 1e-45,
                         1.00390625, 1.01171875, np.nan, -np.nan], np.float32)
    raw = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = np.concatenate([x, specials, raw])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(vecbin.to_bf16(x), want)
    fin = np.isfinite(x)
    np.testing.assert_array_equal(
        vecbin.bf16_to_f32(want[fin]), want[fin].view(ml_dtypes.bfloat16).astype(np.float32))


def test_bf16_bits_to_torch_keeps_bits():
    import torch

    x = synth.normalized_gaussian(16, 32, seed=1)
    bits = vecbin.to_bf16(x)
    t = vecbin.bf16_bits_to_torch(bits)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)
    np.testing.assert_array_equal(t.float().numpy(), vecbin.bf16_to_f32(bits))


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16", "i8"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vecbin_cross_read(tmp_path, dtype, writer):
    x = jsynth.normalized_gaussian(300, 48, seed=2)
    path = str(tmp_path / f"{dtype}.vecbin")
    scales = None
    if dtype == "i8":
        rows, scales = vecbin.quantize_i8(x)
    elif dtype == "f16":
        rows = x.astype(np.float16)
    else:
        rows = x
    if writer == "port":
        if dtype == "bf16":
            rows = vecbin.to_bf16(x)
        vecbin.write_vecbin(path, rows, scales=scales)
    else:
        if dtype == "bf16":
            rows = jvecbin.to_bf16(x)
        jvecbin.write_vecbin(path, rows, scales=scales)
    a, b = vecbin.VecbinFile(path), jvecbin.VecbinFile(path)
    assert (a.count, a.dim, a.dtype) == (b.count, b.dim, b.dtype) == (300, 48, vecbin.dtype_code(dtype))
    np.testing.assert_array_equal(np.asarray(a.vectors).view(np.uint8),
                                  np.asarray(b.vectors).view(np.uint8))
    np.testing.assert_array_equal(a.rows_f32(10, 200), b.rows_f32(10, 200))
    if dtype == "i8":
        np.testing.assert_array_equal(np.asarray(a.scales), np.asarray(b.scales))


def test_vecbin_files_are_byte_identical(tmp_path):
    x = jsynth.normalized_gaussian(64, 40, seed=3)
    for dtype in ("f32", "bf16", "i8"):
        p1, p2 = str(tmp_path / f"p_{dtype}"), str(tmp_path / f"j_{dtype}")
        if dtype == "i8":
            c, sc = vecbin.quantize_i8(x)
            vecbin.write_vecbin(p1, c, scales=sc)
            jvecbin.write_vecbin(p2, c, scales=sc)
        elif dtype == "bf16":
            vecbin.write_vecbin(p1, vecbin.to_bf16(x))
            jvecbin.write_vecbin(p2, jvecbin.to_bf16(x))
        else:
            vecbin.write_vecbin(p1, x)
            jvecbin.write_vecbin(p2, x)
        assert open(p1, "rb").read() == open(p2, "rb").read()


def test_raw12_and_bad_files(tmp_path):
    x = jsynth.normalized_gaussian(20, 8, seed=4)
    path = str(tmp_path / "r.raw12")
    jvecbin.write_vecbin(path, x, legacy_raw12=True)
    f = vecbin.VecbinFile(path)
    assert f.info.legacy_raw12 and f.count == 20
    np.testing.assert_array_equal(f.rows_f32(), x)
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as fh:
        fh.write(b"\0" * 100)
    with pytest.raises(ValueError):
        vecbin.VecbinFile(bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gtbin_cross_read(tmp_path, writer):
    ids = np.random.default_rng(5).integers(0, 10_000, (17, 10)).astype(np.uint32)
    path = str(tmp_path / "gt.gtbin")
    (gtbin if writer == "port" else jgtbin).write_gtbin(path, ids, dim=384, N=10_000)
    (ia, a), (ib, b) = gtbin.read_gtbin(path), jgtbin.read_gtbin(path)
    assert (ia.Q, ia.k, ia.dim, ia.N, ia.metric) == (ib.Q, ib.k, ib.dim, ib.N, ib.metric)
    np.testing.assert_array_equal(np.asarray(a), ids)
    np.testing.assert_array_equal(np.asarray(b), ids)


def test_synth_and_quantize_match_jax():
    np.testing.assert_array_equal(synth.normalized_gaussian(50, 16, seed=6),
                                  jsynth.normalized_gaussian(50, 16, seed=6))
    c = synth.clustered(80, 16, n_clusters=4, seed=7)
    np.testing.assert_array_equal(c, jsynth.clustered(80, 16, n_clusters=4, seed=7))
    q, i = synth.sample_queries(c, 5, seed=8, perturb=0.1)
    jq, ji = jsynth.sample_queries(c, 5, seed=8, perturb=0.1)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(i, ji)
    for a, b in zip(vecbin.quantize_i8(c), jvecbin.quantize_i8(c)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk_seed", [None, 0, 262144])
def test_low_rank_and_hard_match_jax(chunk_seed):
    kw = dict(seed=5, chunk_seed=chunk_seed)
    np.testing.assert_array_equal(
        synth.low_rank(300, 48, intrinsic=8, n_clusters=6, spread=0.7, **kw),
        jsynth.low_rank(300, 48, intrinsic=8, n_clusters=6, spread=0.7, **kw))
    np.testing.assert_array_equal(synth.hard(400, 40, intrinsic=12, topics=9, **kw),
                                  jsynth.hard(400, 40, intrinsic=12, topics=9, **kw))


def test_hard_chunked_matches_jax_synth_tool(tmp_path):
    """``hard_chunked`` gives the rows ``nvdb_tpu.tools.synth --hard``
    writes, chunk seeds included (a small chunk stands in for 262,144)."""
    from nvdb_tpu.tools import synth as jsynth_tool

    path = str(tmp_path / "hard.vecbin")
    jsynth_tool.main([path, "--count", "700", "--dim", "32", "--hard", "6", "--seed", "1",
                      "--cpu"])
    want = vecbin.VecbinFile(path).rows_f32()
    np.testing.assert_array_equal(synth.hard_chunked(700, 32, intrinsic=6, seed=1), want)
    chunks = [jsynth.hard(n, 32, intrinsic=6, topics=256, seed=1, chunk_seed=s)
              for s, n in ((0, 300), (300, 300), (600, 100))]
    np.testing.assert_array_equal(synth.hard_chunked(700, 32, intrinsic=6, seed=1, chunk=300),
                                  np.concatenate(chunks))


def test_port_never_imports_jax_or_ml_dtypes():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ml_dtypes)\b", re.M)
    offenders = []
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                if pat.search(open(path).read()):
                    offenders.append(path)
    assert offenders == []
    assert not pat.search(open(os.path.join(ROOT, "chip_smoke.py")).read())


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['ml_dtypes'] = None; "
            "import nvdb_tpu_torch, nvdb_tpu_torch.bench, nvdb_tpu_torch.tools.bench, "
            "nvdb_tpu_torch.kernels.flat_scan, nvdb_tpu_torch.tools.ivf_build, "
            "nvdb_tpu_torch.tools.ivf_eval, nvdb_tpu_torch.index.ivf_pq, "
            "nvdb_tpu_torch.kernels.adc_scan, nvdb_tpu_torch.kernels.rerank, "
            "nvdb_tpu_torch.kernels.ivf_scan, nvdb_tpu_torch.kernels.hbm_stream, "
            "nvdb_tpu_torch.kernels.add1, nvdb_tpu_torch.index.partition, "
            "nvdb_tpu_torch.tools.pr_build, nvdb_tpu_torch.tools.pr_search, "
            "nvdb_tpu_torch.tools.pr_eval, nvdb_tpu_torch.tools.hbm_probe, "
            "nvdb_tpu_torch.tools.gpu_sanity; "
            "assert not any(m.startswith('nvdb_tpu.') or m == 'nvdb_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_streaming_writer_matches_jax(tmp_path, dtype):
    """Chunks appended to the port's StreamingVecbinWriter give the JAX
    writer's file byte for byte (bf16 as uint16 bits on the port's side);
    the i8 scales land after the payload, the header counts every row."""
    rows = np.random.default_rng(7).standard_normal((300, 40)).astype(np.float32)
    chunks = [(0, 128), (128, 256), (256, 300)]
    ours, theirs = str(tmp_path / "t.vecbin"), str(tmp_path / "j.vecbin")
    codes, sc = vecbin.quantize_i8(rows)
    with vecbin.StreamingVecbinWriter(ours, 40, dtype) as w, \
            jvecbin.StreamingVecbinWriter(theirs, 40, dtype) as jw:
        for a, b in chunks:
            if dtype == "i8":
                w.append(codes[a:b], sc[a:b])
                jw.append(codes[a:b], sc[a:b])
            elif dtype == "bf16":
                w.append(vecbin.to_bf16(rows[a:b]))
                jw.append(rows[a:b].astype(ml_dtypes.bfloat16))
            else:
                w.append(rows[a:b])
                jw.append(rows[a:b])
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    f = vecbin.VecbinFile(ours)
    assert (f.count, f.dim) == (300, 40)
    with pytest.raises(ValueError, match="scales"):
        with vecbin.StreamingVecbinWriter(str(tmp_path / "x.vecbin"), 40, "i8") as w:
            w.append(codes[:4])
