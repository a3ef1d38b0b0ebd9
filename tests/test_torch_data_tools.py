"""The port's data tools against the JAX package's on the same files:
``convert_bf16`` (bf16 and ``--f16``), ``slice``, ``synth`` (every corpus
kind, ``--raw12``, ``--resume``) and ``make_query`` write byte-equal files;
``gt_build`` gives the JAX tool's ids on its three paths (device, chunked,
``--host``); ``dump``, ``sanity`` and ``search`` print the same rows, norms,
ids and scores (scores to 1e-5); ``ab_compare`` prints the JAX tool's
``RESULT`` keys; ``tools.ivf_eval`` writes the JAX tool's stage TSV under
``NVDB_DBG_DIR``; ``eval.trace.Tracer`` and ``tools.embed``'s chunking match
the JAX package's. The tools run with ``--device cpu``."""

import os
import re
import time

import numpy as np
import pytest

from nvdb_tpu.formats import gtbin as jgtbin
from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.tools import ab_compare as jab_compare
from nvdb_tpu.tools import convert_bf16 as jconvert_bf16
from nvdb_tpu.tools import dump as jdump
from nvdb_tpu.tools import embed as jembed
from nvdb_tpu.tools import gt_build as jgt_build
from nvdb_tpu.tools import make_query as jmake_query
from nvdb_tpu.tools import sanity as jsanity
from nvdb_tpu.tools import search as jsearch
from nvdb_tpu.tools import slice as jslice
from nvdb_tpu.tools import synth as jsynth_tool
from nvdb_tpu_torch.eval.trace import Tracer
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools import (ab_compare, convert_bf16, dump, embed, gt_build,
                                  make_query, sanity, search)
from nvdb_tpu_torch.tools import slice as slice_tool
from nvdb_tpu_torch.tools import synth as synth_tool

CPU = ["--device", "cpu"]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_data_tools")
    base = jsynth.clustered(3000, 64, n_clusters=8, spread=1.0, seed=81)
    queries, _ = jsynth.sample_queries(base, 12, seed=82, perturb=0.05)
    paths = {"f32": str(d / "base.vecbin"), "i8": str(d / "base_i8.vecbin"),
             "q": str(d / "q.vecbin"), "dir": d}
    jvecbin.write_vecbin(paths["f32"], base)
    codes, scales = jvecbin.quantize_i8(base)
    jvecbin.write_vecbin(paths["i8"], codes, scales=scales)
    jvecbin.write_vecbin(paths["q"], queries)
    return paths


def _pair(files, name):
    return str(files["dir"] / f"t_{name}"), str(files["dir"] / f"j_{name}")


@pytest.mark.parametrize("flag", [[], ["--f16"]])
def test_convert_bf16_byte_equal(files, capsys, flag):
    ours, theirs = _pair(files, f"conv{len(flag)}.vecbin")
    info = convert_bf16.main([files["f32"], ours, *flag, *CPU])
    jconvert_bf16.main([files["f32"], theirs, *flag])
    assert _bytes(ours) == _bytes(theirs)
    assert info.dtype == (vecbin.DTYPE_F16 if flag else vecbin.DTYPE_BF16)
    assert capsys.readouterr().out.count("wrote 3000 x 64") == 2


@pytest.mark.parametrize("src,flag", [("f32", []), ("i8", []), ("f32", ["--raw12"])])
def test_slice_byte_equal(files, capsys, src, flag):
    ours, theirs = _pair(files, f"slice_{src}{len(flag)}.vecbin")
    assert slice_tool.main([files[src], ours, "--n", "700", *flag, *CPU]) == 700
    jslice.main([files[src], theirs, "--n", "700", *flag])
    assert _bytes(ours) == _bytes(theirs)
    f = vecbin.VecbinFile(ours)
    assert f.count == 700 and f.info.legacy_raw12 == bool(flag)


@pytest.mark.parametrize("argv", [
    [],
    ["--clusters", "16", "--spread", "0.5"],
    ["--low-rank", "8", "--clusters", "70"],
    ["--hard", "12"],
    ["--clusters", "16", "--dtype", "bf16"],
    ["--low-rank", "8", "--dtype", "i8"],
    ["--hard", "12", "--raw12"],
], ids=["iid", "clusters", "low_rank", "hard", "bf16", "i8", "raw12"])
def test_synth_byte_equal(files, capsys, argv):
    ours, theirs = _pair(files, "synth.vecbin")
    common = ["--count", "2500", "--dim", "48", "--seed", "9", *argv]
    synth_tool.main([ours, *common, *CPU])
    jsynth_tool.main([theirs, *common])
    assert _bytes(ours) == _bytes(theirs)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_synth_resume_byte_equal(files, capsys, dtype):
    """An interrupted write (header count 0, a partial last chunk) resumed
    with ``--resume``, and a smaller file extended, both give the JAX tool's
    uninterrupted file: chunks of 262,144 rows are seeded by their offset."""
    dim, count = 4, synth_tool.CHUNK + 900
    common = ["--count", str(count), "--dim", str(dim), "--clusters", "6", "--seed", "2",
              "--dtype", dtype]
    full = str(files["dir"] / f"j_full_{dtype}.vecbin")
    jsynth_tool.main([full, *common])
    row_bytes = dim * (2 if dtype == "bf16" else 4)
    cut = str(files["dir"] / f"t_cut_{dtype}.vecbin")
    with open(cut, "wb") as f:       # as an interrupted run leaves it: count 0
        f.write(vecbin._header_bytes(0, dim, vecbin.dtype_code(dtype)))
        f.write(_bytes(full)[vecbin.HEADER_BYTES:][:(count - 400) * row_bytes])
    synth_tool.main([cut, *common, "--resume", *CPU])
    assert "resuming at row 262144" in capsys.readouterr().out
    assert _bytes(cut) == _bytes(full)
    small = str(files["dir"] / f"t_small_{dtype}.vecbin")
    synth_tool.main([small, *common[:1], str(synth_tool.CHUNK), *common[2:], *CPU])
    synth_tool.main([small, *common, "--resume", *CPU])
    assert _bytes(small) == _bytes(full)


def test_make_query_byte_equal(files, capsys):
    ours, theirs = _pair(files, "mq.vecbin")
    args = ["--q", "40", "--seed", "5", "--perturb", "0.05"]
    idx = make_query.main([files["f32"], ours, *args, *CPU])
    t_out = capsys.readouterr().out
    jmake_query.main([files["f32"], theirs, *args])
    j_out = capsys.readouterr().out
    assert _bytes(ours) == _bytes(theirs)
    assert t_out == j_out.replace(theirs, ours) and len(idx) == 40


@pytest.mark.parametrize("path", [[], ["--row-chunk", "700"], ["--host"]],
                         ids=["device", "chunked", "host"])
def test_gt_build_ids_equal_jax(files, capsys, path):
    """The three paths against the JAX tool's same path: equal ids, so the
    gtbin files are byte-equal."""
    ours, theirs = _pair(files, "gt.gtbin")
    ids = gt_build.main([files["f32"], files["q"], ours, "--k", "10", "--batch", "5",
                         *path, *CPU])
    jgt_build.main([files["f32"], files["q"], theirs, "--k", "10", "--batch", "5",
                    "--backend", "jnp", *path])
    assert "wrote GT [12 x 10] over N=3000" in capsys.readouterr().out
    assert ids.dtype == np.uint32 and ids.shape == (12, 10)
    _, want = jgtbin.read_gtbin(theirs)
    np.testing.assert_array_equal(ids, np.asarray(want))
    assert _bytes(ours) == _bytes(theirs)


def test_gt_build_metric_l2_and_host_refusal(files, capsys):
    ours, theirs = _pair(files, "gt_l2.gtbin")
    ids = gt_build.main([files["i8"], files["q"], ours, "--metric", "l2", *CPU])
    jgt_build.main([files["i8"], files["q"], theirs, "--metric", "l2", "--backend", "jnp"])
    _, want = jgtbin.read_gtbin(theirs)
    np.testing.assert_array_equal(ids, np.asarray(want))
    msgs = []
    for main, extra in ((gt_build.main, CPU), (jgt_build.main, [])):
        with pytest.raises(SystemExit) as e:
            main([files["f32"], files["q"], ours, "--host", "--metric", "l2", *extra])
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and "dot-metric only" in msgs[0]


def test_dump_prints_what_jax_prints(files, capsys):
    for src in ("f32", "i8"):
        dump.main([files[src], "--rows", "4", "--cols", "6", *CPU])
        ours = capsys.readouterr().out
        jdump.main([files[src], "--rows", "4", "--cols", "6"])
        assert ours == capsys.readouterr().out and "row3:" in ours


def test_sanity_same_rows_and_norms(files, capsys):
    norms = sanity.main([files["i8"], "--samples", "6", "--seed", "3", *CPU])
    ours = capsys.readouterr().out
    jsanity.main([files["i8"], "--samples", "6", "--seed", "3"])
    theirs = capsys.readouterr().out
    assert ours == theirs and ours.strip().endswith("OK") and len(norms) >= 5


def test_sanity_fails_on_a_nan_row(files, tmp_path, capsys):
    rows = np.ones((4, 8), np.float32)
    rows[:, 2] = np.nan
    path = str(tmp_path / "nan.vecbin")
    jvecbin.write_vecbin(path, rows)
    with pytest.raises(SystemExit) as e:
        sanity.main([path, "--samples", "2", *CPU])
    assert e.value.code == 2 and "FAIL" in capsys.readouterr().err


_HIT = re.compile(r"#(\d+): id=(\d+) score=(\S+)")


@pytest.mark.parametrize("src", ["f32", "i8"])
def test_search_prints_the_same_ids(files, capsys, src):
    vals, ids = search.main([files[src], files["q"], "--k", "5", "--q", "3", *CPU])
    ours = _HIT.findall(capsys.readouterr().out)
    jsearch.main([files[src], files["q"], "--k", "5", "--q", "3", "--backend", "jnp"])
    theirs = _HIT.findall(capsys.readouterr().out)
    assert len(ours) == len(theirs) == 15 and ids.shape == (3, 5)
    assert [(r, i) for r, i, _ in ours] == [(r, i) for r, i, _ in theirs]
    np.testing.assert_allclose([float(s) for *_, s in ours],
                               [float(s) for *_, s in theirs], atol=1e-5, rtol=0)


def test_ab_compare_result_keys_match_jax(files, capsys):
    res = ab_compare.main([files["f32"], files["q"], "--pairs", "4", "--a", "torch",
                           "--b", "torch", "--batch-q", "4", *CPU])
    ours = capsys.readouterr().out
    jab_compare.main([files["f32"], files["q"], "--pairs", "4", "--a", "jnp", "--b", "jnp",
                      "--batch-q", "4"])
    theirs = capsys.readouterr().out

    def keys(out):
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        assert len(line) == 1
        return [kv.split("=", 1)[0] for kv in line[0].split()[1:]]

    assert keys(ours) == keys(theirs) == ["ab_a", "ab_b", "pairs", "mean_delta_ms",
                                          "ci_half_ms"]
    assert "mean(A-B)" in ours and "verdict:" in ours and res["pairs"] == 4


def test_ab_compare_cuda_side_needs_a_card(files, capsys):
    """``--a cuda`` on the CPU raises: the kernel never runs its plain
    version in its place."""
    with pytest.raises(ValueError, match="CUDA"):
        ab_compare.main([files["f32"], files["q"], "--pairs", "2", "--a", "cuda",
                         "--b", "torch", *CPU])


def test_tracer_spans(tmp_path):
    """Mirrors tests/test_trace_config.py: a span holds its ``sync``, the TSV
    has the JAX package's columns."""
    tr = Tracer()
    with tr.span("stage_a"):
        time.sleep(0.01)
    with tr.span("stage_a"):
        pass
    with tr.span("stage_b", sync=lambda: time.sleep(0.005)):
        pass
    assert len(tr.samples_ms["stage_a"]) == 2
    assert tr.samples_ms["stage_a"][0] >= 10.0 and tr.samples_ms["stage_b"][0] >= 5.0
    assert set(tr.totals()) == {"stage_a", "stage_b"}
    out = str(tmp_path / "t.tsv")
    tr.dump_tsv(out)
    lines = open(out).read().strip().split("\n")
    assert lines[0] == "span\tsample\tms" and len(lines) == 4
    assert "stage_a: total=" in tr.render()


def test_ivf_eval_dbg_dir_tsv_matches_jax(files, tmp_path, monkeypatch, capsys):
    """``NVDB_DBG_DIR``: both packages' ivf_eval write one stage TSV per
    staged grid point, with the same name, header and spans."""
    from nvdb_tpu.tools import ivf_eval as jivf_eval
    from nvdb_tpu_torch.tools import ivf_build, ivf_eval

    idx = str(tmp_path / "pq.npz")
    ivf_build.main([files["f32"], idx, "--kind", "ivfpq", "--nlist", "8", "--pq-m", "8",
                    "--no-opq", *CPU])
    args = [idx, files["f32"], files["q"], "--nprobe", "4", "--refine-k", "0", "20",
            "--batch-q", "4", "--warmup", "0"]
    listing = {}
    for name, main, extra in (("port", ivf_eval.main, CPU),
                              ("jax", jivf_eval.main, ["--cpu", "--ivf-backend", "jnp"])):
        d = tmp_path / name
        monkeypatch.setenv("NVDB_DBG_DIR", str(d))
        main(args + extra)
        listing[name] = {p: open(d / p).read().splitlines() for p in sorted(os.listdir(d))}
    capsys.readouterr()
    assert list(listing["port"]) == list(listing["jax"]) == [
        "stages_ivfpq_np4_r0_q12_k10.tsv", "stages_ivfpq_np4_r20_q12_k10.tsv"]
    for name, lines in listing["port"].items():
        theirs = listing["jax"][name]
        assert lines[0] == theirs[0] == "span\tsample\tms"
        assert [x.split("\t")[:2] for x in lines] == [x.split("\t")[:2] for x in theirs]


_TEXTS = [
    ". ".join(f"Sentence number {i} with some words" for i in range(50)) + ".",
    "x" * 500,
    "",
    "   ",
    "Short one. Then a question? And a shout! " + "y" * 130 + ". Tail.",
]


@pytest.mark.parametrize("max_chars", [40, 100, 120, 1000])
def test_chunk_text_matches_jax(max_chars):
    """Mirrors tests/test_embed_chunking.py on the same strings."""
    for text in _TEXTS:
        got = embed.chunk_text(text, max_chars)
        assert got == jembed.chunk_text(text, max_chars)
        assert all(len(c) <= max_chars for c in got)
    assert embed.chunk_text("x" * 500, 100) == ["x" * 100] * 5


def test_iter_texts_matches_jax(tmp_path):
    docs = {"a.jsonl": '{"text": "one. two."}\n{"body": "x"}\n',
            "b.csv": 'text,other\n"hello, there",1\nbye,2\n',
            "c.txt": "line one\nline two\n"}
    for name, content in docs.items():
        p = tmp_path / name
        p.write_text(content)
        assert list(embed._iter_texts(str(p), "text")) == list(jembed._iter_texts(str(p),
                                                                                  "text"))


def test_embed_exits_3_without_a_local_model(tmp_path, monkeypatch, capsys):
    """No model on the machine: exit 3 naming the model; nothing downloads."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    corpus = tmp_path / "c.txt"
    corpus.write_text("A sentence. Another one.\n")
    with pytest.raises(SystemExit) as e:
        embed.main([str(corpus), str(tmp_path / "out.vecbin"), "--model",
                    str(tmp_path / "no_such_model"), *CPU])
    assert e.value.code == 3
    assert "unavailable locally" in capsys.readouterr().err
    assert not (tmp_path / "out.vecbin").exists()
