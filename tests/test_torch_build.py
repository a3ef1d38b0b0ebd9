"""The kernel build cache of the port: its key covers every file under
``csrc/``, so an edited shared header rebuilds the libraries that include
it instead of loading a stale one. Runs without nvcc: only the key."""

import shutil

from nvdb_tpu_torch.kernels import _build


def test_digest_follows_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("flat_topk", "rerank_topk", "adc_topk")
    before = {n: _build.source_digest(n, csrc) for n in names}
    assert before == {n: _build.source_digest(n) for n in names}
    assert len(set(before.values())) == len(names)   # one library per source
    header = csrc / "topk_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.source_digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)


def test_digest_stable_and_follows_source(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    d0 = _build.source_digest("rerank_topk", csrc)
    assert _build.source_digest("rerank_topk", csrc) == d0
    src = csrc / "rerank_topk.cu"
    edited = src.read_text().replace("NT = 512", "NT = 128")
    assert edited != src.read_text()
    src.write_text(edited)
    assert _build.source_digest("rerank_topk", csrc) != d0


def test_digest_follows_defines():
    """A measurement build (preprocessor definitions) never shares a library
    with the port's own build of the same source."""
    plain = _build.source_digest("flat_topk")
    ablated = _build.source_digest("flat_topk", defines=("NVDB_FLAT_ABLATE=1",))
    assert plain != ablated
    assert ablated != _build.source_digest("flat_topk", defines=("NVDB_FLAT_ABLATE=2",))
    assert plain == _build.source_digest("flat_topk", defines=())
