"""Store parity of the PyTorch port with the JAX package: payload, scales and
padding of ``VectorStore.from_numpy`` / ``from_vecbin`` / ``from_reference``
are bit-equal to the JAX store's for every store type."""

import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.formats import vecbin as jvecbin
from nvdb_tpu.store import VectorStore as JVectorStore
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.store import VectorStore

N, D, RB = 700, 72, 256


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw payload bytes of a torch tensor."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np.uint8)


def _assert_same(port: VectorStore, ref: JVectorStore):
    assert (port.n, port.d, port.dtype_code, port.src_dtype_code) == \
        (ref.n, ref.d, ref.dtype_code, ref.src_dtype_code)
    assert (port.n_padded, port.d_padded) == (ref.n_padded, ref.d_padded)
    np.testing.assert_array_equal(_bits(port.vectors), np.asarray(ref.vectors).view(np.uint8))
    if ref.scales is None:
        assert port.scales is None
    else:
        np.testing.assert_array_equal(port.scales.numpy(), np.asarray(ref.scales))
    assert port.payload_bytes == ref.payload_bytes
    assert port.hbm_bytes == ref.hbm_bytes


@pytest.fixture(scope="module")
def rows():
    return jsynth.clustered(N, D, n_clusters=6, seed=41)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8", "f16"])
def test_from_numpy_bit_equal(rows, dtype):
    x = rows.astype(np.float16) if dtype == "f16" else rows
    p = VectorStore.from_numpy(x, dtype=dtype, row_block=RB, device="cpu")
    j = JVectorStore.from_numpy(x, dtype=dtype, row_block=RB)
    _assert_same(p, j)
    # padding rows and dims are zero; padding rows get scale 1.0
    assert not _bits(p.vectors[N:]).any() and not _bits(p.vectors[:, D:]).any()
    if p.scales is not None:
        assert (p.scales[N:] == 1.0).all()


def test_from_numpy_pre_encoded(rows):
    codes, sc = vecbin.quantize_i8(rows)
    _assert_same(VectorStore.from_numpy(codes, dtype="i8", scales=sc, row_block=RB, device="cpu"),
                 JVectorStore.from_numpy(codes, dtype="i8", scales=sc, row_block=RB))
    bits = vecbin.to_bf16(rows)
    _assert_same(VectorStore.from_numpy(bits, dtype="bf16", row_block=RB, device="cpu"),
                 JVectorStore.from_numpy(rows, dtype="bf16", row_block=RB))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8", "f16"])
def test_from_vecbin_bit_equal(tmp_path, rows, dtype, monkeypatch):
    from nvdb_tpu_torch.store import store as store_mod

    path = str(tmp_path / f"{dtype}.vecbin")
    if dtype == "i8":
        codes, sc = jvecbin.quantize_i8(rows)
        jvecbin.write_vecbin(path, codes, scales=sc)
    elif dtype == "bf16":
        jvecbin.write_vecbin(path, jvecbin.to_bf16(rows))
    elif dtype == "f16":
        jvecbin.write_vecbin(path, rows.astype(np.float16))
    else:
        jvecbin.write_vecbin(path, rows)
    monkeypatch.setattr(store_mod, "_UPLOAD_ROWS", 128)  # several blocks, one ragged
    _assert_same(VectorStore.from_vecbin(path, row_block=RB, device="cpu"),
                 JVectorStore.from_vecbin(path, row_block=RB))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_from_reference_bit_equal(rows, dtype):
    j = JVectorStore.from_numpy(rows, dtype=dtype, row_block=RB)
    p = VectorStore.from_reference(
        np.asarray(j.vectors), None if j.scales is None else np.asarray(j.scales),
        j.n, j.d, j.dtype_code, j.src_dtype_code, device="cpu")
    _assert_same(p, j)


def test_pad_queries_matches_jax(rows):
    p = VectorStore.from_numpy(rows, row_block=RB, device="cpu")
    j = JVectorStore.from_numpy(rows, row_block=RB)
    q = rows[:5]
    np.testing.assert_array_equal(p.pad_queries(q), j.pad_queries(q))
    assert p.pad_queries(q).shape == (5, 128)
