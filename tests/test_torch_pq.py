"""PQ parity of the PyTorch port against ``nvdb_tpu.kernels.pq`` on the same
seeded numpy inputs.

Tolerances: ADC tables and scores to atol 1e-5 (f32 sums in another order);
the bf16 tables of ``adc_tables_reference`` against ``adc_lut(...).astype(
bfloat16)``: at least 99.9% of the live probes' entries bit-equal, the rest
one bf16 step off (an f32 sum in another order, then one rounding);
``encode`` on the same codebooks bit for bit; ``decode`` exact. Training
draws other random numbers than JAX, so trained codebooks and rotations are
held to the quantization MSE of JAX's on the same data, within 5%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.kernels import pq as jpq
from nvdb_tpu_torch.kernels import adc_scan, pq

M, D = 8, 64


@pytest.fixture(scope="module")
def data():
    x = jsynth.low_rank(4000, D, intrinsic=12, n_clusters=32, seed=21)
    rng = np.random.default_rng(22)
    cb = rng.standard_normal((M, pq.KSUB, D // M)).astype(np.float32) * 0.3
    res = rng.standard_normal((16, D)).astype(np.float32) * 0.3
    return x, cb, res


def _mse(x, cb, rot=None):
    """Quantization MSE of the port's encode/decode on (rotated) rows."""
    xt = torch.from_numpy(x)
    if rot is not None:
        xt = xt @ torch.as_tensor(np.array(rot))
    cbt = torch.as_tensor(np.array(cb))
    rec = pq.decode(pq.encode(xt, cbt, M), cbt, M)
    return float(torch.mean((xt - rec) ** 2))


def test_adc_lut_matches_jax(data):
    _, cb, res = data
    got = pq.adc_lut(torch.from_numpy(res), torch.from_numpy(cb), M).numpy()
    want = np.asarray(jpq.adc_lut(jnp.asarray(res), jnp.asarray(cb), M))
    assert got.shape == (16, M, pq.KSUB)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_adc_scores_matches_jax(data):
    _, cb, res = data
    lut = np.array(jpq.adc_lut(jnp.asarray(res), jnp.asarray(cb), M)).reshape(2, 8, M, 256)
    codes = np.random.default_rng(3).integers(0, 256, (2, 8, 50, M)).astype(np.uint8)
    got = pq.adc_scores(torch.from_numpy(lut), torch.from_numpy(codes)).numpy()
    want = np.asarray(jpq.adc_scores(jnp.asarray(lut), jnp.asarray(codes)))
    assert got.shape == (2, 8, 50)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_encode_bit_for_bit_and_decode_exact(data):
    x, cb, _ = data
    got = pq.encode(torch.from_numpy(x), torch.from_numpy(cb), M).numpy()
    want = np.asarray(jpq.encode(jnp.asarray(x), jnp.asarray(cb), M))
    assert got.dtype == np.uint8 and got.shape == (x.shape[0], M)
    np.testing.assert_array_equal(got, want)
    rec = pq.decode(torch.from_numpy(got), torch.from_numpy(cb), M).numpy()
    np.testing.assert_array_equal(rec, np.asarray(jpq.decode(jnp.asarray(want),
                                                             jnp.asarray(cb), M)))


def test_split_subspaces_matches_jax(data):
    x, _, _ = data
    np.testing.assert_array_equal(pq.split_subspaces(torch.from_numpy(x), M).numpy(),
                                  np.asarray(jpq.split_subspaces(jnp.asarray(x), M)))


def test_train_codebooks_mse_near_jax(data):
    x, _, _ = data
    got = pq.train_codebooks(torch.Generator().manual_seed(0), torch.from_numpy(x), M,
                             n_iters=8)
    want = jpq.train_codebooks(jax.random.PRNGKey(0), jnp.asarray(x), M, n_iters=8)
    assert tuple(got.shape) == (M, pq.KSUB, D // M)
    assert _mse(x, got) <= 1.05 * _mse(x, want)


def test_train_opq_mse_near_jax(data):
    x, _, _ = data
    rot, cb = pq.train_opq(torch.Generator().manual_seed(0), x[:2000], M,
                           n_opq_iters=3, device="cpu")
    jrot, jcb = jpq.train_opq(jax.random.PRNGKey(0), x[:2000], M, n_opq_iters=3)
    np.testing.assert_allclose(rot @ rot.T, np.eye(D), atol=1e-4)
    assert _mse(x, cb, rot) <= 1.05 * _mse(x, jcb, jrot)


def _ordered_bits(bits_u16):
    """bf16 bit patterns (uint16) as integers ordered like the values."""
    b = bits_u16.astype(np.int32)
    return np.where(b >= 0x8000, -(b & 0x7FFF), b)


@pytest.mark.parametrize("m,d,nlist,b,p", [(8, 64, 12, 6, 4), (16, 128, 20, 5, 7),
                                           (8, 128, 9, 3, 9)])
def test_adc_tables_reference_matches_jax(m, d, nlist, b, p):
    rng = np.random.default_rng(m * d + b)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    q_rot = (cents[rng.integers(0, nlist, b)]
             + 0.3 * rng.standard_normal((b, d))).astype(np.float32)
    cb = (0.3 * rng.standard_normal((m, pq.KSUB, d // m))).astype(np.float32)
    fills = rng.integers(1, 50, nlist).astype(np.int32)
    fills[2] = 0                                           # a dead list
    probes = np.stack([rng.choice(nlist, p, replace=False) for _ in range(b)]).astype(np.int32)
    probes[0, 0] = 2
    probes[1, 1] = -1                                      # out of range
    got = adc_scan.adc_tables_reference(torch.from_numpy(q_rot), torch.from_numpy(probes),
                                        torch.from_numpy(cents), torch.from_numpy(cb),
                                        torch.from_numpy(fills))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, p, m, pq.KSUB)
    live = adc_scan.live_probes(torch.from_numpy(probes), torch.from_numpy(fills)).numpy()
    np.testing.assert_array_equal(live, (probes >= 0) & (fills[np.maximum(probes, 0)] > 0))
    assert not live[0, 0] and not live[1, 1]
    assert bool((got[torch.from_numpy(~live)] == 0).all())  # dead probes: zeros
    res = jnp.asarray(q_rot)[:, None, :] - jnp.take(jnp.asarray(cents),
                                                    jnp.asarray(np.maximum(probes, 0)), axis=0)
    want = jpq.adc_lut(res.reshape(b * p, d), jnp.asarray(cb), m).astype(jnp.bfloat16)
    want_bits = np.asarray(want).reshape(b, p, m, pq.KSUB).view(np.uint16)
    got_bits = got.view(torch.int16).numpy().view(np.uint16)
    steps = np.abs(_ordered_bits(got_bits[live]) - _ordered_bits(want_bits[live]))
    assert np.mean(steps == 0) >= 0.999
    assert steps.max() <= 1
