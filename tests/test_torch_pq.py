"""PQ parity of the PyTorch port against ``nvdb_tpu.kernels.pq`` on the same
seeded numpy inputs.

Tolerances: ADC tables and scores to atol 1e-5 (f32 sums in another order);
the bf16 tables of ``adc_tables_reference`` (the query's, the list's and the
pair's shares of each entry, combined) against ``adc_lut(...).astype(
bfloat16)`` of the residuals: at least 99.9% of the live probes' entries
bit-equal, the rest one bf16 step off (the same value by other f32 sums and
roundings, then one rounding), also for queries within 1e-3 of their
centroid, where the query's and the list's shares cancel; the query terms
``adc_query_terms_reference`` within a few f32 rounding errors of their
float64 value, its FMA emulation ``_fma`` bit for bit an exact rounding;
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


@pytest.mark.parametrize("m,d,nlist,b,p,spread", [
    (8, 64, 12, 6, 4, 0.3), (16, 128, 20, 5, 7, 0.3), (8, 128, 9, 3, 9, 0.3),
    (8, 96, 12, 6, 5, 0.3), (16, 48, 12, 6, 5, 0.3), (8, 96, 12, 6, 5, 1e-3 / 96 ** 0.5)])
def test_adc_tables_reference_matches_jax(m, d, nlist, b, p, spread):
    """dsub 8, 16, 12 and 3; the last case's queries lie within 1e-3 of the
    centroid their last probe names (the residual cancels)."""
    rng = np.random.default_rng(m * d + b)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    near = rng.integers(0, nlist, b)
    q_rot = (cents[near] + spread * rng.standard_normal((b, d))).astype(np.float32)
    cb = (0.3 * rng.standard_normal((m, pq.KSUB, d // m))).astype(np.float32)
    fills = rng.integers(1, 50, nlist).astype(np.int32)
    fills[2] = 0                                           # a dead list
    probes = np.stack([rng.choice(nlist, p, replace=False) for _ in range(b)]).astype(np.int32)
    probes[:, -1] = near
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


def test_fma_emulation_rounds_once():
    """``adc_scan._fma`` is a * b + c rounded once to f32: on random
    operands of far-apart scales against exact rational arithmetic, and on a
    sum that float64 rounds onto an f32 tie (1 + 2^-24 + 2^-54, which
    rounding twice would take to 1)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (rng.standard_normal(400) * np.exp(rng.uniform(-20, 20, 400))).astype(np.float32)
    a[:2], b[:2], c[:2] = [62525.0, -62525.0], [17173 * 2.0 ** -54] * 2, [1.0, -1.0]
    got = adc_scan._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        want = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert g == want
    assert got[0] == np.float32(1 + 2.0 ** -23) and got[1] == -got[0]


@pytest.mark.parametrize("dsub", [3, 8, 12])
def test_adc_query_terms_reference_against_float64(dsub):
    """The query's share of each entry, c2 - 2 q_m . cb_j, against the
    float64 product: within four f32 rounding errors of the terms' sizes."""
    m, b = 6, 5
    rng = np.random.default_rng(dsub)
    q = rng.standard_normal((b, m * dsub)).astype(np.float32)
    cb = (0.3 * rng.standard_normal((m, pq.KSUB, dsub))).astype(np.float32)
    got = adc_scan.adc_query_terms_reference(torch.from_numpy(q), torch.from_numpy(cb))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m, pq.KSUB)
    q64 = q.astype(np.float64).reshape(b, m, 1, dsub)
    cb64 = cb.astype(np.float64)
    c2 = np.sum(cb64 * cb64, axis=2)
    qdot = np.sum(q64 * cb64[None], axis=3)
    want = c2[None] - 2.0 * qdot
    size = c2[None] + 2.0 * np.sum(np.abs(q64 * cb64[None]), axis=3)
    assert np.all(np.abs(got.numpy() - want) <= 4 * dsub * 2.0 ** -24 * size)
