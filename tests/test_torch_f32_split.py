"""The f32 instance of the flat kernel scores on the tensor cores by the
three-way bf16 split of both operands in six passes, as the TPU's
``Precision.HIGHEST`` does. Its plain model, ``flat_scan.split_bf16x3`` and
``flat_scan.six_pass_scores``, is held here against the JAX package on the
same seeded numpy inputs: the split against JAX's own bf16 rounding, the
six-pass top-k against ``nvdb_tpu.kernels.ops.scan_topk`` (HIGHEST on the
CPU) and ``pallas_flat_topk`` in interpret mode. Also the host side of the
change: routing and the add1 launch arithmetic. The kernel itself runs in
test_torch_gpu.py.

Tolerances: the split rebuilds x bit for bit wherever x's bits lie at or
above 2^-133 (bf16's least subnormal), and within 2^-133 below; top-k values
to atol 1e-5 / rtol 1e-5 (f32 sums in another order) and a float64 regret
<= 1e-5, as the other flat parity tests."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.kernels import ops as jops
from nvdb_tpu.kernels.flat_scan import pallas_flat_topk
from nvdb_tpu_torch.kernels import add1, flat_scan, ops

N, NP, D, DP, B = 2000, 2048, 96, 128, 8
TINY = 2.0 ** -133   # bf16's least subnormal


def _edge_values():
    f = np.float32
    one = f(1.0)
    ties = [f(1.0 + 2.0 ** -8), f(1.0 + 3 * 2.0 ** -8), f(-(1.0 + 2.0 ** -8)),
            f(2.0 ** 20 * (1 + 2.0 ** -8))]          # exactly halfway between two bf16
    near_min = [f(2.0 ** -126), f(-(2.0 ** -126)), f(1.5 * 2.0 ** -126),
                np.nextafter(f(2.0 ** -126), one), np.nextafter(f(2.0 ** -126), f(0)),
                f(2.0 ** -126 + 2.0 ** -133), f(2.0 ** -110 * 1.2345)]
    return np.array([0.0, -0.0, 1e30, -1e30, 3.3e38, -2.5, 1.0, -1.0,
                     *ties, *near_min], np.float32)


@pytest.fixture(scope="module")
def values():
    rng = np.random.default_rng(81)
    x = rng.standard_normal(20000).astype(np.float32)
    x *= np.float32(2.0) ** rng.integers(-100, 100, x.shape).astype(np.float32)
    return np.concatenate([x, _edge_values()])


def test_split_parts_are_bf16_and_h_is_jax_rounding(values):
    """h is x rounded to the nearest bf16, ties to even, exactly as JAX
    rounds; m and l are bf16 values too."""
    x = torch.from_numpy(values)
    h, m, l = flat_scan.split_bf16x3(x)
    want_h = np.asarray(jnp.asarray(values).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(h.numpy(), want_h)
    for part in (h, m, l):
        assert torch.equal(part, part.to(torch.bfloat16).to(torch.float32))
    # round to even at the ties: 1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6
    t = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])
    assert flat_scan.split_bf16x3(t)[0].tolist() == [1.0, 1.0 + 2.0 ** -6]


def test_split_rebuilds_x(values):
    """h + m + l == x bit for bit where x's lowest set bit is at or above
    2^-133 (every |x| >= 2^-110 and all of the seeded values); below it the
    split loses at most 2^-133. A zero's high part keeps its sign (the sum
    of -0 and +0 is +0, as it is on the card)."""
    x = torch.from_numpy(values)
    h, m, l = flat_scan.split_bf16x3(x)
    back = ((h + m) + l).numpy()
    x64 = values.astype(np.float64)
    exact = np.mod(x64, TINY) == 0
    assert exact.sum() > 20000
    np.testing.assert_array_equal(back[exact], values[exact])
    assert np.all(np.abs(back.astype(np.float64) - x64) <= TINY)
    zero = values == 0
    assert zero.sum() == 2 and (back[zero] == 0).all()
    assert np.array_equal(np.signbit(h.numpy()[zero]), np.signbit(values[zero]))
    # the two subtractions are exact: x - h and (x - h) - m in f32 equal float64
    r = (x - h).numpy().astype(np.float64)
    np.testing.assert_array_equal(r[exact], (x64 - h.numpy().astype(np.float64))[exact])


def test_six_passes_drop_only_the_small_terms():
    """The six passes are every (query part, row part) pair but m l, l m and
    l l, each once, and the last one is the products of the high parts."""
    pairs = set(flat_scan.SIX_PASSES)
    assert len(pairs) == 6
    every = {(a, b) for a in range(3) for b in range(3)}
    assert every - pairs == {(1, 2), (2, 1), (2, 2)}
    assert flat_scan.SIX_PASSES[-1] == (0, 0)


@pytest.fixture(scope="module")
def data():
    base = jsynth.clustered(N, D, n_clusters=8, seed=31)
    queries, _ = jsynth.sample_queries(base, B, seed=32, perturb=0.05)
    base_p = np.zeros((NP, DP), np.float32)
    base_p[:N, :D] = base
    q_p = np.zeros((B, DP), np.float32)
    q_p[:, :D] = queries
    return base_p, q_p


def _six_pass_topk(q_p, base_p, n_valid, k):
    s = flat_scan.six_pass_scores(torch.from_numpy(q_p), torch.from_numpy(base_p[:n_valid]))
    ids = torch.arange(n_valid, dtype=torch.int32).expand(q_p.shape[0], -1)
    v, i = ops.topk_sorted(s, ids, k)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n_valid", [N, 1500])
def test_six_pass_topk_matches_jax_highest(data, k, n_valid):
    """The six-pass model's top-k against JAX's f32 scan at HIGHEST."""
    base_p, q_p = data
    jv, ji = jops.scan_topk(jnp.asarray(q_p), jnp.asarray(base_p), None, n_valid, k)
    tv, ti = _six_pass_topk(q_p, base_p, n_valid, k)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=1e-5)
    s64 = q_p.astype(np.float64) @ base_p[:n_valid].astype(np.float64).T
    ref = -np.sort(-s64, axis=1)[:, :k]
    got = -np.sort(-np.take_along_axis(s64, ti.astype(np.int64), axis=1), axis=1)
    assert np.max(ref - got) <= 1e-5
    assert np.mean(ti == np.asarray(ji)) >= 0.95


@pytest.mark.parametrize("k", [10, 128])
def test_six_pass_topk_matches_pallas_interpret(data, k):
    """The same against the Pallas kernel on an f32 store, in interpret mode."""
    base_p, q_p = data
    jv, ji = pallas_flat_topk(jnp.asarray(q_p), jnp.asarray(base_p), None, N, k,
                              interpret=True)
    tv, ti = _six_pass_topk(q_p, base_p, N, k)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=1e-5)
    assert np.mean(ti == np.asarray(ji)) >= 0.95


def test_six_pass_scores_close_to_f32(data):
    """Scores of the split within 1e-5 of the true f32 product (TF32 off)."""
    base_p, q_p = data
    q, v = torch.from_numpy(q_p), torch.from_numpy(base_p)
    ops.no_tf32()
    torch.testing.assert_close(flat_scan.six_pass_scores(q, v), q @ v.T, atol=1e-5, rtol=1e-5)


def test_f32_kernel_argument_never_falls_back(data):
    """The SIMT kernel is an explicit A/B: an f32 store routes to the
    tensor cores; on a CPU tensor the wrapper raises whichever kernel is
    asked for, and counts no launch."""
    assert flat_scan.kernel_for(torch.float32) == flat_scan.TENSOR_CORE
    base_p, q_p = data
    q, v = torch.from_numpy(q_p), torch.from_numpy(base_p)
    before = dict(flat_scan.LAUNCHES_BY_KERNEL)
    for kern in (flat_scan.SIMT, flat_scan.TENSOR_CORE):
        with pytest.raises(ValueError, match="CUDA tensors"):
            flat_scan.flat_topk_cuda(q, v, None, N, 10, f32_kernel=kern)
    assert flat_scan.LAUNCHES_BY_KERNEL == before
    assert set(before) == {"f32_simt", "f32_tensor_core", "bf16", "int8", "int8_int8"}


@pytest.mark.parametrize("n,blocks", [(1, 1), (3, 1), (1024, 1), (4095, 1), (4096, 1),
                                      (4097, 5), (8192, 8), (10 ** 6, 977),
                                      (2 ** 31 - 1, 1024)])
def test_add1_launch_blocks(n, blocks):
    """One CTA of 256 threads up to 4,096 elements (four 16-byte pieces a
    thread: the [8, 128] round trip takes one), then one CTA per 1,024
    elements up to 1,024 CTAs that stride over the rest."""
    assert add1.launch_blocks(n) == blocks


def test_add1_launch_blocks_rejects_empty():
    with pytest.raises(ValueError):
        add1.launch_blocks(0)
