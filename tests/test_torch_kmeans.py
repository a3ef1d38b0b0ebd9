"""k-means parity of the PyTorch port against ``nvdb_tpu.kernels.kmeans``:
the deterministic assignment bit for bit on the same centroids, and the fit
(other random numbers than JAX) by its objective, within 5% of JAX's on the
same data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdb_tpu.formats import synth as jsynth
from nvdb_tpu.kernels import kmeans as jkmeans
from nvdb_tpu_torch.kernels import kmeans


@pytest.fixture(scope="module")
def data():
    return jsynth.clustered(4096, 64, n_clusters=24, spread=0.5, seed=41)


def _objective(x, cents):
    a = kmeans.assign(torch.from_numpy(x), torch.as_tensor(np.array(cents))).numpy()
    return float(np.mean(np.sum((x - np.asarray(cents)[a]) ** 2, axis=1)))


@pytest.mark.parametrize("chunk", [512, 65536])
def test_assign_bit_for_bit(data, chunk):
    cents = data[np.random.default_rng(1).choice(len(data), 32, replace=False)] * 0.9
    got = kmeans.assign(torch.from_numpy(data), torch.from_numpy(cents), chunk=chunk)
    want = jkmeans.assign(jnp.asarray(data), jnp.asarray(cents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmeans_fit_objective_near_jax(data):
    cents, objs = kmeans.kmeans_fit(torch.Generator().manual_seed(0),
                                    torch.from_numpy(data), 24, n_iters=10)
    jcents, _ = jkmeans.kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(data), 24,
                                   n_iters=10)
    assert tuple(cents.shape) == (24, 64) and tuple(objs.shape) == (10,)
    assert torch.isfinite(cents).all()
    assert _objective(data, cents) <= 1.05 * _objective(data, jcents)
    # Lloyd steps after the splits settle never raise the objective
    o = objs.numpy()
    assert np.all(np.diff(o[-2:]) <= 1e-6)


def test_kmeans_fit_batched_groups_are_independent(data):
    """Two groups in one batched run fit as two separate runs would: each
    group's centroids come from its own data."""
    x = torch.from_numpy(data[:2048])
    y = torch.from_numpy(data[2048:] + 3.0)
    cents, _ = kmeans.kmeans_fit_batched(torch.Generator().manual_seed(0),
                                         torch.stack([x, y]), 8, n_iters=5)
    assert float(cents[0].mean()) < 1.0 < 2.0 < float(cents[1].mean())
