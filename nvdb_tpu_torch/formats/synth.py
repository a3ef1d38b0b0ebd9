"""Seeded synthetic datasets (numpy only), the same generators and seeds as
``nvdb_tpu.formats.synth``: unit-L2-norm fp32 rows, optionally clustered.
The low-rank and hard corpora arrive with the IVF slices that need them."""

from __future__ import annotations

import numpy as np


def normalized_gaussian(count: int, dim: int, seed: int = 0,
                        dtype=np.float32) -> np.ndarray:
    """IID Gaussian rows, L2-normalized. The null model: no cluster structure."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((count, dim), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(dtype)


def clustered(count: int, dim: int, n_clusters: int = 64, spread: float = 0.25,
              seed: int = 0, dtype=np.float32, chunk_seed: int | None = None
              ) -> np.ndarray:
    """Mixture-of-Gaussians rows, L2-normalized. ``spread`` is the expected
    noise NORM relative to the unit centers (noise is scaled by 1/sqrt(dim)).
    ``chunk_seed``: for chunked generation pass the SAME ``seed`` (shared
    centers) and a per-chunk ``chunk_seed`` (assignments and noise)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    if chunk_seed is not None:
        rng = np.random.default_rng((seed, chunk_seed))
    assign = rng.integers(0, n_clusters, size=count)
    noise = rng.standard_normal((count, dim), dtype=np.float32) / np.sqrt(dim)
    x = centers[assign] + spread * noise
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(dtype)


def sample_queries(base: np.ndarray, q: int, seed: int = 0,
                   perturb: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``q`` unique base rows as queries (optionally perturbed), the
    nvdb_make_query scheme: seeded, unique, returns (queries_f32, indices)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(base.shape[0], size=q, replace=False)
    queries = np.asarray(base[idx], dtype=np.float32)
    if perturb > 0.0:
        queries = queries + perturb * rng.standard_normal(queries.shape).astype(np.float32)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return queries, idx.astype(np.uint32)
