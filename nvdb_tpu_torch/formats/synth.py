"""Seeded synthetic datasets (numpy only), the same generators and seeds as
``nvdb_tpu.formats.synth``, bit for bit: unit-L2-norm fp32 rows, iid,
clustered, low-rank or the "hard" hierarchical-topic corpus of the
partition index's recall study. ``hard_chunked`` reproduces
``nvdb_tpu.tools.synth --hard``'s file, chunk by chunk."""

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


def low_rank(count: int, dim: int, intrinsic: int = 32, n_clusters: int = 64,
             spread: float = 0.3, noise: float = 0.02, seed: int = 0,
             dtype=np.float32, chunk_seed: int | None = None) -> np.ndarray:
    """Low-intrinsic-dimension embeddings: clustered points in an
    ``intrinsic``-dim latent space mapped through a random orthonormal
    [dim, intrinsic] basis plus small ambient noise, L2-normalized."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.standard_normal((dim, intrinsic)))
    z = clustered(count, intrinsic, n_clusters=n_clusters, spread=spread,
                  seed=seed + 1, chunk_seed=chunk_seed)
    x = z @ basis.T.astype(np.float32)
    nrng = rng if chunk_seed is None else np.random.default_rng((seed, 7, chunk_seed))
    x += noise * nrng.standard_normal((count, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(dtype)


def hard(count: int, dim: int, intrinsic: int = 48, topics: int = 256,
         seed: int = 0, dtype=np.float32, chunk_seed: int | None = None
         ) -> np.ndarray:
    """Hierarchical topics -> 16 subtopics each, Zipf(0.8) topic sizes,
    subtopics at 0.6x the topic scale and points at 0.7x around them in an
    ``intrinsic``-dim latent space, so a query's neighbours straddle k-means
    cells; mapped through a random orthonormal basis shared by all chunks,
    plus 0.02 ambient noise, L2-normalized."""
    rng = np.random.default_rng(seed)
    sub_per_topic = 16
    t_centers = rng.standard_normal((topics, intrinsic), dtype=np.float32)
    s_centers = (t_centers[:, None, :] + 0.6 * rng.standard_normal(
        (topics, sub_per_topic, intrinsic), dtype=np.float32)
    ).reshape(topics * sub_per_topic, intrinsic)
    pop = 1.0 / np.arange(1, topics + 1) ** 0.8
    pop /= pop.sum()
    if chunk_seed is not None:
        rng = np.random.default_rng((seed, chunk_seed))
    topic_of = rng.choice(topics, size=count, p=pop)
    sub_of = topic_of * sub_per_topic + rng.integers(0, sub_per_topic, count)
    z = s_centers[sub_of] + 0.7 * rng.standard_normal(
        (count, intrinsic), dtype=np.float32)
    brng = np.random.default_rng(seed)  # basis shared across chunks
    basis, _ = np.linalg.qr(brng.standard_normal((dim, intrinsic)))
    x = z @ basis.T.astype(np.float32)
    x += 0.02 * rng.standard_normal((count, dim), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(dtype)


def hard_chunked(count: int, dim: int, intrinsic: int = 48, topics: int = 256,
                 seed: int = 0, chunk: int = 262144) -> np.ndarray:
    """The rows ``nvdb_tpu.tools.synth --hard INTRINSIC --seed SEED`` writes:
    ``hard`` in chunks of ``chunk`` rows, each seeded by its row offset."""
    out = np.empty((count, dim), np.float32)
    for s in range(0, count, chunk):
        n = min(chunk, count - s)
        out[s:s + n] = hard(n, dim, intrinsic=intrinsic, topics=topics, seed=seed,
                            chunk_seed=s)
    return out


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
