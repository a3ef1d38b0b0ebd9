"""Batched Lloyd k-means in plain PyTorch (the port of
``nvdb_tpu.kernels.kmeans``; no Pallas kernel there, so none here).

- assignment: argmin of ||c||^2 - 2 x.c per chunk of rows, one full-f32
  matrix product (TF32 off), first index on ties;
- update: per-centroid sums and counts by ``index_add_``, where the JAX
  package multiplies by a one-hot matrix;
- k-means++ seeding on a subsample, and the split-largest step that moves
  under-populated centroids onto member points of the largest clusters;
- ``corpus_refine``: exact Lloyd passes over a whole corpus streamed from
  the host in chunks, sums and counts kept on the device, with the dead
  centroids reseeded from a pool the JAX package draws with numpy, so
  from the same starting centroids both packages give the same result up
  to the order of f32 sums.

Every function takes a leading group dimension G internally, so the M
subspace codebooks of PQ train as one batched run (the JAX ``vmap``); the
public functions without a ``_batched`` suffix take one group. Randomness
comes from an explicit ``torch.Generator`` on the data's device; it gives
other numbers than ``jax.random`` from the same seed.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.kernels import ops

_CHUNK = 16384  # rows per assignment chunk: bounds the [G, T, K] score slab


def _assign_chunk(chunk: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """[G, T, D], [G, K, D] -> [G, T] int64 nearest centroid (L2)."""
    ops.no_tf32()
    dots = torch.bmm(chunk, cents.transpose(1, 2))                  # [G, T, K]
    c2 = torch.sum(cents * cents, dim=2)[:, None, :]
    return torch.argmin(c2 - 2.0 * dots, dim=2)


def assign_batched(data: torch.Tensor, cents: torch.Tensor,
                   chunk: int = 65536) -> torch.Tensor:
    """[G, N, D], [G, K, D] -> [G, N] int64, chunked over rows."""
    return torch.cat([_assign_chunk(data[:, s:s + chunk], cents)
                      for s in range(0, data.shape[1], chunk)], dim=1)


def assign(data: torch.Tensor, centroids: torch.Tensor,
           chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment of all rows: [N, D], [K, D] -> [N] int32."""
    return assign_batched(data[None], centroids[None], chunk)[0].to(torch.int32)


def _lloyd_step(data: torch.Tensor, cents: torch.Tensor, chunk: int = _CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd pass over [G, N, D]. Returns (sums [G, K, D], counts
    [G, K], the summed squared distance [G])."""
    G, K, D = cents.shape
    sums = torch.zeros((G * K, D), dtype=torch.float32, device=data.device)
    counts = torch.zeros((G * K,), dtype=torch.float32, device=data.device)
    obj = torch.zeros((G,), dtype=torch.float32, device=data.device)
    offs = (torch.arange(G, device=data.device) * K)[:, None]
    for s in range(0, data.shape[1], chunk):
        x = data[:, s:s + chunk]
        a = _assign_chunk(x, cents)                                  # [G, T]
        flat = (a + offs).reshape(-1)
        sums.index_add_(0, flat, x.reshape(-1, D))
        counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
        picked = torch.gather(cents, 1, a[:, :, None].expand(-1, -1, D))
        obj += torch.sum((x - picked) ** 2, dim=(1, 2))
    return sums.reshape(G, K, D), counts.reshape(G, K), obj


def _sq_dist(sub: torch.Tensor, x2: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[G, m] squared distances of the rows [G, m, D] (squared norms ``x2``
    [G, m]) to one point a group ``c`` [G, D], as ||x||^2 - 2 x.c + ||c||^2:
    one matrix-vector product, no [G, m, D] temporary."""
    ops.no_tf32()
    xc = torch.bmm(sub, c[:, :, None])[:, :, 0]
    return x2 - 2.0 * xc + torch.sum(c * c, dim=1)[:, None]


def _draw(gen: torch.Generator, weights: torch.Tensor) -> torch.Tensor:
    """[G] one index a row of ``weights`` [G, m] (positive), drawn with
    probability proportional to its weight: a uniform draw against the
    float64 running sum."""
    cdf = torch.cumsum(weights.to(torch.float64), dim=1)
    u = torch.rand((weights.shape[0], 1), generator=gen, dtype=torch.float64,
                   device=weights.device) * cdf[:, -1:]
    return torch.clamp(torch.searchsorted(cdf, u, right=True)[:, 0], max=weights.shape[1] - 1)


def _kmeanspp_init(gen: torch.Generator, sub: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding over [G, m, D]: each next seed is drawn with
    probability proportional to its squared distance from the chosen set
    (``_sq_dist``; the f32 cancellation leaves a chosen row a weight near
    0, clamped to 1e-30 where it falls below)."""
    G, m, D = sub.shape
    rows = torch.arange(G, device=sub.device)
    first = torch.randint(0, m, (G,), generator=gen, device=sub.device)
    cents = torch.zeros((G, k, D), dtype=torch.float32, device=sub.device)
    x2 = torch.sum(sub * sub, dim=2)                                 # [G, m]
    c = sub[rows, first]                                             # [G, D]
    cents[:, 0] = c
    d2 = _sq_dist(sub, x2, c)
    for i in range(1, k):
        idx = _draw(gen, torch.clamp(d2, min=1e-30))
        c = sub[rows, idx]
        cents[:, i] = c
        d2 = torch.minimum(d2, _sq_dist(sub, x2, c))
    return cents


def kmeans_fit_batched(
    gen: torch.Generator,
    data: torch.Tensor,       # [G, N, D] f32
    n_clusters: int,
    n_iters: int = 10,
    chunk: int = _CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means of G independent groups. Returns (centroids [G, K, D],
    mean squared distance per iteration [G, n_iters])."""
    G, n, d = data.shape
    k = n_clusters
    dev = data.device
    # k-means++ on a subsample (random init merges nearby clusters)
    m = min(n, max(32 * k, 4096))
    sub_idx = torch.randperm(n, generator=gen, device=dev)[:m]
    cents = _kmeanspp_init(gen, data[:, sub_idx].to(torch.float32), k)

    mean_count = n / k
    # pool of candidate split points (first rows are as good as random here)
    pool = data[:, :min(n, 8192)].to(torch.float32)
    m_pool = pool.shape[1]
    rows = torch.arange(G, device=dev)[:, None]
    objs = []
    for it in range(n_iters):
        sums, counts, obj = _lloyd_step(data, cents, chunk)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        # the last two iterations run pure Lloyd so splits settle
        if it < max(n_iters - 2, 1):
            # split-largest: a centroid serving far under its share (a
            # duplicate inside a covered cluster) moves onto a member point
            # of one of the largest clusters, which the next step splits
            order_small = torch.argsort(counts, dim=1, stable=True)
            order_big = torch.argsort(-counts, dim=1, stable=True)
            donor_ok = torch.gather(counts, 1, order_small) < 0.55 * mean_count
            victim_ok = torch.gather(counts, 1, order_big) > 1.6 * mean_count
            pair_ok = donor_ok & victim_ok                           # [G, K]
            sub_a = assign_batched(pool, cents)                      # [G, m_pool]
            first_row = torch.full((G, k), m_pool, dtype=torch.int64, device=dev)
            first_row.scatter_reduce_(
                1, sub_a, torch.arange(m_pool, device=dev).expand(G, -1), "amin")
            pick = torch.gather(first_row, 1, order_big)
            donor_pos = torch.where((pick < m_pool)[:, :, None],
                                    pool[rows, torch.clamp(pick, max=m_pool - 1)],
                                    new[rows, order_big])
            new[rows, order_small] = torch.where(pair_ok[:, :, None], donor_pos,
                                                 new[rows, order_small])
        objs.append(obj / n)
        cents = new
    return cents, torch.stack(objs, dim=1)


def kmeans_fit(gen: torch.Generator, data: torch.Tensor, n_clusters: int,
               n_iters: int = 10, chunk: int = _CHUNK
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means of [N, D] rows. Returns (centroids [K, D] f32,
    objective trace [n_iters])."""
    cents, objs = kmeans_fit_batched(gen, data[None].to(torch.float32), n_clusters,
                                     n_iters=n_iters, chunk=chunk)
    return cents[0], objs[0]


def _corpus_partial(sums: torch.Tensor, counts: torch.Tensor, cents: torch.Tensor,
                    chunk: torch.Tensor, inner: int = _CHUNK) -> None:
    """Add one corpus chunk's Lloyd statistics into ``sums`` [K, D] and
    ``counts`` [K] in place, on the device: only the final centroids ever
    leave it. ``inner`` rows are assigned at a time, which bounds the
    [inner, K] score slab."""
    for s in range(0, chunk.shape[0], inner):
        x = chunk[s:s + inner]
        a = _assign_chunk(x[None], cents[None])[0]
        sums.index_add_(0, a, x)
        counts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))


def _corpus_update(cents: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor,
                   pool: torch.Tensor, reseed: bool) -> torch.Tensor:
    """Close one corpus pass: the mean where a centroid has rows, else the
    centroid as it was; with ``reseed``, each dead (or starved, under 5% of
    the mean count) centroid moves onto the first pool row of one of the
    oversized clusters (over 1.5x), smallest paired with largest: the
    split-largest step of ``kmeans_fit`` against the corpus's counts.
    Stable sorts and the first pool row of a cluster, as the JAX package's
    ``jnp.argsort`` and ``.at[].min`` give them."""
    k = cents.shape[0]
    new = torch.where(counts[:, None] > 0.5,
                      sums / torch.clamp(counts, min=1.0)[:, None], cents)
    if not reseed:
        return new
    mean_count = torch.sum(counts) / k
    order_small = torch.argsort(counts, stable=True)
    order_big = torch.argsort(-counts, stable=True)
    pair_ok = (counts[order_small] < 0.05 * mean_count) & (counts[order_big] > 1.5 * mean_count)
    m_pool = pool.shape[0]
    pool_a = assign_batched(pool[None], new[None], _CHUNK)[0]
    first_row = torch.full((k,), m_pool, dtype=torch.int64, device=pool.device)
    first_row.scatter_reduce_(0, pool_a, torch.arange(m_pool, device=pool.device), "amin")
    pick = first_row[order_big]
    ok = pair_ok & (pick < m_pool)
    donor_pos = pool[torch.clamp(pick, max=m_pool - 1)]
    new[order_small] = torch.where(ok[:, None], donor_pos, new[order_small])
    return new


def corpus_refine(
    data,                        # [N, Dp] f32: numpy on the host (streamed) or a tensor
    cents: torch.Tensor,         # [K, Dp] f32 on the device, from kmeans_fit
    n_iters: int = 2,
    chunk: int = 262144,
    pool_rows: int = 65536,
    seed: int = 17,
    log: Optional[Callable[[str], None]] = None,
) -> torch.Tensor:
    """Corpus-scale Lloyd refinement of a subsample-trained coarse quantizer
    (``nvdb_tpu.kernels.kmeans.corpus_refine``): ``n_iters`` exact Lloyd
    passes over the whole corpus, ``chunk`` rows at a time copied to the
    device of ``cents``, and after every pass but the last (and after the
    only pass when ``n_iters == 1``) the dead centroids are reseeded onto
    rows of the largest clusters, so the last pass settles pure Lloyd. The
    reseeding pool is ``pool_rows`` rows drawn by ``np.random.default_rng(seed)``,
    the JAX package's draw. ``log`` receives each pass's dead count.
    Returns the refined [K, Dp] f32 centroids on their device."""
    k, d = cents.shape
    dev = cents.device
    n = data.shape[0]

    def rows(sel) -> torch.Tensor:
        if torch.is_tensor(data):
            if isinstance(sel, np.ndarray):
                sel = torch.from_numpy(sel).to(data.device)
            return data[sel].to(dev, torch.float32)
        return torch.from_numpy(np.asarray(data[sel], np.float32)).to(dev)

    rng = np.random.default_rng(seed)
    pool = rows(np.sort(rng.choice(n, size=min(pool_rows, n), replace=False)))
    for it in range(n_iters):
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        for s in range(0, n, chunk):
            _corpus_partial(sums, counts, cents, rows(slice(s, s + chunk)))
        cents = _corpus_update(cents, sums, counts, pool,
                               reseed=n_iters == 1 or it < n_iters - 1)
        if log is not None:
            dead = int(torch.sum(counts < 0.5))
            log(f"corpus_refine pass {it + 1}/{n_iters}: dead={dead} "
                f"({100.0 * dead / k:.2f}%)")
    return cents
