"""The one traffic generator: it reads a traffic mix (``traffic/<name>.json``)
and makes, from the seed, the pool of queries and the order in which a
closed-loop client sends them.

A mix holds ``loop`` ("closed": one client, one request outstanding),
``batch`` (queries a request), ``pool`` (distinct queries) and ``perturb``
(the noise ``tools.make_query --perturb`` adds to a sampled corpus row, per
dimension, before the query is normalized again)."""

from __future__ import annotations

import numpy as np
import torch


def check_mix(mix: dict) -> None:
    if mix.get("loop") != "closed":
        raise ValueError(f"only closed-loop mixes are generated, got {mix.get('loop')!r}")
    if int(mix["batch"]) < 1 or int(mix["pool"]) < int(mix["batch"]):
        raise ValueError(f"a mix needs 1 <= batch <= pool, got {mix}")


def make_pool(mix: dict, corpus: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """[pool, dim] f32 queries on the corpus's device: distinct corpus rows
    drawn by ``gen``, plus ``perturb`` Gaussian noise a dimension,
    L2-normalized."""
    rows = torch.randperm(corpus.shape[0], generator=gen, device=corpus.device)
    q = corpus[rows[:int(mix["pool"])]].clone()
    q += float(mix["perturb"]) * torch.randn(q.shape, generator=gen, device=q.device)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q


def send_order(mix: dict, seed: int) -> np.ndarray:
    """The pool indices in the order the client sends them: a permutation
    drawn from the seed, followed by its first ``batch`` entries again, so
    request r is the slice ``[o, o + batch)`` with ``o = r * batch % pool``
    and never wraps. Every seed sends the same sizes, in another order."""
    pool, batch = int(mix["pool"]), int(mix["batch"])
    perm = np.random.default_rng([seed & (2**63 - 1), 1]).permutation(pool)
    return np.concatenate([perm, perm[:batch]])
