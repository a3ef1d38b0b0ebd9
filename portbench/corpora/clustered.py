"""Mixture-of-Gaussians rows, L2-normalized, made on the device: the
distribution of ``synth.clustered`` (unit centers, noise of expected norm
``spread``), drawn by a ``torch.Generator`` (other values, the same law).

Parameters (the configuration's ``corpus``): ``n``, ``dim``, ``clusters``,
``spread``."""

from __future__ import annotations

import math

import torch


def generate(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    n, dim, c = int(p["n"]), int(p["dim"]), int(p["clusters"])
    centers = torch.randn((c, dim), generator=gen, device=device)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    assign = torch.randint(0, c, (n,), generator=gen, device=device)
    x = torch.randn((n, dim), generator=gen, device=device)
    x *= float(p["spread"]) / math.sqrt(dim)
    x += centers[assign]
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x
