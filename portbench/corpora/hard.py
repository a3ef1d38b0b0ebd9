"""The "hard" corpus of the partition index's recall study, made on the
device: the distribution of ``synth.hard`` (hierarchical topics with
Zipf-sized populations and subtopics in a low-dimensional latent space,
mapped through a random orthonormal basis, plus ambient noise,
L2-normalized), drawn by a ``torch.Generator``.

Parameters (the configuration's ``corpus``): ``n``, ``dim``, ``intrinsic``,
``topics``, ``subtopics``, ``zipf``, ``sub_scale``, ``point_scale``,
``ambient``."""

from __future__ import annotations

import torch

# rows a block while the latent points are mapped to the ambient space
_BLOCK = 262_144


def generate(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    n, dim, lat = int(p["n"]), int(p["dim"]), int(p["intrinsic"])
    topics, subs = int(p["topics"]), int(p["subtopics"])
    t_centers = torch.randn((topics, lat), generator=gen, device=device)
    s_centers = (t_centers[:, None, :] + float(p["sub_scale"]) * torch.randn(
        (topics, subs, lat), generator=gen, device=device)).reshape(topics * subs, lat)
    pop = 1.0 / torch.arange(1, topics + 1, device=device, dtype=torch.float64) ** float(p["zipf"])
    topic_of = torch.multinomial((pop / pop.sum()).float(), n, replacement=True, generator=gen)
    sub_of = topic_of * subs + torch.randint(0, subs, (n,), generator=gen, device=device)
    basis, _ = torch.linalg.qr(torch.randn((dim, lat), generator=gen, device=device))
    x = torch.randn((n, dim), generator=gen, device=device)
    x *= float(p["ambient"])
    z = torch.randn((n, lat), generator=gen, device=device)
    z *= float(p["point_scale"])
    z += s_centers[sub_of]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, n, _BLOCK):
            x[s:s + _BLOCK] += z[s:s + _BLOCK] @ basis.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x
