"""Product quantization in plain PyTorch (the port of ``nvdb_tpu.kernels.pq``;
no Pallas kernel there): codebook training batched over the M subspaces,
OPQ rotation by orthogonal Procrustes, encoding, ADC lookup tables.

Conventions, as in the JAX package: dsub = Dp / M; codebooks
``[M, 256, dsub]`` f32; codes ``[N, M]`` uint8; encoding works on rotated
residuals; L2 throughout. Every f32 product runs with TF32 off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.kernels import kmeans, ops

NBITS = 8
KSUB = 1 << NBITS  # 256 codewords per subspace


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """[N, D] -> [M, N, dsub]."""
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2).contiguous()


def train_codebooks(gen: torch.Generator, train: torch.Tensor, m: int,
                    n_iters: int = 8) -> torch.Tensor:
    """Train M subspace codebooks jointly (one batched Lloyd run).
    train: [T, D] rotated residuals. Returns [M, 256, dsub]."""
    subs = split_subspaces(train.to(torch.float32), m)
    return kmeans.kmeans_fit_batched(gen, subs, KSUB, n_iters=n_iters)[0]


def encode(x: torch.Tensor, codebooks: torch.Tensor, m: int,
           chunk: Optional[int] = None) -> torch.Tensor:
    """[N, D] rotated residuals -> [N, M] uint8 codes (argmin L2, first
    index on ties), ``chunk`` rows at a time (None: the rows whose [M,
    rows, 256] f32 score slab holds 2^28 values, 1 GiB)."""
    chunk = chunk or max(1, (1 << 28) // (m * KSUB))
    out = [kmeans.assign_batched(split_subspaces(x[s:s + chunk], m), codebooks).T
           for s in range(0, x.shape[0], chunk)]
    return torch.cat(out, dim=0).to(torch.uint8)


def decode(codes: torch.Tensor, codebooks: torch.Tensor, m: int) -> torch.Tensor:
    """[N, M] codes -> [N, D] reconstruction."""
    c = codes.long()
    recon = codebooks[torch.arange(m, device=c.device)[None, :], c]   # [N, M, dsub]
    return recon.reshape(codes.shape[0], -1)


def train_opq(
    gen: torch.Generator,
    train,                    # [T, D] rows, f32: numpy or a tensor on any device
    m: int,
    n_opq_iters: int = 5,     # OPQ_NITER analogue
    n_kmeans_iters: int = 6,
    *,
    device,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Alternating OPQ (Ge et al.): fix R, train PQ on X R; fix the
    codebooks, R = U V^T from the SVD of X^T X_hat (orthogonal Procrustes).
    Returns (R [D, D] on the host, codebooks [M, 256, dsub])."""
    x = (train.to(device, torch.float32) if torch.is_tensor(train)
         else torch.as_tensor(np.asarray(train, np.float32), device=device))
    d = x.shape[1]
    r = torch.eye(d, dtype=torch.float32, device=device)
    cb = None
    for _ in range(n_opq_iters):
        ops.no_tf32()
        xr = x @ r
        cb = train_codebooks(gen, xr, m, n_iters=n_kmeans_iters)
        xhat = decode(encode(xr, cb, m), cb, m)
        ops.no_tf32()
        u, _, vh = torch.linalg.svd(x.T @ xhat, full_matrices=False)
        r = u @ vh
    return r.cpu().numpy(), cb


def adc_lut(residuals: torch.Tensor, codebooks: torch.Tensor, m: int) -> torch.Tensor:
    """ADC lookup tables for L2: rotated residuals [B, D] -> [B, M, 256],
    lut[b, mi, j] = ||res_mi - cb[mi, j]||^2, full-f32 products."""
    subs = split_subspaces(residuals, m)                  # [M, B, dsub]
    ops.no_tf32()
    dots = torch.einsum("mbd,mjd->bmj", subs, codebooks)
    c2 = torch.sum(codebooks * codebooks, dim=2)          # [M, 256]
    r2 = torch.sum(subs * subs, dim=2)                    # [M, B]
    return r2.T[:, :, None] - 2.0 * dots + c2[None, :, :]


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [..., M, 256], codes [..., L, M] uint8 -> negated-L2 scores
    [..., L] (larger is better)."""
    idx = codes.long().transpose(-1, -2)                  # [..., M, L]
    return -torch.sum(torch.gather(lut, -1, idx), dim=-2)
