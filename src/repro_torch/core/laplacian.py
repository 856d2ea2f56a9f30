"""Normalized-Laplacian scaling — port of ``repro/core/laplacian.py``.

L_sym = I - D^{-1/2} S D^{-1/2}; the eigensolvers run on the shifted
operator A = 2I - L_sym = I + D^{-1/2} S D^{-1/2}, whose largest
eigenpairs are L_sym's smallest.

Every product with a materialized S runs on the ``block_matmat`` CUDA
kernel (the JAX package leaves ``S @ .`` to XLA, :40, :45).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def masked_inv_sqrt(deg: torch.Tensor) -> torch.Tensor:
    """D^{-1/2} with zero-degree rows pinned to 0, so they stay in the null
    space of the normalized-similarity term."""
    return torch.where(deg > 0, 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12)),
                       torch.zeros_like(deg))


def make_dense_operator(S: torch.Tensor, valid: torch.Tensor):
    """Shifted normalized operator from a dense similarity matrix:
    ``A V = valid * V + D^{-1/2} S D^{-1/2} V``, one pass of S per block.
    Returns ``(matmat, inv_sqrt)``; the degree pass ``S @ valid`` runs
    once here."""
    inv_sqrt = masked_inv_sqrt(ops.block_matvec(S, valid))

    def matmat(V: torch.Tensor) -> torch.Tensor:
        return valid[:, None] * V + inv_sqrt[:, None] * ops.block_matmat(
            S, inv_sqrt[:, None] * V)

    return matmat, inv_sqrt


def dense_shifted_matrix(S: torch.Tensor, valid: torch.Tensor,
                         inv_sqrt: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Materialized A = diag(valid) + D^{-1/2} S D^{-1/2}: what ``eigh``
    factors, and the oracle the matrix-free operator is held against.
    Pass the operator build's ``inv_sqrt`` to save a pass over S."""
    if inv_sqrt is None:
        inv_sqrt = masked_inv_sqrt(ops.block_matvec(S, valid))
    return torch.diag(valid) + S * (inv_sqrt[:, None] * inv_sqrt[None, :])
