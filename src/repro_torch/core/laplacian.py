"""Normalized-Laplacian scaling — port of ``repro/core/laplacian.py``.

L_sym = I - D^{-1/2} S D^{-1/2}; the eigensolvers run on the shifted
operator A = 2I - L_sym = I + D^{-1/2} S D^{-1/2}, whose largest
eigenpairs are L_sym's smallest.
"""
from __future__ import annotations

import torch


def masked_inv_sqrt(deg: torch.Tensor) -> torch.Tensor:
    """D^{-1/2} with zero-degree rows pinned to 0, so they stay in the null
    space of the normalized-similarity term."""
    return torch.where(deg > 0, 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12)),
                       torch.zeros_like(deg))


def dense_shifted_matrix(S: torch.Tensor, valid: torch.Tensor,
                         inv_sqrt: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Materialized A = diag(valid) + D^{-1/2} S D^{-1/2} — the oracle the
    matrix-free operator is held against."""
    if inv_sqrt is None:
        inv_sqrt = masked_inv_sqrt(S @ valid)
    return torch.diag(valid) + S * (inv_sqrt[:, None] * inv_sqrt[None, :])
