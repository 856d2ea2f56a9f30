"""Public wrappers for the port's kernels.

Port of ``repro/kernels/ops.py:62-156``: defaults for omitted scales and
masks, and dtype normalisation.  The JAX wrappers also pad every operand
to tile multiples; the CUDA kernels mask the ragged edge themselves, so
nothing here pads.  Rows a caller marks invalid get scale 0 (and
``col_valid`` 0) and contribute to nothing, as the JAX wrappers promise
for their padding rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (fused_rbf_matmat as _frm,
                                 kmeans_assign as _ka)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=like.device)


def fused_rbf_matmat(x: torch.Tensor, y: torch.Tensor, V: torch.Tensor,
                     sigma, row_scale: torch.Tensor | None = None,
                     col_scale: torch.Tensor | None = None) -> torch.Tensor:
    """diag(row_scale) . RBF(x, y; sigma) . diag(col_scale) . V for any
    (n, d) / (m, d) / (m, b); omitted scales default to ones."""
    rs = _ones(x.shape[0], x) if row_scale is None else _f32(row_scale)
    cs = _ones(y.shape[0], y) if col_scale is None else _f32(col_scale)
    return _frm.fused_rbf_matmat(_f32(x), _f32(y), _f32(V), sigma, rs, cs)


def fused_nystrom_matmat(x: torch.Tensor, y: torch.Tensor, V: torch.Tensor,
                         sigma, col_scale: torch.Tensor,
                         col_valid: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(K . (col_scale * V), K . col_valid) for K = RBF(x, y; sigma), any
    (m, d) / (n, d) / (n, b); ``col_valid`` defaults to ones.  Returns
    ((m, b), (m,))."""
    cv = _ones(y.shape[0], y) if col_valid is None else _f32(col_valid)
    return _frm.fused_nystrom_matmat(_f32(x), _f32(y), _f32(V), sigma,
                                     _f32(col_scale), cv)


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, squared distances) of each point's nearest center."""
    return _ka.kmeans_assign(_f32(points), _f32(centers))
