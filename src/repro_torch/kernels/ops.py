"""Public wrappers for the port's kernels.

Port of ``repro/kernels/ops.py:48-190``: defaults for omitted scales and
masks, dtype normalisation, and blocks wider than a kernel takes (split
into column groups, one launch each).  The JAX wrappers also pad every
operand to tile multiples; the CUDA kernels mask the ragged edge
themselves, so nothing here pads.  Rows a caller marks invalid get scale 0 (and
``col_valid`` 0) and contribute to nothing, as the JAX wrappers promise
for their padding rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (block_matvec as _mv,
                                 flash_attention as _fa,
                                 fused_rbf_matmat as _frm,
                                 kmeans_assign as _ka,
                                 rbf_similarity as _rbf)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=like.device)


def _by_width(fn, V: torch.Tensor, max_width: int) -> torch.Tensor:
    """``fn(V)`` for a block of any width: column groups of at most
    ``max_width``, one call each, side by side."""
    if V.shape[1] <= max_width:
        return fn(V)
    return torch.cat([fn(V[:, c:c + max_width])
                      for c in range(0, V.shape[1], max_width)], dim=1)


def rbf_similarity(x: torch.Tensor, y: torch.Tensor, sigma) -> torch.Tensor:
    """exp(-||x_i - y_j||^2 / 2 sigma^2) for all pairs; any (n, m)."""
    return _rbf.rbf_similarity(_f32(x), _f32(y), sigma)


def block_matmat(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """A @ V for any (n, m) A and (m, b) V (one pass over A per 64
    columns of V)."""
    A = _f32(A)
    return _by_width(lambda W: _mv.block_matmat(A, W), _f32(V),
                     _mv.MAX_WIDTH)


def block_matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v for any (n, m) A: the width-1 view of :func:`block_matmat`."""
    return _mv.block_matvec(_f32(A), _f32(v))


def fused_rbf_matmat(x: torch.Tensor, y: torch.Tensor, V: torch.Tensor,
                     sigma, row_scale: torch.Tensor | None = None,
                     col_scale: torch.Tensor | None = None) -> torch.Tensor:
    """diag(row_scale) . RBF(x, y; sigma) . diag(col_scale) . V for any
    (n, d) / (m, d) / (m, b); omitted scales default to ones."""
    rs = _ones(x.shape[0], x) if row_scale is None else _f32(row_scale)
    cs = _ones(y.shape[0], y) if col_scale is None else _f32(col_scale)
    x, y = _f32(x), _f32(y)
    return _by_width(
        lambda W: _frm.fused_rbf_matmat(x, y, W, sigma, rs, cs), _f32(V),
        _frm.MAX_WIDTH)


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


# the JAX wrapper's default query and key tiles (``bq = bk = 256``)
REFERENCE_TILE = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1) -> torch.Tensor:
    """Fused attention; q (B, H, S, hd), k/v (B, KV, T, hd) with query
    head h reading kv head h // (H/KV), as ``jnp.repeat`` gives, without a
    broadcast copy.  The JAX wrapper pads S and T to its tiles and refuses
    the paddings its kernel cannot mask; that refusal is kept here (a
    ``ValueError``), though the CUDA kernel masks every ragged tile
    itself and nothing is padded."""
    S, T = q.shape[2], k.shape[2]
    tile_q, tile_k = min(REFERENCE_TILE, S), min(REFERENCE_TILE, T)
    s_pad, t_pad = -(-S // tile_q) * tile_q, -(-T // tile_k) * tile_k
    if t_pad != T and not (causal and s_pad == t_pad):
        raise ValueError(f"flash_attention: non-causal padding unsupported "
                         f"(S={S}, T={T}, causal={causal})")
    return _fa.flash_attention(q, k, v, causal=causal, window=window)
