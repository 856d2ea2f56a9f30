"""Dense similarity pieces — port of ``repro/core/similarity.py:43-66``."""
from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """||x_i - y_j||^2 via |x|^2 + |y|^2 - 2 x.y, clamped at 0."""
    xx = (x * x).sum(-1)[:, None]
    yy = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, sigma) -> torch.Tensor:
    """S_ij = exp(-||x_i - y_j||^2 / (2 sigma^2))."""
    return torch.exp(-pairwise_sq_dists(x, y) / (2.0 * sigma ** 2))


def median_sigma(x: torch.Tensor, sample: int = 1024) -> torch.Tensor:
    """Median-distance heuristic for the RBF bandwidth over the first
    ``sample`` points.  Like ``jnp.median``, an even count of pairs takes
    the mean of the two middle values (``torch.median`` would return the
    lower one)."""
    xs = x[: min(sample, x.shape[0])]
    d2 = pairwise_sq_dists(xs, xs)
    i, j = torch.triu_indices(d2.shape[0], d2.shape[0], offset=1,
                              device=x.device)
    off = torch.sort(d2[i, j]).values
    c = off.numel()
    med = off[c // 2] if c % 2 else 0.5 * (off[c // 2 - 1] + off[c // 2])
    return torch.sqrt(med + 1e-12)
