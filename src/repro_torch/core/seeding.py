"""k-means++ seeding (D^2 sampling) — port of
``repro/core/seeding.py:30`` (``kmeans_plusplus_init``).

The first center is drawn weight-proportionally, then k-1 centers
proportionally to the weighted squared distance to the nearest chosen
center; ``weights`` masks rows out of the draw.  ``torch.multinomial``
with an explicit ``torch.Generator`` takes the place of
``jax.random.choice``.
"""
from __future__ import annotations

import torch


def kmeans_plusplus_init(y: torch.Tensor, k: int,
                         generator: torch.Generator,
                         weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    n = y.shape[0]
    w = torch.ones((n,), dtype=y.dtype, device=y.device) \
        if weights is None else weights.to(y.dtype)
    first = torch.multinomial(w / w.sum(), 1, generator=generator)[0]
    centers = torch.zeros((k, y.shape[1]), dtype=y.dtype, device=y.device)
    centers[0] = y[first]
    d2 = ((y - y[first]) ** 2).sum(1) * w
    for i in range(1, k):
        total = d2.sum()
        # every point already sits on a center: draw by weight instead of
        # handing multinomial an all-zero distribution
        p = torch.where(total > 0, d2 / torch.clamp_min(total, 1e-12),
                        w / w.sum())
        idx = torch.multinomial(p, 1, generator=generator)[0]
        centers[i] = y[idx]
        d2 = torch.minimum(d2, ((y - y[idx]) ** 2).sum(1) * w)
    return centers
