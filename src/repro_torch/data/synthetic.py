"""Synthetic clustering data — a copy of ``blobs`` from
``repro/data/synthetic.py`` (same seed, same points)."""
from __future__ import annotations

import numpy as np


def blobs(n: int, k: int, dim: int = 2, spread: float = 0.15,
          seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """k well-separated Gaussian blobs. Returns (points (n,dim) f32, labels)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim) * 4.0
    labels = np.arange(n) % k
    pts = centers[labels] + rng.randn(n, dim) * spread
    return pts.astype(np.float32), labels
