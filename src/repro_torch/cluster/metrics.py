"""Clustering agreement — a copy of the ``ari`` part of
``repro/cluster/metrics.py`` (the paper's §5 experiment measure).

The adjusted Rand index compares a predicted labeling against a
reference labeling through their contingency table, chance-corrected
(1 = identical partitions, ~0 = random, can go negative); it does not
assume the label ids line up (clustering is only defined up to
permutation).

Pure numpy on (n,) integer label vectors; label values need not be
contiguous or aligned between the two vectors.
"""
from __future__ import annotations

import numpy as np


def contingency(labels_a: np.ndarray, labels_b: np.ndarray) -> np.ndarray:
    """Contingency table C[i, j] = #points with a-label i and b-label j."""
    a = np.asarray(labels_a).ravel()
    b = np.asarray(labels_b).ravel()
    if a.shape != b.shape:
        raise ValueError(
            f"label vectors differ in length: {a.shape} vs {b.shape}")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    na, nb = ai.max() + 1, bi.max() + 1
    return np.bincount(ai * nb + bi, minlength=na * nb).reshape(na, nb)


def ari(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """Adjusted Rand index (Hubert & Arabie 1985)."""
    C = contingency(labels_true, labels_pred).astype(np.float64)
    n = C.sum()
    sum_comb = (C * (C - 1) / 2).sum()
    a = C.sum(axis=1)
    b = C.sum(axis=0)
    comb_a = (a * (a - 1) / 2).sum()
    comb_b = (b * (b - 1) / 2).sum()
    total = n * (n - 1) / 2
    expected = comb_a * comb_b / total if total else 0.0
    max_index = (comb_a + comb_b) / 2
    if max_index == expected:          # both partitions trivial -> perfect
        return 1.0
    return float((sum_comb - expected) / (max_index - expected))
