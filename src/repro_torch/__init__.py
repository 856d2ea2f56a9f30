"""PyTorch/CUDA port of :mod:`repro` — parallel spectral clustering on one
NVIDIA H100.

The layout mirrors ``repro/``: ``kernels/`` (hand-written CUDA kernels for
``sm_90a``, each beside its plain PyTorch version), ``core/`` (similarity,
Laplacian, Lanczos, k-means), ``cluster/`` (the estimator and its backend
registries) and ``data/``.  The package imports torch, numpy and the
standard library only — never ``jax`` and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no ``device="cpu"`` they raise (see :mod:`.device`).
"""
from repro_torch.cluster import SpectralClustering, ari

__all__ = ["SpectralClustering", "ari"]
