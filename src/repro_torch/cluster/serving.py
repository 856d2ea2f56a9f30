"""Out-of-sample extension for ``transform``/``predict`` — port of
``repro/cluster/serving.py`` (``route_transform`` :87, ``extension_from_
product`` :132, ``shifted_mu`` :143, single-device ``fused_transform``
:190-193).

The Nystrom extension embeds m new points as

    z(x) = D_new^{-1/2} K(x, X_train) D_train^{-1/2} Z / mu

The fused route runs the ``fused_nystrom_matmat`` CUDA kernel: one sweep
over the training points gives both ``K . (D_train^{-1/2} Z)`` and the
query degrees ``K . 1``, and the (m, n) kernel matrix never exists.  The
dense route (small problems) materializes it with plain torch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kmeans as km, laplacian as lp
from repro_torch.kernels import ops

TRANSFORM_PATHS = ("auto", "dense", "fused")

# ceiling on the materialized (m, n) query-vs-train kernel when the
# estimator carries no memory_budget: 64 MiB ~= the m = n = 4096 f32 kernel
DENSE_TRANSFORM_MAX_BYTES = 64 * 1024 * 1024


def check_transform_path(path: str) -> str:
    if path not in TRANSFORM_PATHS:
        raise ValueError(f"transform_path must be one of {TRANSFORM_PATHS}, "
                         f"got {path!r}")
    return path


def route_transform(n: int, m: int, *, path: str = "auto",
                    memory_budget: Optional[int] = None,
                    itemsize: int = 4) -> str:
    """Pick the transform path for m queries against n training points: a
    forced ``path`` wins; under ``"auto"`` the (m, n) kernel's bytes
    against the budget (``memory_budget``, else 64 MiB) decide."""
    check_transform_path(path)
    if path != "auto":
        return path
    budget = memory_budget if memory_budget is not None \
        else DENSE_TRANSFORM_MAX_BYTES
    return "dense" if m * n * itemsize <= budget else "fused"


def extension_from_product(O: torch.Tensor, deg: torch.Tensor,
                           mu: torch.Tensor) -> torch.Tensor:
    """Finish the extension: query-side D^{-1/2} (zero-degree queries pin
    to the all-zero row), divide by the eigenvalues of N, unit rows."""
    inv_new = lp.masked_inv_sqrt(deg)
    return km.normalize_rows((inv_new[:, None] * O) / mu[None, :])


def shifted_mu(eigenvalues: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of N = D^{-1/2} S D^{-1/2} from the L_sym eigenvalues,
    clamped away from zero."""
    mu = 1.0 - eigenvalues
    return torch.where(torch.abs(mu) > 1e-6, mu, torch.full_like(mu, 1e-6))


def fused_transform(x: torch.Tensor, train_x: torch.Tensor,
                    eigvecs: torch.Tensor, inv_sqrt: torch.Tensor, sigma,
                    mu: torch.Tensor) -> torch.Tensor:
    """Matrix-free Nystrom embedding of ``x`` (m, d) -> (m, k): one call
    of the dual-output kernel."""
    O, deg = ops.fused_nystrom_matmat(x, train_x, eigvecs, sigma, inv_sqrt)
    return extension_from_product(O, deg, mu)
