"""Lloyd k-means on the spectral embedding — port of
``repro/core/kmeans.py`` (``normalize_rows`` :42, ``assign`` :48,
``_update`` :53, and the single-device body of ``distributed_kmeans``
:151-175).

Lloyd's map step — the nearest center of every point — runs on the
``kmeans_assign`` CUDA kernel; the JAX estimator computes the same
function (``|p|^2 + |c|^2 - 2 p.c``, argmin) in plain jnp.  The reduce
step (per-cluster sums and counts) is a one-hot product, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.seeding import kmeans_plusplus_init
from repro_torch.kernels import ops


@dataclass
class KMeansState:
    it: int                # rounds run
    centers: torch.Tensor  # (k, dim)
    shift: torch.Tensor    # scalar: last center movement


def normalize_rows(Z: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Alg. 4.1 step 5: Y = Z with unit-norm rows."""
    return Z / torch.clamp_min(torch.linalg.norm(Z, dim=1, keepdim=True), eps)


def assign(y: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center index per point (the paper's map function)."""
    return ops.kmeans_assign(y, centers)[0]


def _update(y, valid, centers):
    """One Lloyd step's (sums, counts, inertia) over the valid rows."""
    k = centers.shape[0]
    idx, dmin = ops.kmeans_assign(y, centers)
    onehot = torch.nn.functional.one_hot(idx, k).to(y.dtype) * valid[:, None]
    return onehot.T @ y, onehot.sum(0), (dmin * valid).sum()


def lloyd_step(y: torch.Tensor, valid: torch.Tensor,
               state: KMeansState) -> KMeansState:
    sums, counts, _ = _update(y, valid, state.centers)
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts[:, None], 1),
                      state.centers)
    return KMeansState(it=state.it + 1, centers=new,
                       shift=torch.linalg.norm(new - state.centers))


def distributed_kmeans(y: torch.Tensor, valid: torch.Tensor, k: int,
                       generator: torch.Generator, iters: int = 50,
                       centers0=None, tol: float = 1e-6
                       ) -> tuple[torch.Tensor, KMeansState]:
    """Paper §4.3.3 on one device: up to ``iters`` Lloyd rounds from a
    k-means++ start (or ``centers0``), stopping once a round moves the
    centers by less than ``tol`` — the JAX loop's ``shift < tol`` freeze,
    which keeps the centers fixed for every later round."""
    if centers0 is None:
        centers0 = kmeans_plusplus_init(y, k, generator, weights=valid)
    centers0 = torch.as_tensor(centers0, dtype=y.dtype, device=y.device)
    state = KMeansState(it=0, centers=centers0,
                        shift=torch.tensor(float("inf"), device=y.device))
    for _ in range(iters):
        if bool(state.shift < tol):
            break
        state = lloyd_step(y, valid, state)
    return assign(y, state.centers), state
