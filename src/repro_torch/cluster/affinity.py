"""Affinity backends — port of ``repro/cluster/affinity.py``.

Signature: ``backend(est, x, sigma) -> NormalizedOperator``, where ``x``
is (n, d) points — or, for ``precomputed``, the (n, n) similarity itself
— and ``sigma`` the RBF bandwidth (ignored by ``precomputed``).

Ported backends:
  dense       the full (n, n) RBF similarity from the ``rbf_similarity``
              CUDA kernel; every pass over it runs on ``block_matmat``.
  precomputed the caller's symmetric non-negative (n, n) similarity or
              adjacency (the paper's §5 topology graphs).
  knn-topt    the dense similarity, then top-t per row and max(S, S^T)
              (paper step 1 "and then sparse it"), in place.
  fused-rbf   matrix-free: the ``fused_rbf_matmat`` CUDA kernel recomputes
              the RBF tiles on chip on every pass and applies the D^{-1/2}
              scales inside the kernel, so the (n, n) similarity never
              exists; affinity memory is O(n*d).

The dense family holds ``4 n^2`` bytes (16 GiB at n = 65536).  The JAX
package's triangular, compact and ooc-topt affinities are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.cluster.operator import NormalizedOperator
from repro_torch.cluster.registry import Registry
from repro_torch.core import laplacian as lp, similarity as sim
from repro_torch.kernels import ops

AFFINITIES = Registry("affinity")

_F32_NAMES = (None, "f32", "float32", torch.float32)
_BF16_NAMES = ("bf16", "bfloat16", torch.bfloat16)


def check_compute_dtype(spec) -> None:
    """Accept the f32 spellings of the ``compute_dtype`` knob; the bf16
    path is not ported yet and raises, as does anything unknown."""
    key = spec.lower() if isinstance(spec, str) else spec
    if key in _F32_NAMES:
        return
    if key in _BF16_NAMES:
        raise ValueError(
            f"compute_dtype={spec!r}: the bf16 kernel path is not ported "
            f"yet (ROADMAP.md, queue 1: 'the bf16 compute_dtype path and "
            f"the schedule layer'); use None or 'float32'")
    raise ValueError(f"unknown compute_dtype {spec!r}; expected None or "
                     f"'float32'")


def operator_from_dense(S: torch.Tensor, n: int) -> NormalizedOperator:
    """Shared tail of every dense-S backend: the shifted operator of
    :func:`laplacian.make_dense_operator` (no padding on one device), with
    ``dense`` materializing A from the build's ``inv_sqrt``."""
    valid = torch.ones((n,), dtype=torch.float32, device=S.device)
    matmat, inv_sqrt = lp.make_dense_operator(S, valid)
    return NormalizedOperator(
        valid=valid, inv_sqrt=inv_sqrt, n=n, matmat=matmat,
        dense=lambda: lp.dense_shifted_matrix(S, valid, inv_sqrt))


@AFFINITIES.register("dense")
def dense_affinity(est, x, sigma) -> NormalizedOperator:
    """Full RBF similarity (the JAX package's "full" mode)."""
    return operator_from_dense(sim.similarity_full(x, sigma),
                               int(x.shape[0]))


@AFFINITIES.register("precomputed")
def precomputed_affinity(est, S, sigma) -> NormalizedOperator:
    """Caller-supplied symmetric non-negative similarity/adjacency."""
    S = torch.as_tensor(S, dtype=torch.float32,
                        device=est.device).contiguous()
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError(
            f"precomputed affinity expects a square (n, n) similarity "
            f"matrix, got shape {tuple(S.shape)}")
    return operator_from_dense(S, int(S.shape[0]))


@AFFINITIES.register("knn-topt")
def knn_topt_affinity(est, x, sigma) -> NormalizedOperator:
    """Top-t sparsified RBF graph: the ``rbf_similarity`` kernel's S, then
    the per-row threshold and max(S, S^T), in place."""
    n = int(x.shape[0])
    t = est.sparsify_t or max(est.k + 2, 10)
    S = sim.sparsify_topt_(sim.similarity_full(x, sigma), min(t, n))
    return operator_from_dense(S, n)


def build_fused_rbf_operator(x: torch.Tensor, sigma, *,
                             compute_dtype=None) -> NormalizedOperator:
    """Matrix-free shifted normalized operator over raw points (the
    single-device branch of the JAX function).

    One degree pass (the kernel against a ones column) at build time, then
    one fused pass per ``matmat``: ``valid * V + D^{-1/2} S D^{-1/2} V``
    with both scales applied inside the kernel.  ``stats()`` reports
    ``matrix_passes``, the degree pass included."""
    check_compute_dtype(compute_dtype)
    x = x.to(torch.float32).contiguous()
    n = int(x.shape[0])
    sigma = float(sigma)
    valid = torch.ones((n,), dtype=torch.float32, device=x.device)

    deg = ops.fused_rbf_matmat(x, x, valid[:, None], sigma, valid,
                               valid)[:, 0]
    inv_sqrt = lp.masked_inv_sqrt(deg)
    counters = {"matrix_passes": 1}
    baseline = dict(counters)

    def matmat(V: torch.Tensor) -> torch.Tensor:
        counters["matrix_passes"] += 1
        return valid[:, None] * V + ops.fused_rbf_matmat(
            x, x, V, sigma, inv_sqrt, inv_sqrt)

    def reset() -> None:
        counters.update(baseline)

    return NormalizedOperator(valid=valid, inv_sqrt=inv_sqrt, n=n,
                              matmat=matmat, stats=lambda: dict(counters),
                              reset=reset)


@AFFINITIES.register("fused-rbf")
def fused_rbf_affinity(est, x, sigma) -> NormalizedOperator:
    return build_fused_rbf_operator(x, sigma,
                                    compute_dtype=est.compute_dtype)
