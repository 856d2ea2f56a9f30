"""Eigensolver backends — port of ``repro/cluster/eigensolvers.py:42-89``.

Signature: ``backend(est, op, generator) -> (eigenvalues, Z, info)`` with
the k smallest eigenvalues of L_sym (ascending), the matching (n, k)
unit eigenvector columns, and ``info["matrix_passes"]``.

Ported backends:
  lanczos        single-vector Lanczos through ``op.matvec``; one matrix
                 pass per step.
  block-lanczos  the block-tridiagonal recurrence through ``op.matmat``:
                 the same Krylov dimension in ~1/b the matrix passes.
  eigh           exact dense eigendecomposition of the materialized
                 operator (``torch.linalg.eigh``) — the oracle, O(n^3),
                 for tests and small n.
"""
from __future__ import annotations

import torch

from repro_torch.cluster.registry import Registry
from repro_torch.core import lanczos as lz

EIGENSOLVERS = Registry("eigensolver")

_SHIFT = 2.0  # A = shift*I - L_sym; see core.laplacian


@EIGENSOLVERS.register("lanczos")
def lanczos_solver(est, op, generator):
    steps = est.num_lanczos_steps(op.n)
    state = lz.lanczos(op.matvec, op.n, steps, generator,
                       device=op.valid.device)
    evals, Z = lz.topk_of_shifted(state, est.k, shift=_SHIFT)
    return evals, Z, {"lanczos_steps": steps, "matrix_passes": steps}


@EIGENSOLVERS.register("block-lanczos")
def block_lanczos_solver(est, op, generator):
    b = est.num_block_size(op.n)
    steps = est.num_block_steps(op.n)
    state = lz.block_lanczos(op.matmat, op.n, steps, generator,
                             block_size=b, device=op.valid.device)
    evals, Z = lz.block_topk_of_shifted(state, est.k, shift=_SHIFT)
    return evals, Z, {"block_size": b, "block_steps": steps,
                      "matrix_passes": steps}


@EIGENSOLVERS.register("eigh")
def eigh_solver(est, op, generator):
    evals_A, evecs = torch.linalg.eigh(op.materialize())     # ascending
    k = est.k
    # largest of A <-> smallest of L_sym
    Z = torch.flip(evecs[:, -k:], dims=[1])
    vals = torch.flip(_SHIFT - evals_A[-k:], dims=[0])
    # the dense factorization sweeps the n-row matrix ~n times: the
    # iterative solvers' cost unit applied to eigh, as in JAX
    return vals, Z, {"solver": "eigh", "matrix_passes": int(op.n)}
