"""Eigensolver backends — port of ``repro/cluster/eigensolvers.py:42-60``.

Signature: ``backend(est, op, generator) -> (eigenvalues, Z, info)`` with
the k smallest eigenvalues of L_sym (ascending), the matching (n, k)
unit eigenvector columns, and ``info["matrix_passes"]``.

Ported backends:
  lanczos        single-vector Lanczos through ``op.matvec``; one matrix
                 pass per step.
  block-lanczos  the block-tridiagonal recurrence through ``op.matmat``:
                 the same Krylov dimension in ~1/b the matrix passes.
"""
from __future__ import annotations

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
