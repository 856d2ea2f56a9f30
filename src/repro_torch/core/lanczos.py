"""Block Lanczos with full reorthogonalization — port of
``repro/core/lanczos.py``.

The canonical recurrence is block Lanczos: one ``matmat`` of width b per
step (one pass over the operator), a block-tridiagonal T, and CGS2
reorthogonalization against the whole basis.  Single-vector Lanczos is its
b = 1 view.  The JAX package runs the steps in ``lax.fori_loop`` over an
immutable state; here a Python loop fills the preallocated state in place.

The QR and ``eigh`` of the small (s*b)-sized matrices use ``torch.linalg``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass
class BlockLanczosState:
    """Block-Lanczos iteration state, filled in place.

    After ``step`` completed block steps the first ``(step + 1) * b`` rows
    of ``V`` hold the orthonormal basis."""

    step: int
    V: torch.Tensor    # ((s+1)*b, n) basis rows; blocks > step are zero
    A: torch.Tensor    # (s, b, b) diagonal blocks of T (symmetric)
    B: torch.Tensor    # (s+1, b, b) subdiagonal blocks of T; B[0] == 0
    block_size: int


def _qr_pos(U: torch.Tensor, eps: float = 1e-8
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR with a non-negative R diagonal; (near-)dependent columns
    are zeroed instead of admitting junk directions into the basis."""
    Q, R = torch.linalg.qr(U)
    sgn = torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(U.dtype)
    Q = Q * sgn[None, :]
    R = R * sgn[:, None]
    keep = (torch.diagonal(R) > eps).to(U.dtype)
    return Q * keep[None, :], R * keep[:, None]


def init_block_state(n: int, num_steps: int, block_size: int, *,
                     generator: torch.Generator | None = None,
                     V0=None, device=None,
                     dtype=torch.float32) -> BlockLanczosState:
    """Random (from ``generator``) or caller-supplied (b, n) start block —
    ``V0`` may be a numpy array or a tensor — orthonormalized."""
    b = block_size
    if V0 is None:
        if generator is None:
            raise ValueError("init_block_state needs a generator or V0")
        V0 = torch.randn((b, n), generator=generator, dtype=dtype,
                         device=generator.device)
    V0 = torch.as_tensor(np.asarray(V0) if not torch.is_tensor(V0) else V0,
                         dtype=dtype, device=device)
    if V0.shape != (b, n):
        raise ValueError(f"start block {tuple(V0.shape)} must be ({b}, {n})")
    Q, _ = _qr_pos(V0.T)
    V = torch.zeros(((num_steps + 1) * b, n), dtype=dtype, device=V0.device)
    V[:b] = Q.T
    return BlockLanczosState(
        step=0, V=V,
        A=torch.zeros((num_steps, b, b), dtype=dtype, device=V0.device),
        B=torch.zeros((num_steps + 1, b, b), dtype=dtype, device=V0.device),
        block_size=b)


def _current_block(state: BlockLanczosState) -> torch.Tensor:
    b = state.block_size
    return state.V[state.step * b:(state.step + 1) * b]


def _block_step_update(state: BlockLanczosState, W: torch.Tensor) -> None:
    """Everything in a block step after the matrix pass: given
    ``W = A @ Vj.T`` for the current block, orthogonalize (CGS2) and
    append the next block, in place."""
    j, b = state.step, state.block_size
    V = state.V
    Vj = V[j * b:(j + 1) * b]                                   # (b, n)
    W = W.to(V.dtype)
    if j > 0:
        W = W - V[(j - 1) * b:j * b].T @ state.B[j].T
    Aj = Vj @ W                                                 # (b, b)
    Aj = 0.5 * (Aj + Aj.T)          # symmetric operator -> symmetric block
    W = W - Vj.T @ Aj
    basis = V[:(j + 1) * b]         # the filled blocks ("twice is enough")
    for _ in range(2):
        W = W - basis.T @ (basis @ W)
    Qn, R = _qr_pos(W)
    V[(j + 1) * b:(j + 2) * b] = Qn.T
    state.A[j] = Aj
    state.B[j + 1] = R
    state.step = j + 1


def block_run(matmat: Callable, state: BlockLanczosState,
              num_iters: int) -> BlockLanczosState:
    """Advance ``num_iters`` block steps, one matrix pass each."""
    for _ in range(num_iters):
        _block_step_update(state, matmat(_current_block(state).T))
    return state


def block_lanczos(matmat: Callable, n: int, num_steps: int,
                  generator: torch.Generator | None = None,
                  block_size: int = 8, V0=None, device=None,
                  dtype=torch.float32) -> BlockLanczosState:
    state = init_block_state(n, num_steps, block_size, generator=generator,
                             V0=V0, device=device, dtype=dtype)
    return block_run(matmat, state, num_steps)


def block_tridiagonal(state: BlockLanczosState) -> torch.Tensor:
    """Dense block-tridiagonal T (s*b, s*b) from (A, B)."""
    s, b, _ = state.A.shape
    T = torch.zeros((s * b, s * b), dtype=state.A.dtype,
                    device=state.A.device)
    for j in range(s):
        T[j * b:(j + 1) * b, j * b:(j + 1) * b] = state.A[j]
        if j + 1 < s:
            T[(j + 1) * b:(j + 2) * b, j * b:(j + 1) * b] = state.B[j + 1]
            T[j * b:(j + 1) * b, (j + 1) * b:(j + 2) * b] = state.B[j + 1].T
    return T


def block_ritz_pairs(state: BlockLanczosState
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ritz values (ascending) and vectors (n, s*b) of the operator."""
    evals, evecs = torch.linalg.eigh(block_tridiagonal(state))
    s, b, _ = state.A.shape
    return evals, state.V[: s * b].T @ evecs


def block_topk_of_shifted(state: BlockLanczosState, k: int,
                          shift: float = 2.0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest eigenpairs of L given the recurrence ran on
    A = shift*I - L: (eigenvalues ascending (k,), eigenvectors (n, k))."""
    evals_A, vecs = block_ritz_pairs(state)
    return _topk_from_ritz(evals_A, vecs, k, shift)


def _topk_from_ritz(evals_A: torch.Tensor, vecs: torch.Tensor, k: int,
                    shift: float) -> tuple[torch.Tensor, torch.Tensor]:
    # largest of A  <->  smallest of L
    topk = torch.flip(vecs[:, -k:], dims=[1])
    vals_L = torch.flip(shift - evals_A[-k:], dims=[0])
    norms = torch.linalg.norm(topk, dim=0, keepdim=True)
    return vals_L, topk / torch.clamp_min(norms, 1e-12)


# ---------------------------------------------------------------------------
# Single-vector Lanczos: the b = 1 view
# ---------------------------------------------------------------------------

def lanczos(matvec: Callable, n: int, num_steps: int,
            generator: torch.Generator | None = None, v0=None, device=None,
            dtype=torch.float32) -> BlockLanczosState:
    """Single-vector Lanczos through ``matvec`` ((n,) -> (n,)), one matrix
    pass per step; ``v0`` (n,) overrides the random start vector."""
    V0 = None if v0 is None else \
        torch.as_tensor(np.asarray(v0) if not torch.is_tensor(v0) else v0,
                        dtype=dtype).reshape(1, n)
    return block_lanczos(lambda V: matvec(V[:, 0])[:, None], n, num_steps,
                         generator, block_size=1, V0=V0, device=device,
                         dtype=dtype)


topk_of_shifted = block_topk_of_shifted
