"""The common product of every affinity backend — port of
``repro/cluster/operator.py:23-141``.

Every backend reduces to the shifted normalized operator

    A V = valid * V + D^{-1/2} S D^{-1/2} V

whose largest eigenpairs are the smallest of L_sym = I - D^{-1/2} S D^{-1/2}.
Eigensolvers consume only this interface.  The port's backends keep rows
in point order with no padding, so ``unpermute`` only drops rows past
``n``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

# identity columns per matmat when A is assembled from its product
MATERIALIZE_BLOCK = 128


@dataclass
class SpectralResult:
    """Fit result bundle in original point order."""
    labels: torch.Tensor        # (n,)
    embedding: torch.Tensor     # (n, k) row-normalized eigenvector rows
    eigenvalues: torch.Tensor   # (k,) smallest of L_sym, ascending
    centers: torch.Tensor       # (k, k)
    sigma: torch.Tensor
    info: dict = field(default_factory=dict)


@dataclass
class NormalizedOperator:
    """Shifted normalized-similarity operator.

    matmat:   (n, b) -> (n, b), ``A V`` — the canonical product, one pass
              over the similarity per block.
    matvec:   (n,) -> (n,), derived width-1 view of ``matmat``.
    valid:    (n,) 1/0 row mask.
    inv_sqrt: (n,) D^{-1/2}, kept for the Nystrom extension.
    dense:    optional zero-arg callable materializing A (n, n) exactly
              (the dense-S backends) — what the ``eigh`` backend factors;
              without it :meth:`materialize` applies ``matmat`` to
              identity blocks.
    stats:    dict, or a zero-arg callable returning one (live counters).
    reset:    optional zero-arg callable restoring the counters to their
              post-build baseline (the estimator calls it before each
              eigensolve, so a reused operator reports per-fit numbers).
    """

    valid: torch.Tensor
    inv_sqrt: torch.Tensor
    n: int
    matmat: Callable[[torch.Tensor], torch.Tensor]
    matvec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    dense: Optional[Callable[[], torch.Tensor]] = None
    stats: Any = field(default_factory=dict)
    reset: Optional[Callable[[], None]] = None

    def __post_init__(self):
        if self.matvec is None:
            mm = self.matmat
            self.matvec = lambda v: mm(v[:, None])[:, 0]

    def stats_snapshot(self) -> dict:
        return dict(self.stats() if callable(self.stats) else self.stats)

    def reset_stats(self) -> None:
        if self.reset is not None:
            self.reset()

    def unpermute(self, values: torch.Tensor) -> torch.Tensor:
        """Per-row values -> original point order."""
        return values[: self.n]

    def materialize(self) -> torch.Tensor:
        """Dense A: exact if the backend provided ``dense``, else
        assembled from ``matmat`` applied to identity column blocks
        (``MATERIALIZE_BLOCK`` wide, as in JAX)."""
        if self.dense is not None:
            return self.dense()
        eye = torch.eye(self.n, dtype=self.valid.dtype,
                        device=self.valid.device)
        return torch.cat([self.matmat(eye[:, c0:c0 + MATERIALIZE_BLOCK])
                          for c0 in range(0, self.n, MATERIALIZE_BLOCK)],
                         dim=1)
