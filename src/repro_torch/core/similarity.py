"""Dense similarity pieces — port of ``repro/core/similarity.py:43-76``
and the single-device case of ``distributed_similarity_full`` (:432)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

# rows (and tile edge) the top-t pass works on at once: bounds the
# temporaries (the row mask, the transposed tile) at n = 65536
SPARSIFY_CHUNK = 4096


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """||x_i - y_j||^2 via |x|^2 + |y|^2 - 2 x.y, clamped at 0."""
    xx = (x * x).sum(-1)[:, None]
    yy = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, sigma) -> torch.Tensor:
    """S_ij = exp(-||x_i - y_j||^2 / (2 sigma^2))."""
    return torch.exp(-pairwise_sq_dists(x, y) / (2.0 * sigma ** 2))


def median_sigma(x: torch.Tensor, sample: int = 1024) -> torch.Tensor:
    """Median-distance heuristic for the RBF bandwidth over the first
    ``sample`` points.  Like ``jnp.median``, an even count of pairs takes
    the mean of the two middle values (``torch.median`` would return the
    lower one)."""
    xs = x[: min(sample, x.shape[0])]
    d2 = pairwise_sq_dists(xs, xs)
    i, j = torch.triu_indices(d2.shape[0], d2.shape[0], offset=1,
                              device=x.device)
    off = torch.sort(d2[i, j]).values
    c = off.numel()
    med = off[c // 2] if c % 2 else 0.5 * (off[c // 2 - 1] + off[c // 2])
    return torch.sqrt(med + 1e-12)


def similarity_full(x: torch.Tensor, sigma) -> torch.Tensor:
    """(n, n) RBF similarity of the points through the ``rbf_similarity``
    kernel (the JAX package's "full" mode on one device: no padding)."""
    return ops.rbf_similarity(x, x, sigma)


def sparsify_topt_(S: torch.Tensor, t: int) -> torch.Tensor:
    """Keep the top-``t`` entries per row (paper step 1 "and then sparse
    it"), then symmetrize with max(S, S^T) so the graph stays undirected
    — in place: ``S`` is overwritten and returned.

    The affinity that built ``S`` owns it, so at n = 65536 this saves the
    two further (n, n) matrices that an out-of-place form would hold.
    The threshold is the t-th largest value of each row (``torch.topk``,
    the same value as JAX's full sort); ``>=`` keeps its ties, as JAX
    does.  The symmetrization runs over pairs of mirrored tiles."""
    n = S.shape[0]
    t = min(int(t), n)
    for r0 in range(0, n, SPARSIFY_CHUNK):
        rows = S[r0:r0 + SPARSIFY_CHUNK]
        thresh = torch.topk(rows, t, dim=1).values[:, -1:]
        rows.masked_fill_(~(rows >= thresh), 0.0)
    for i0 in range(0, n, SPARSIFY_CHUNK):
        i1 = i0 + SPARSIFY_CHUNK
        for j0 in range(i0, n, SPARSIFY_CHUNK):
            j1 = j0 + SPARSIFY_CHUNK
            sym = torch.maximum(S[i0:i1, j0:j1], S[j0:j1, i0:i1].T)
            S[i0:i1, j0:j1] = sym
            S[j0:j1, i0:i1] = sym.T
    return S
