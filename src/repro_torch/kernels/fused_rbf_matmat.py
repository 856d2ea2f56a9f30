"""Fused RBF products: the matrix-free affinity pass and the Nystrom pass.

Port of ``repro/kernels/fused_rbf_matmat.py``.  The CUDA kernels live in
``csrc/fused_rbf.cu`` and replace the Pallas TPU kernels
``fused_rbf_matmat`` (``repro/kernels/fused_rbf_matmat.py:286``) and
``fused_nystrom_matmat`` (``:222``):

    fused_rbf_matmat      O = diag(rs) . K . diag(cs) . V
    fused_nystrom_matmat  (K . (cs * V), K . cv)

with ``K_ij = exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / (2 sigma^2))``
built tile by tile on chip and never written out.

Bounds on an H100 SXM (data sheet, 700 W) at the slice's shapes, both
compute-bound on the 67 TFLOP/s f32 non-tensor peak: one affinity pass
at n = m = 131072, d = 32 does 2nmd + 2nmb + ~5nm operations (22 ms at
b = 8, 18 ms at b = 1); one Nystrom pass of m = 16384 queries against
n = 131072 training points ~2.8 ms.  How the kernel is laid out, and what
it does about that bound, is in the source's header.

Each wrapper below launches its kernel for CUDA tensors (or raises), and
runs the plain PyTorch version of the same function only for CPU
tensors.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# widest V block one pass takes (the Nystrom pass adds the degree column)
MAX_WIDTH = 64
# rows of the materialized K the plain versions hold at once
PLAIN_CHUNK = 4096


def inv_two_sigma_sq(sigma) -> float:
    """1 / (2 sigma^2), rounded in f32 as the JAX kernels compute it."""
    s = np.float32(float(sigma))
    return float(np.float32(1.0) / (np.float32(2.0) * s * s))


def rbf_block(x: torch.Tensor, y: torch.Tensor, inv2s2: float,
              yy: torch.Tensor | None = None) -> torch.Tensor:
    """exp(-max(|x|^2 + |y|^2 - 2 x.y, 0) * inv2s2), materialized: the
    kernels' tile arithmetic, in plain PyTorch."""
    xx = (x * x).sum(-1)[:, None]
    yy = (y * y).sum(-1)[None, :] if yy is None else yy[None, :]
    d2 = torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)
    return torch.exp(-d2 * inv2s2)


def fused_rbf_matmat_plain(x, y, V, sigma, row_scale, col_scale):
    """Plain PyTorch version of :func:`fused_rbf_matmat` (K materialized
    PLAIN_CHUNK rows at a time)."""
    inv2s2 = inv_two_sigma_sq(sigma)
    W = col_scale[:, None] * V
    yy = (y * y).sum(-1)
    out = torch.empty((x.shape[0], V.shape[1]), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, x.shape[0], PLAIN_CHUNK):
        r1 = r0 + PLAIN_CHUNK
        out[r0:r1] = row_scale[r0:r1, None] * (
            rbf_block(x[r0:r1], y, inv2s2, yy) @ W)
    return out


def fused_nystrom_matmat_plain(x, y, V, sigma, col_scale, col_valid):
    """Plain PyTorch version of :func:`fused_nystrom_matmat`."""
    inv2s2 = inv_two_sigma_sq(sigma)
    W = torch.cat([col_scale[:, None] * V, col_valid[:, None]], dim=1)
    yy = (y * y).sum(-1)
    out = torch.empty((x.shape[0], V.shape[1] + 1), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, x.shape[0], PLAIN_CHUNK):
        out[r0:r0 + PLAIN_CHUNK] = rbf_block(
            x[r0:r0 + PLAIN_CHUNK], y, inv2s2, yy) @ W
    return out[:, :-1], out[:, -1]


def _check(name, x, y, V, vectors, max_width):
    """Shapes, dtype and device of one call; returns (rows, cols, d, b)."""
    if x.ndim != 2 or y.ndim != 2 or V.ndim != 2:
        raise ValueError(f"{name}: x, y, V must be 2-D, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(V.shape)}")
    rows, d = x.shape
    cols, b = V.shape
    if y.shape != (cols, d):
        raise ValueError(f"{name}: y {tuple(y.shape)} must be ({cols}, {d})")
    for vname, v, size in vectors:
        if v.shape != (size,):
            raise ValueError(f"{name}: {vname} {tuple(v.shape)} must be "
                             f"({size},)")
    tensors = [x, y, V] + [v for _, v, _ in vectors]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32 tensors, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and "
                             f"{t.device}")
    if x.device.type == "cuda" and not 1 <= b <= max_width:
        raise ValueError(f"{name}: block width {b} outside 1..{max_width}")
    return rows, cols, d, b


def fused_rbf_matmat(x: torch.Tensor, y: torch.Tensor, V: torch.Tensor,
                     sigma, row_scale: torch.Tensor,
                     col_scale: torch.Tensor) -> torch.Tensor:
    """diag(row_scale) . RBF(x, y; sigma) . diag(col_scale) . V, fused.

    ``x`` (n, d), ``y`` (m, d), ``V`` (m, b) with 1 <= b <= 64, scales
    (n,) / (m,); all float32 on one device.  Returns (n, b) float32."""
    n, m, d, b = _check("fused_rbf_matmat", x, y, V,
                        [("row_scale", row_scale, x.shape[0]),
                         ("col_scale", col_scale, y.shape[0])], MAX_WIDTH)
    if x.device.type == "cpu":
        return fused_rbf_matmat_plain(x, y, V, sigma, row_scale, col_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rbf_matmat: unsupported device {x.device}")
    x, y, V = x.contiguous(), y.contiguous(), V.contiguous()
    rs, cs = row_scale.contiguous(), col_scale.contiguous()
    out = torch.empty((n, b), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.library("fused_rbf")
    code = lib.fused_rbf_matmat(
        x.data_ptr(), y.data_ptr(), V.data_ptr(), rs.data_ptr(),
        cs.data_ptr(), out.data_ptr(), n, m, d, b, inv_two_sigma_sq(sigma),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "fused_rbf_matmat")
    fused_rbf_matmat.launches += 1
    return out


fused_rbf_matmat.launches = 0


def fused_nystrom_matmat(x: torch.Tensor, y: torch.Tensor, V: torch.Tensor,
                         sigma, col_scale: torch.Tensor,
                         col_valid: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(K . (col_scale * V), K . col_valid) for K = RBF(x, y; sigma), from
    one sweep over the training tiles.

    ``x`` (m, d) queries, ``y`` (n, d) training points, ``V`` (n, b) with
    1 <= b <= 63, ``col_scale``/``col_valid`` (n,).  The product is masked
    through ``col_scale`` and the degree through ``col_valid``, so an
    isolated training point (scale 0, valid 1) still counts toward the
    query degree.  Returns ((m, b), (m,)) float32."""
    m, n, d, b = _check("fused_nystrom_matmat", x, y, V,
                        [("col_scale", col_scale, y.shape[0]),
                         ("col_valid", col_valid, y.shape[0])],
                        MAX_WIDTH - 1)
    if x.device.type == "cpu":
        return fused_nystrom_matmat_plain(x, y, V, sigma, col_scale,
                                          col_valid)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_nystrom_matmat: unsupported device {x.device}")
    x, y, V = x.contiguous(), y.contiguous(), V.contiguous()
    cs, cv = col_scale.contiguous(), col_valid.contiguous()
    out = torch.empty((m, b), dtype=torch.float32, device=x.device)
    deg = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return out, deg
    lib = _build.library("fused_rbf")
    code = lib.fused_nystrom_matmat(
        x.data_ptr(), y.data_ptr(), V.data_ptr(), cs.data_ptr(),
        cv.data_ptr(), out.data_ptr(), deg.data_ptr(), m, n, d, b,
        inv_two_sigma_sq(sigma),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "fused_nystrom_matmat")
    fused_nystrom_matmat.launches += 1
    return out, deg


fused_nystrom_matmat.launches = 0
