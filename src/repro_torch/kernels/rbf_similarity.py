"""Tiled RBF similarity: the materialized S of the dense family.

Port of ``repro/kernels/rbf_similarity.py``.  The CUDA kernel in
``csrc/rbf_similarity.cu`` replaces the Pallas TPU kernel
``rbf_similarity`` (``repro/kernels/rbf_similarity.py:35``) and writes

    S[i, j] = exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / (2 sigma^2))

for x (n, d) and y (m, d), as the ``dense`` and ``knn-topt`` affinities
need it.

Bound on an H100 SXM (data sheet, 700 W) at n = m = 65536, d = 32: the
17.2 GB written take 5.1 ms at 3.35 TB/s (the FMAs alone 4.1 ms at
67 TFLOP/s f32).  One block per 64 x 64 output tile; the layout is in the
source's header.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain PyTorch version only for CPU tensors; ``rbf_similarity.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rbf_matmat import (PLAIN_CHUNK,
                                                  inv_two_sigma_sq, rbf_block)


def rbf_similarity_plain(x: torch.Tensor, y: torch.Tensor,
                         sigma) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbf_similarity` (PLAIN_CHUNK rows
    at a time into the output, so the temporaries stay small)."""
    inv2s2 = inv_two_sigma_sq(sigma)
    yy = (y * y).sum(-1)
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, x.shape[0], PLAIN_CHUNK):
        out[r0:r0 + PLAIN_CHUNK] = rbf_block(x[r0:r0 + PLAIN_CHUNK], y,
                                             inv2s2, yy)
    return out


def rbf_similarity(x: torch.Tensor, y: torch.Tensor, sigma) -> torch.Tensor:
    """(n, m) float32 RBF similarity of ``x`` (n, d) against ``y`` (m, d),
    both float32 on one device."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"rbf_similarity: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be (n, d), (m, d)")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("rbf_similarity: expects float32 x and y")
    if x.device != y.device:
        raise ValueError(f"rbf_similarity: tensors on {x.device} and "
                         f"{y.device}")
    if x.device.type == "cpu":
        return rbf_similarity_plain(x, y, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"rbf_similarity: unsupported device {x.device}")
    (n, d), m = x.shape, y.shape[0]
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    lib = _build.library("rbf_similarity")
    code = lib.rbf_similarity(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                              n, m, d, inv_two_sigma_sq(sigma),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rbf_similarity")
    rbf_similarity.launches += 1
    return out


rbf_similarity.launches = 0
