"""Nearest-center assignment: Lloyd's map step and ``predict``.

Port of ``repro/kernels/kmeans_assign.py``.  The CUDA kernel in
``csrc/kmeans_assign.cu`` replaces the Pallas TPU kernel ``kmeans_assign``
(``repro/kernels/kmeans_assign.py:33``) and returns, per point,

    (argmin_j, min_j) max(|p_i|^2 + |c_j|^2 - 2 p_i.c_j, 0)

with ties going to the lowest center index, as ``jnp.argmin`` does.  The
JAX estimator evaluates this same function in plain jnp
(``repro/core/kmeans.py:48``, ``:56-57``); the port calls the kernel there.

Bound on an H100 SXM (data sheet, 700 W) at n = 131072 points and k = 8
centers of dimension 8: memory-bound, ~2 us for its ~5.8 MB of traffic at
3.35 TB/s.  One thread per point, the centers in shared memory.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain PyTorch version only for CPU tensors; ``kmeans_assign.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the centers and their norms must fit the kernel's 48 KiB of shared memory
MAX_CENTER_FLOATS = 48 * 1024 // 4


def kmeans_assign_plain(points: torch.Tensor, centers: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`kmeans_assign`."""
    pp = (points * points).sum(-1)[:, None]
    cc = (centers * centers).sum(-1)[None, :]
    d2 = torch.clamp_min(pp + cc - 2.0 * (points @ centers.T), 0.0)
    dist, idx = torch.min(d2, dim=1)
    return idx, dist


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels int64 (n,), squared distances float32 (n,)) of ``points``
    (n, d) against ``centers`` (k, d), both float32 on one device."""
    if points.ndim != 2 or centers.ndim != 2 \
            or points.shape[1] != centers.shape[1]:
        raise ValueError(f"kmeans_assign: points {tuple(points.shape)} and "
                         f"centers {tuple(centers.shape)} must be (n, d), "
                         f"(k, d)")
    if points.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("kmeans_assign: expects float32 points and centers")
    if points.device != centers.device:
        raise ValueError(f"kmeans_assign: tensors on {points.device} and "
                         f"{centers.device}")
    n, d = points.shape
    k = centers.shape[0]
    if k < 1:
        raise ValueError("kmeans_assign: needs at least one center")
    if points.device.type == "cpu":
        return kmeans_assign_plain(points, centers)
    if points.device.type != "cuda":
        raise ValueError(f"kmeans_assign: unsupported device {points.device}")
    if k * d + k > MAX_CENTER_FLOATS:
        raise ValueError(f"kmeans_assign: {k} centers of dimension {d} "
                         f"exceed the kernel's shared memory")
    p, c = points.contiguous(), centers.contiguous()
    idx = torch.empty((n,), dtype=torch.int64, device=p.device)
    dist = torch.empty((n,), dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib = _build.library("kmeans_assign")
    code = lib.kmeans_assign(p.data_ptr(), c.data_ptr(), idx.data_ptr(),
                             dist.data_ptr(), n, k, d,
                             torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(code, "kmeans_assign")
    kmeans_assign.launches += 1
    return idx, dist


kmeans_assign.launches = 0
