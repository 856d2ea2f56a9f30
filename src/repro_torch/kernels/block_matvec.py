"""Row-blocked matrix product: the dense operator's pass over S.

Port of ``repro/kernels/block_matvec.py``.  The CUDA kernel in
``csrc/block_matmat.cu`` replaces the Pallas TPU kernel ``block_matmat``
and its width-1 view ``block_matvec`` (``repro/kernels/block_matvec.py:111,
129``): ``A @ V`` with f32 accumulation, one pass over A for the whole
(m, b) block.  The JAX estimator leaves its dense operator's product to
XLA (``repro/core/laplacian.py:40,45``); the port runs the degree pass
and every ``matmat`` of the ``dense``, ``knn-topt`` and ``precomputed``
affinities through this kernel.

Bound on an H100 SXM (data sheet, 700 W) at n = m = 65536: memory-bound,
the 17.2 GB of A read once take 5.1 ms at 3.35 TB/s, for any b <= 64.
One block per 64-row stripe (fewer rows at b > 8) walks the whole m axis;
the layout is in the source's header.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain PyTorch version only for CPU tensors; ``block_matmat.launches``
counts kernel launches (``block_matvec`` launches through it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# widest V block one launch takes (ops.block_matmat splits wider ones)
MAX_WIDTH = 64


def block_matmat_plain(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_matmat`."""
    return A @ V


def block_matmat(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``A @ V`` for A (n, m) and V (m, b), 1 <= b <= 64 on the card; both
    float32 on one device.  Returns (n, b) float32.  A CUDA ``A`` must be
    contiguous: it is the (n, n) similarity, too large to copy quietly."""
    if A.ndim != 2 or V.ndim != 2 or A.shape[1] != V.shape[0]:
        raise ValueError(f"block_matmat: A {tuple(A.shape)} and V "
                         f"{tuple(V.shape)} must be (n, m), (m, b)")
    if A.dtype != torch.float32 or V.dtype != torch.float32:
        raise TypeError("block_matmat: expects float32 A and V")
    if A.device != V.device:
        raise ValueError(f"block_matmat: tensors on {A.device} and "
                         f"{V.device}")
    if A.device.type == "cpu":
        return block_matmat_plain(A, V)
    if A.device.type != "cuda":
        raise ValueError(f"block_matmat: unsupported device {A.device}")
    (n, m), b = A.shape, V.shape[1]
    if not 1 <= b <= MAX_WIDTH:
        raise ValueError(f"block_matmat: block width {b} outside "
                         f"1..{MAX_WIDTH}")
    if not A.is_contiguous():
        raise ValueError("block_matmat: A must be contiguous (row-major)")
    V = V.contiguous()
    out = torch.empty((n, b), dtype=torch.float32, device=A.device)
    if n == 0:
        return out
    lib = _build.library("block_matmat")
    code = lib.block_matmat(A.data_ptr(), V.data_ptr(), out.data_ptr(), n,
                            m, b,
                            torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(code, "block_matmat")
    block_matmat.launches += 1
    return out


block_matmat.launches = 0


def block_matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` for v (m,): the width-1 view of :func:`block_matmat`."""
    return block_matmat(A, v.reshape(-1, 1)).reshape(A.shape[0])
