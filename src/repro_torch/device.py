"""Device resolution — the port's counterpart of the JAX package's
``interpret_default`` (``repro/kernels/block_matvec.py``).

The JAX package interprets its Pallas kernels whenever the backend is not
a TPU.  The port has no such quiet substitute: an entry point given
``device=None`` runs on the card, and raises when there is none.  The
plain PyTorch versions of the kernels run only for tensors the caller put
on the CPU on purpose (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise the device
    named.  Any CUDA device also gets full-f32 matrix products."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        # keep f32 products in f32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
