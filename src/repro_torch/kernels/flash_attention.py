"""Causal / sliding-window flash attention: every prefill layer of the LM.

Port of ``repro/kernels/flash_attention.py``.  The CUDA kernel in
``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``flash_attention`` (``repro/kernels/flash_attention.py:83``, body
``_flash_kernel`` :34) and computes, for q (B, H, S, hd) and k, v
(B, KV, T, hd) with H a multiple of KV,

    o[b, h] = softmax(scale * q[b, h] k[b, h // (H/KV)]^T + mask) v[b, h // (H/KV)]

with ``scale = 1/sqrt(hd)`` and the additive mask -1e30 where a key lies
past its query (``causal``) or ``window`` or more positions behind it
(``window > 0``), positions counted from 0 for queries and keys alike.  It
reads the grouped kv heads in place (no broadcast copy) and masks ragged S
and T itself.  Inputs are bf16 or f32, the output has their dtype; the
kernel is built for hd in :data:`HEAD_DIMS`.

Bound on an H100 SXM (data sheet, 700 W) at the qwen1.5-0.5b prefill
(B = 1, H = KV = 16, S = T = 2048, hd = 64, causal, bf16): 8.6e9 flops on
unmasked pairs, ~8.7 us at 989 TFLOP/s of bf16 tensor cores.  bf16 runs
on the tensor cores (``mma.sync``), f32 on the FMA pipes; neither
overlaps its loads with its products yet (numbers in PERF.md).

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain PyTorch version only for CPU tensors; ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 64, 128, 256)
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = -1
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: materialised f32
    scores, the mask, softmax and the PV product, as
    ``repro.kernels.ref.flash_attention`` computes them."""
    H, S, hd = q.shape[1:]
    KV, T = k.shape[1:3]
    kf = k.float().repeat_interleave(H // KV, dim=1)
    vf = v.float().repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhqd,bhtd->bhqt", q.float(), kf) * (1.0 / hd ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bhtd->bhqd", w, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = -1) -> torch.Tensor:
    """Attention of q (B, H, S, hd) over k, v (B, KV, T, hd), bf16 or f32
    on one device; see the module docstring.  CUDA inputs must be
    contiguous and 16-byte aligned (the kernel loads 16 bytes a thread)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} must be "
                         f"(B, H, S, hd) and (B, KV, T, hd)")
    B, H, S, hd = q.shape
    KV, T = k.shape[1:3]
    if KV < 1 or H % KV != 0:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} kv heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: expects bfloat16 or float32 q, "
                        f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device} and {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head "
                         f"dims {HEAD_DIMS}, not {hd}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} exceeds the "
                         f"kernel's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if T == 0:
        raise ValueError("flash_attention: needs at least one key")
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    lib = _build.library("flash_attention")
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        S, T, hd, _DTYPE_CODES[q.dtype], 1.0 / hd ** 0.5, int(causal),
        int(window), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
