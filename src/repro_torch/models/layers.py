"""Core transformer layers: norms, RoPE, GQA attention (flash kernel /
dense / chunked online-softmax / decode with a KV cache), gated MLPs,
embeddings.

Port of ``repro/models/layers.py:24-129,182-320``, with the JAX layouts
kept at every function: activations (b, s, d), q/k/v (b, s, heads, hd),
weights as the JAX specs give them.  Parameters are nested dicts of
tensors built from :class:`~repro_torch.models.params.Spec` trees.  The
functions are pure, as JAX's: :func:`gqa_decode` returns new caches.
Two behaviours of the reference are kept as they are: the flash route
gives every layer one window (``layers.py:245``), and the decode write
clamps ``pos`` to the cache while RoPE and the mask do not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms / embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def norm_spec(d: int, dtype) -> Spec:
    return Spec((d,), ("embed",), dtype, init="zeros")


def embed_spec(cfg: ModelConfig) -> Spec:
    return Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                cfg.param_dtype, init="normal", scale=0.02)


def embed(tokens: torch.Tensor, table: torch.Tensor, compute_dtype
          ) -> torch.Tensor:
    # gather, then cast: the same values as JAX's cast-then-gather
    return table[tokens].to(compute_dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, n, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    hd = cfg.hd()
    L = (layers,) if layers is not None else ()
    lax_ = ("layers",) if layers is not None else ()
    pd = cfg.param_dtype
    spec = {
        "wq": Spec(L + (cfg.d_model, cfg.num_heads, hd),
                   lax_ + ("embed", "heads", "head_dim"), pd),
        "wk": Spec(L + (cfg.d_model, cfg.num_kv_heads, hd),
                   lax_ + ("embed", "kv_heads", "head_dim"), pd),
        "wv": Spec(L + (cfg.d_model, cfg.num_kv_heads, hd),
                   lax_ + ("embed", "kv_heads", "head_dim"), pd),
        "wo": Spec(L + (cfg.num_heads, hd, cfg.d_model),
                   lax_ + ("heads", "head_dim", "embed"), pd),
    }
    if cfg.qkv_bias:
        spec["bq"] = Spec(L + (cfg.num_heads, hd), lax_ + ("heads", "head_dim"), pd, init="zeros")
        spec["bk"] = Spec(L + (cfg.num_kv_heads, hd), lax_ + ("kv_heads", "head_dim"), pd, init="zeros")
        spec["bv"] = Spec(L + (cfg.num_kv_heads, hd), lax_ + ("kv_heads", "head_dim"), pd, init="zeros")
    return spec


def _qkv(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
          causal: bool) -> torch.Tensor:
    """(..., S_q, S_k) additive f32 mask."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dq - dk < window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa_dense(q, k, v, mask, scale):
    """q: (b,s,h,hd) k/v: (b,t,kv,hd) grouped; mask (b or 1, s, t)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    scores = scores + mask[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, q_pos, k_pos, window, causal, scale,
                  q_chunk: int, k_chunk: int):
    """Online-softmax attention over KV chunks inside q chunks: peak memory
    O(q_chunk * k_chunk) per (batch, head); masked tiles still computed."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    t = k.shape[1]
    q_chunk = min(q_chunk, s)
    k_chunk = min(k_chunk, t)
    if s % q_chunk or t % k_chunk:
        raise ValueError(f"_sdpa_chunked: sequence lengths ({s}, {t}) are "
                         f"not multiples of the chunks ({q_chunk}, "
                         f"{k_chunk})")
    qg = q.reshape(b, s, kv, g, hd)
    outs = []
    for q0 in range(0, s, q_chunk):
        qblk = qg[:, q0:q0 + q_chunk]
        qpos = q_pos[:, q0:q0 + q_chunk]
        m = torch.full((b, kv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        a = torch.zeros((b, kv, g, q_chunk, hd), dtype=torch.float32,
                        device=q.device)
        for t0 in range(0, t, k_chunk):
            kblk, vblk = k[:, t0:t0 + k_chunk], v[:, t0:t0 + k_chunk]
            kpos = k_pos[:, t0:t0 + k_chunk]
            sc = torch.einsum("bqkgh,btkh->bkgqt", qblk, kblk).float() * scale
            sc = sc + _mask(qpos, kpos, window, causal)[:, None, None]
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            # the PV product in q's dtype, accumulated into f32 (as JAX's
            # einsum result is added to its f32 carry)
            a = a * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p.to(qblk.dtype), vblk).float()
            m = m_new
        out = a / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).to(qblk.dtype))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def gqa_attention(x: torch.Tensor, p: dict, cfg: ModelConfig, window: int,
                  positions: torch.Tensor, return_kv: bool = False):
    """Full-sequence (train / prefill) GQA attention with causal + window
    mask.  The flash route counts positions from 0, as JAX's does."""
    scale = 1.0 / (cfg.hd() ** 0.5)
    q, k, v = _qkv(x, p, cfg, positions)
    s = x.shape[1]
    if cfg.use_flash_attention:
        # the JAX route's window rule (layers.py:245): one window for every
        # layer, so only an all-local (-1 ratio) pattern keeps its window
        win = cfg.local_window if cfg.local_ratio == -1 else -1
        heads_first = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        out = kops.flash_attention(*heads_first, causal=True,
                                   window=win).transpose(1, 2)
    elif s <= cfg.dense_attn_max_seq:
        mask = _mask(positions, positions, window, causal=True)
        out = _sdpa_dense(q, k, v, mask, scale)
    else:
        out = _sdpa_chunked(q, k, v, positions, positions, window, True,
                            scale, q_chunk=cfg.attn_chunk,
                            k_chunk=cfg.attn_chunk)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return out, k, v
    return out


def gqa_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, window: int,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: torch.Tensor):
    """One-token decode: x (b,1,d); cache (b,S,kv,hd); ``pos`` a 0-d int
    tensor.  Returns (out (b,1,d), k_cache, v_cache) with the new KV
    written at ``pos`` into new caches.  As ``lax.dynamic_update_slice``
    does, the write index is clamped to [0, S-1] while RoPE and the mask
    use ``pos`` itself."""
    scale = 1.0 / (cfg.hd() ** 0.5)
    positions = pos.reshape(1, 1).expand(x.shape[0], 1)
    q, k, v = _qkv(x, p, cfg, positions)
    b, S, kv, hd = k_cache.shape
    at = pos.clamp(0, S - 1).reshape(1).long()
    k_cache = k_cache.index_copy(1, at, k.to(k_cache.dtype))
    v_cache = v_cache.index_copy(1, at, v.to(v_cache.dtype))
    h = q.shape[2]
    g = h // kv
    qg = q.reshape(b, 1, kv, g, hd)
    k_pos = torch.arange(S, device=x.device)[None, :]
    valid = k_pos <= pos
    if window > 0:
        valid = valid & (pos - k_pos < window)
    mask = torch.where(valid, 0.0, NEG_INF).float()
    scores = torch.einsum("bqkgh,btkh->bkgqt", qg, k_cache.to(q.dtype))
    scores = scores.float() * scale + mask[:, None, None, None, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqt,btkh->bqkgh", w, v_cache.to(q.dtype))
    out = out.reshape(b, 1, h, hd)
    return (torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)),
            k_cache, v_cache)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, layers: int | None = None,
              d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    L = (layers,) if layers is not None else ()
    lax_ = ("layers",) if layers is not None else ()
    pd = cfg.param_dtype
    return {
        "wi": Spec(L + (cfg.d_model, 2, d_ff), lax_ + ("embed", None, "mlp"), pd),
        "wo": Spec(L + (d_ff, cfg.d_model), lax_ + ("mlp", "embed"), pd),
    }


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    gu = torch.einsum("bsd,dcf->bscf", x, p["wi"].to(x.dtype))
    h = _act(cfg.act)(gu[:, :, 0]) * gu[:, :, 1]
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))
