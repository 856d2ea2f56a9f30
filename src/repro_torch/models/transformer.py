"""Decoder-only transformer with a dense FFN: the port of
``repro/models/transformer.py:25-168`` for the dense family (qwen1.5).

The parameter layout is JAX's: layer weights stacked on a leading
"layers" axis, so a JAX parameter tree carries across unchanged.  A Python
loop over the layers takes the place of ``lax.scan``; each layer gets its
window from ``cfg.windows()``, as JAX's scanned xs give it.  MoE layers
are not ported: ``api.build`` refuses a config with experts.

The KV cache is ``{"k", "v": (L, B, max_seq, kv, hd) in the compute
dtype, "pos": 0-d int32}``, as in JAX; :func:`decode_step` returns a new
cache and leaves the one it was given as it was.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as ll
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


def specs(cfg: ModelConfig) -> dict:
    L = cfg.num_layers
    layer = {
        "ln1": Spec((L, cfg.d_model), ("layers", "embed"), cfg.param_dtype, init="zeros"),
        "ln2": Spec((L, cfg.d_model), ("layers", "embed"), cfg.param_dtype, init="zeros"),
        "attn": ll.attention_specs(cfg, layers=L),
        "mlp": ll.mlp_specs(cfg, layers=L),
    }
    tree = {
        "embed": ll.embed_spec(cfg),
        "final_norm": ll.norm_spec(cfg.d_model, cfg.param_dtype),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                               cfg.param_dtype, init="normal", scale=0.02)
    return tree


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer parameters."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = ll.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params.get("unembed", params["embed"])
    return ll.unembed(x, table).float()


def _block(x, lp, cfg: ModelConfig, window: int, positions,
           return_kv: bool = False):
    h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
    out = ll.gqa_attention(h, lp["attn"], cfg, window, positions,
                           return_kv=return_kv)
    attn_out, kv = (out[0], out[1:]) if return_kv else (out, None)
    x = x + attn_out
    h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ll.mlp(h, lp["mlp"], cfg), kv


def forward(params, batch, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward -> (logits (B,S,V) f32, aux)."""
    x = ll.embed(batch["tokens"], params["embed"], cfg.compute_dtype)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    for i, window in enumerate(cfg.windows()):
        x, _ = _block(x, _layer(params["layers"], i), cfg, window, positions)
    return _logits(params, x, cfg), {
        "lb_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch_size: int, max_seq: int) -> dict:
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd()
    kvs = ("layers", None, "seq", "kv_heads", "head_dim")
    return {
        "k": Spec((L, batch_size, max_seq, kv, hd), kvs, cfg.compute_dtype, init="zeros"),
        "v": Spec((L, batch_size, max_seq, kv, hd), kvs, cfg.compute_dtype, init="zeros"),
        "pos": Spec((), (), torch.int32, init="zeros"),
    }


def prefill(params, batch, cfg: ModelConfig, max_seq: int | None = None):
    """Run the prompt, return (last-token logits (B,1,V) f32, filled
    cache: the prompt's KV in positions [0, S), zeros up to max_seq)."""
    x = ll.embed(batch["tokens"], params["embed"], cfg.compute_dtype)
    B, S = x.shape[:2]
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"prefill: max_seq {max_seq} < prompt length {S}")
    positions = _positions(B, S, x.device)
    shape = (cfg.num_layers, B, max_seq, cfg.num_kv_heads, cfg.hd())
    cache = {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=x.device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=x.device),
             "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    for i, window in enumerate(cfg.windows()):
        x, (k, v) = _block(x, _layer(params["layers"], i), cfg, window,
                           positions, return_kv=True)
        cache["k"][i, :, :S] = k.to(cfg.compute_dtype)
        cache["v"][i, :, :S] = v.to(cfg.compute_dtype)
    return _logits(params, x[:, -1:], cfg), cache


def decode_step(params, cache, token, cfg: ModelConfig):
    """One decode step: token (B, 1) int -> (logits (B,1,V) f32, new cache
    with the token's KV written at ``pos`` and ``pos + 1``)."""
    x = ll.embed(token, params["embed"], cfg.compute_dtype)
    pos = cache["pos"]
    k_all, v_all = [], []
    for i, window in enumerate(cfg.windows()):
        lp = _layer(params["layers"], i)
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, kc, vc = ll.gqa_decode(h, lp["attn"], cfg, window,
                                    cache["k"][i], cache["v"][i], pos)
        k_all.append(kc)
        v_all.append(vc)
        x = x + out
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ll.mlp(h, lp["mlp"], cfg)
    return _logits(params, x, cfg), {"k": torch.stack(k_all),
                                     "v": torch.stack(v_all),
                                     "pos": pos + 1}
