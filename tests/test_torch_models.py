"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``,
the ``flash_attention`` kernel's plain version) against the JAX package's,
on the CPU.

Inputs come from numpy seeds; JAX's weights are carried across with
``params_from_numpy``.  The port runs its plain versions here (its flash
route runs the kernel's plain version).  The Pallas flash kernel does not
run under the installed JAX, so JAX runs its non-flash routes
(``_sdpa_dense`` / ``_sdpa_chunked``) with the window its flash route
would use, and the port's flash is held against ``ref.flash_attention``.
Tolerances: flash 2e-5 in f32 and 2e-2 in bf16 (the JAX flash tests',
``tests/test_kernels_flash.py:28``); 1e-5 for single layers in f32;
2e-4 * max |logits| for whole models in f32 (the JAX decode test uses
2e-3, ``tests/test_models.py:76``); the bf16 limit is stated at its test.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops, ref as jref
from repro.models import api as japi, layers as jll
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.params import init_params as jinit
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import api, layers as ll, params as pp
from repro_torch.models.config import ModelConfig

ARCH = "qwen1.5-0.5b"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = 2e-4
_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float64: jnp.float64}


def _jax_cfg(cfg: ModelConfig, **kw):
    """The JAX package's config with the same fields as the port's."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["param_dtype"] = _DTYPES[cfg.param_dtype]
    fields["compute_dtype"] = _DTYPES[cfg.compute_dtype]
    return JaxModelConfig(**fields).with_(**kw)


def _carry(jparams):
    return pp.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), "cpu")


def _close(got: torch.Tensor, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _smoke(**kw) -> ModelConfig:
    return configs.get_smoke(ARCH).with_(compute_dtype=torch.float32, **kw)


# ---------------------------------------------------------------------------
# flash_attention (the kernel's plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window", [
    (2, 3, 3, 128, 128, 32, True, -1),      # causal
    (1, 2, 2, 64, 256, 32, True, -1),       # causal, fewer queries
    (1, 1, 1, 64, 128, 16, False, -1),      # non-causal
    (1, 2, 2, 128, 128, 16, True, 16),      # window 16
    (1, 2, 2, 128, 128, 16, True, 64),      # window 64
    (2, 6, 2, 96, 96, 32, True, -1),        # GQA, 3 query heads a kv head
    (1, 4, 1, 100, 100, 64, True, 24),      # ragged, GQA, window
    (1, 2, 2, 37, 53, 64, False, -1),       # ragged, non-causal
    (1, 2, 1, 70, 40, 64, False, 8),        # rows past T + 7 see no key
])
def test_flash_attention_matches_jax_ref(B, H, KV, S, T, hd, causal,
                                         window, dtype):
    rng = np.random.RandomState(B * H + S + T + hd)
    q, k, v = (rng.randn(B, n, L, hd).astype(np.float32)
               for n, L in ((H, S), (KV, T), (KV, T)))
    jdt = jnp.dtype(dtype)
    rep = H // KV
    want = jref.flash_attention(
        jnp.asarray(q).astype(jdt),
        jnp.repeat(jnp.asarray(k).astype(jdt), rep, axis=1),
        jnp.repeat(jnp.asarray(v).astype(jdt), rep, axis=1),
        causal=causal, window=window)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(*(torch.as_tensor(a).to(tdt)
                                for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.shape == (B, H, S, hd) and got.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("S,T,causal", [(64, 300, False), (64, 300, True),
                                        (300, 300, False)])
def test_flash_attention_keeps_jax_padding_refusal(S, T, causal):
    """Shapes the JAX wrapper refuses (its kernel cannot mask the padded
    keys) raise ValueError in the port."""
    q = np.zeros((1, 1, S, 16), np.float32)
    k = np.zeros((1, 1, T, 16), np.float32)
    with pytest.raises(AssertionError, match="padding"):
        jops.flash_attention(q, k, k, causal=causal)
    with pytest.raises(ValueError, match="padding"):
        ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(k), causal=causal)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    for mine, theirs in ((configs.get(ARCH), jconfigs.get(ARCH)),
                         (configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH))):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name.endswith("_dtype"):
                assert _DTYPES[a] == b, f.name
            else:
                assert a == b, (f.name, a, b)
        assert mine.windows() == theirs.windows()
        assert mine.hd() == theirs.hd()
        assert not mine.use_flash_attention


@pytest.mark.parametrize("local_window,local_ratio", [(8, 2), (8, -1),
                                                      (8, 0), (-1, 2)])
def test_window_pattern_matches_jax(local_window, local_ratio):
    cfg = _smoke(num_layers=7, local_window=local_window,
                 local_ratio=local_ratio)
    assert cfg.windows() == _jax_cfg(cfg).windows()


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b", "xlstm-1.3b",
                                  "nope"])
def test_unported_architectures_raise(arch):
    with pytest.raises(ValueError, match=f"{arch!r} is not ported"):
        configs.get(arch)
    with pytest.raises(ValueError, match=f"{arch!r} is not ported"):
        configs.get_smoke(arch)


@pytest.mark.parametrize("family", ["moe", "xlstm", "hybrid", "ssm",
                                    "encdec", "audio", "vlm"])
def test_non_dense_family_raises(family):
    cfg = configs.get_smoke(ARCH).with_(family=family)
    with pytest.raises(ValueError, match=f"{family!r} is not ported"):
        api.build(cfg, device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(sharding_preset="sp_serve"), "mesh"),
    (dict(frontend="embed"), "frontend"),
    (dict(num_experts=4, top_k=2), "MoE")])
def test_unsupported_settings_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        api.build(configs.get_smoke(ARCH).with_(**kw), device="cpu")


def test_build_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build(configs.get_smoke(ARCH))
    assert api.build(configs.get_smoke(ARCH), "cpu").device.type == "cpu"


@pytest.mark.parametrize("smoke", [False, True])
def test_param_specs_and_count_match_jax(smoke):
    """Parameter and KV-cache spec shapes, and the parameter count."""
    cfg = (configs.get_smoke if smoke else configs.get)(ARCH)
    mine = api.build(cfg, device="cpu")
    theirs = japi.build(_jax_cfg(cfg))
    assert mine.num_params() == theirs.num_params()
    shape = lambda s: s.shape                                 # noqa: E731
    is_spec = lambda s: hasattr(s, "axes")                    # noqa: E731
    assert pp.tree_map(shape, mine.spec) == jax.tree.map(
        shape, theirs.spec, is_leaf=is_spec)
    assert pp.tree_map(shape, mine.cache_specs(3, 40)) == jax.tree.map(
        shape, theirs.cache_specs(3, 40), is_leaf=is_spec)
    if not smoke:
        assert 4.6e8 < mine.num_params() < 4.7e8


def test_init_uses_jax_distributions_and_fan_rule():
    """fan_in weights have std 1/sqrt(shape[0]) -- for stacked layer
    weights that is the layer count, as in JAX (params.py:44) -- norms and
    biases are zeros, the embedding N(0, 0.02)."""
    cfg = configs.get_smoke(ARCH).with_(d_model=256, vocab_size=4096)
    p = api.build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    wq = p["layers"]["attn"]["wq"]
    assert wq.shape == (4, 256, 4, 64) and wq.dtype == torch.float32
    assert abs(float(wq.std()) - 0.5) < 0.01
    assert abs(float(p["layers"]["mlp"]["wo"].std()) - 0.5) < 0.01
    assert abs(float(p["embed"].std()) - 0.02) < 0.001
    assert not p["final_norm"].any() and not p["layers"]["ln1"].any()
    assert not p["layers"]["attn"]["bq"].any()
    j = jinit(japi.build(_jax_cfg(cfg)).spec, jax.random.PRNGKey(0))
    assert abs(float(jnp.std(j["layers"]["attn"]["wq"])) - 0.5) < 0.01


def test_params_from_numpy_keeps_layout():
    jm = japi.build(_jax_cfg(_smoke()))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = pp.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(list(pp._leaves(tp)))
    for path, leaf in flat:
        got = tp
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 48).astype(np.float32) * 3
    w = rng.randn(48).astype(np.float32) * 0.1
    _close(ll.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-6),
           jll.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta,offset", [(10_000.0, 0), (1_000_000.0, 37)])
def test_apply_rope_matches_jax(theta, offset):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + offset, (2, 9)).copy()
    _close(ll.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
           jll.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    cfg = _smoke(act=act)
    jp = jinit(jll.mlp_specs(_jax_cfg(cfg)), jax.random.PRNGKey(3))
    x = np.random.RandomState(2).randn(2, 5, cfg.d_model).astype(np.float32)
    _close(ll.mlp(torch.as_tensor(x), _carry(jp), cfg),
           jll.mlp(jnp.asarray(x), jp, _jax_cfg(cfg)))


def _attention_case(cfg, seed=4):
    jp = jinit(jll.attention_specs(_jax_cfg(cfg)), jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: a + 0.1, jp)          # non-zero biases
    S = 32
    x = np.random.RandomState(5).randn(2, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).copy()
    return jp, x, pos


@pytest.mark.parametrize("route", ["dense", "chunked"])
@pytest.mark.parametrize("window", [-1, 5])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_gqa_attention_matches_jax(kv_heads, window, route):
    """The dense and chunked routes (the chunked one where the sequence is
    longer than ``dense_attn_max_seq``) against JAX's, GQA included."""
    cfg = _smoke(num_kv_heads=kv_heads,
                 dense_attn_max_seq=8 if route == "chunked" else 8192,
                 attn_chunk=8)
    jp, x, pos = _attention_case(cfg)
    out, k, v = ll.gqa_attention(torch.as_tensor(x), _carry(jp), cfg, window,
                                 torch.as_tensor(pos), return_kv=True)
    jout, jk, jv = jll.gqa_attention(jnp.asarray(x), jp, _jax_cfg(cfg),
                                     window, jnp.asarray(pos), return_kv=True)
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("local_window,local_ratio,layer_window", [
    (-1, 0, -1), (5, -1, 5), (5, 2, 5), (5, 2, -1)])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_route_applies_jax_window_rule(kv_heads, local_window,
                                             local_ratio, layer_window):
    """The flash route ignores the layer's window and uses one for every
    layer: ``local_window`` if every layer is local (ratio -1), else -1
    (``layers.py:245``).  JAX's flash route does the same; it is held here
    against JAX's dense route given that window."""
    cfg = _smoke(num_kv_heads=kv_heads, local_window=local_window,
                 local_ratio=local_ratio, use_flash_attention=True)
    jp, x, pos = _attention_case(cfg)
    out, k, v = ll.gqa_attention(torch.as_tensor(x), _carry(jp), cfg,
                                 layer_window, torch.as_tensor(pos),
                                 return_kv=True)
    win = local_window if local_ratio == -1 else -1
    jout, jk, jv = jll.gqa_attention(
        jnp.asarray(x), jp, _jax_cfg(cfg, use_flash_attention=False), win,
        jnp.asarray(pos), return_kv=True)
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("pos,window", [(5, -1), (11, 4), (20, -1)])
def test_gqa_decode_matches_jax(pos, window):
    """One decode token against a random cache, including a ``pos`` past
    the cache (the write clamps to its last position, RoPE and the mask do
    not); the caches given are left as they were."""
    cfg = _smoke(num_kv_heads=2)
    jcfg = _jax_cfg(cfg)
    jp = jinit(jll.attention_specs(jcfg), jax.random.PRNGKey(6))
    rng = np.random.RandomState(pos)
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    kc = rng.randn(2, 16, cfg.num_kv_heads, cfg.hd()).astype(np.float32)
    vc = rng.randn(*kc.shape).astype(np.float32)
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    out, k2, v2 = ll.gqa_decode(torch.as_tensor(x), _carry(jp), cfg, window,
                                tk, tv, torch.tensor(pos, dtype=torch.int32))
    jout, jk2, jv2 = jll.gqa_decode(jnp.asarray(x), jp, jcfg, window,
                                    jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(pos, jnp.int32))
    _close(out, jout)
    _close(k2, jk2)
    _close(v2, jv2)
    np.testing.assert_array_equal(tk.numpy(), kc)
    np.testing.assert_array_equal(tv.numpy(), vc)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _models(cfg, **jax_kw):
    """The port's model and JAX's (its dense route, with ``jax_kw``
    applied), on JAX's PRNGKey(0) weights."""
    jm = japi.build(_jax_cfg(cfg, use_flash_attention=False, **jax_kw))
    jparams = jm.init(jax.random.PRNGKey(0))
    return api.build(cfg, "cpu"), jm, _carry(jparams), jparams


def _err(got: torch.Tensor, want) -> tuple[float, float]:
    want = np.asarray(want, np.float32)
    return (float(np.abs(got.float().numpy() - want).max()),
            float(np.abs(want).max()))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("S,max_seq", [(32, 8192), (32, 8)])
def test_forward_matches_jax(S, max_seq, flash):
    """``dense_attn_max_seq`` 8 sends S = 32 through both packages'
    chunked route (without flash)."""
    tm, jm, tp, jp = _models(_smoke(use_flash_attention=flash,
                                    dense_attn_max_seq=max_seq, attn_chunk=8))
    toks = np.random.RandomState(7).randint(0, tm.cfg.vocab_size, (2, S))
    logits, aux = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    jlogits, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert logits.shape == (2, S, tm.cfg.vocab_size)
    assert logits.dtype == torch.float32 and float(aux["lb_loss"]) == 0.0
    err, scale = _err(logits, jlogits)
    assert err <= MODEL_TOL * scale, (err, scale)


def test_flash_route_runs_gemma3_like_layers_global():
    """local_window 8, local_ratio 2 (two local layers, then one global):
    with ``use_flash_attention`` every layer runs global, as JAX's flash
    route does; without it the local layers keep their window, as JAX's
    dense route does.  The two differ at S = 32."""
    cfg = _smoke(local_window=8, local_ratio=2)
    assert cfg.windows() == [8, 8, -1, 8]
    toks = np.random.RandomState(10).randint(0, cfg.vocab_size, (2, 32))
    batch, jbatch = ({"tokens": torch.as_tensor(toks)},
                     {"tokens": jnp.asarray(toks, jnp.int32)})
    out = {}
    for flash, jax_kw in ((True, dict(local_window=-1)), (False, {})):
        tm, jm, tp, jp = _models(cfg.with_(use_flash_attention=flash),
                                 **jax_kw)
        out[flash] = tm.forward(tp, batch)[0]
        err, scale = _err(out[flash], jm.forward(jp, jbatch)[0])
        assert err <= MODEL_TOL * scale, (flash, err, scale)
    err, scale = _err(out[True], out[False].numpy())
    assert err > 10 * MODEL_TOL * scale, (err, scale)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_prefill_and_decode_match_jax(kv_heads, flash):
    """prefill(8) into a 16-slot cache, then 4 decode steps: logits, the
    final cache and its position."""
    tm, jm, tp, jp = _models(_smoke(num_kv_heads=kv_heads,
                                    use_flash_attention=flash))
    toks = np.random.RandomState(8).randint(0, tm.cfg.vocab_size, (2, 12))
    lg, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :8])},
                           max_seq=16)
    jlg, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8],
                                                         jnp.int32)},
                             max_seq=16)
    assert lg.shape == (2, 1, tm.cfg.vocab_size)
    assert cache["pos"].ndim == 0 and int(cache["pos"]) == 8
    err, scale = _err(lg, jlg)
    assert err <= MODEL_TOL * scale, ("prefill", err, scale)
    for key in ("k", "v"):
        assert cache[key].shape == tuple(jcache[key].shape)
        _close(cache[key], jcache[key], dict(rtol=0, atol=1e-4))
    for t in range(8, 12):
        tok = torch.as_tensor(toks[:, t:t + 1])
        lg, cache = tm.decode_step(tp, cache, tok)
        jlg, jcache = jm.decode_step(jp, jcache,
                                     jnp.asarray(toks[:, t:t + 1], jnp.int32))
        err, scale = _err(lg, jlg)
        assert err <= MODEL_TOL * scale, (t, err, scale)
    assert int(cache["pos"]) == int(jcache["pos"]) == 12
    for key in ("k", "v"):
        _close(cache[key], jcache[key], dict(rtol=0, atol=1e-4))


def test_bf16_forward_and_decode_match_jax():
    """qwen1.5's smoke config in its own bf16 compute dtype, flash route.
    The two frameworks round bf16 products at other places.  On these
    inputs JAX's own bf16 logits lie 9.5e-2 * max |logits| from its f32
    logits; the limit for port against JAX, both in bf16, is 5e-2 * max
    |logits|, about half that."""
    tm, jm, tp, jp = _models(configs.get_smoke(ARCH).with_(
        use_flash_attention=True))
    toks = np.random.RandomState(9).randint(0, tm.cfg.vocab_size, (2, 12))
    logits, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    jlogits, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    err, scale = _err(logits, jlogits)
    assert err <= 5e-2 * scale, (err, scale)
    lg, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :8])},
                           max_seq=12)
    jlg, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8],
                                                         jnp.int32)},
                             max_seq=12)
    assert cache["k"].dtype == torch.bfloat16
    for t in range(8, 12):
        tok = torch.as_tensor(toks[:, t:t + 1])
        lg, cache = tm.decode_step(tp, cache, tok)
        jlg, jcache = jm.decode_step(jp, jcache,
                                     jnp.asarray(toks[:, t:t + 1], jnp.int32))
        err, scale = _err(lg, jlg)
        assert err <= 5e-2 * scale, (t, err, scale)


def test_small_lm_f32_rounding_against_f64():
    """The card-vs-CPU reference model of ``chip_smoke.py`` (qwen1.5's
    smoke config, f32, prompt 100 + 4 decode steps): its f32 logits lie
    ~6e-6 * max |logits| from an f64 evaluation (the dense route in f64),
    well inside the 2e-4 * max that ``chip_smoke.py`` and the parity tests
    allow between two f32 evaluations that sum in other orders."""
    cfg = _smoke(use_flash_attention=True)
    f32 = api.build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    f64 = pp.tree_map(lambda t: t.double(), f32)
    toks = torch.as_tensor(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 104)))
    out = []
    for c, p in ((cfg, f32), (cfg.with_(use_flash_attention=False,
                                        compute_dtype=torch.float64,
                                        param_dtype=torch.float64), f64)):
        model = api.build(c, "cpu")
        lg, cache = model.prefill(p, {"tokens": toks[:, :100]}, max_seq=104)
        steps = [lg]
        for i in range(100, 104):
            lg, cache = model.decode_step(p, cache, toks[:, i:i + 1])
            steps.append(lg)
        out.append(torch.cat(steps, dim=1).double())
    err = float((out[0] - out[1]).abs().max())
    scale = float(out[1].abs().max())
    assert err <= 1e-4 * scale, (err, scale)
