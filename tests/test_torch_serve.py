"""The port's serving driver (``repro_torch.launch.serve``) against the JAX
package's, on the CPU.

Both servers get the same weights: JAX's ``Server`` draws them from
``PRNGKey(0)``, and they are assigned to the port server's ``params``
before ``run``.  That is exact: ``run`` prefills every slot before the
first decode step and each prefill replaces its slot's whole cache row,
so the port server's own dummy prefill changes no live request.  Both get
the same queue, made with numpy seeds, and must emit the same token
streams.  The compute dtype is f32 (as in ``tests/test_serve.py``), so
greedy decoding is not at the mercy of bf16 rounding that the two
frameworks place differently.  The runs cover two behaviours of the JAX
server that the port keeps: every slot decodes at the one shared cache
position, and that position runs past ``max_seq`` (the cache write
clamps, RoPE and the mask do not).
"""
from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import api, params as pp

ARCH = "qwen1.5-0.5b"


def _servers(slots, prompt_len, max_seq, flash=False):
    jcfg = jconfigs.get_smoke(ARCH).with_(compute_dtype=jnp.float32)
    jsrv = jserve.Server(japi.build(jcfg), slots, prompt_len, max_seq)
    cfg = configs.get_smoke(ARCH).with_(compute_dtype=torch.float32,
                                        use_flash_attention=flash)
    srv = serve.Server(api.build(cfg, device="cpu"), slots, prompt_len,
                       max_seq)
    srv.params = pp.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                      srv.device)
    return jsrv, srv


def _queue(mod, n, prompt_len, max_new, seed=0, vocab=512):
    """``serve.main``'s queue: prompts, then each request's budget."""
    rng = np.random.RandomState(seed)
    return [mod.Request(rid=i,
                        prompt=rng.randint(0, vocab, prompt_len)
                        .astype(np.int32),
                        max_new=max_new(i, rng))
            for i in range(n)]


def _streams(done):
    return {r.rid: list(r.out) for r in done}


def test_server_signature_is_jax_s():
    assert list(inspect.signature(serve.Server).parameters.items()) == \
        list(inspect.signature(jserve.Server).parameters.items())


@pytest.mark.parametrize("flash", [False, True])
def test_serve_main_settings_match_jax(flash):
    """4 slots, 8 requests, prompts of 16, max_new = 12 + randint(0, 5),
    max_seq = 16 + 12 + 8 = 36 (``serve.main``'s traffic): refilled slots
    decode at the shared position, which ends past max_seq."""
    jsrv, srv = _servers(4, 16, 36, flash)
    budget = lambda i, rng: 12 + rng.randint(0, 5)          # noqa: E731
    want = _streams(jsrv.run(_queue(jserve, 8, 16, budget)))
    done = srv.run(_queue(serve, 8, 16, budget))
    assert _streams(done) == want
    assert all(r.done and len(r.out) == r.max_new for r in done)
    assert srv.steps == jsrv.steps
    # one position for every slot: the dummy prompt's length plus the steps
    assert int(srv.cache["pos"]) == int(jsrv.cache["pos"]) == 16 + srv.steps
    assert int(srv.cache["pos"]) > 36
    for key in ("k", "v"):
        np.testing.assert_allclose(srv.cache[key].numpy(),
                                   np.asarray(jsrv.cache[key]), rtol=0,
                                   atol=1e-4)


def test_max_new_one_and_mixed_budgets_match_jax():
    """Budgets of 1 finish at prefill and take no decode step."""
    jsrv, srv = _servers(2, 8, 24)
    budget = lambda i, rng: 1 + (i % 3)                       # noqa: E731
    want = _streams(jsrv.run(_queue(jserve, 6, 8, budget, seed=3)))
    done = srv.run(_queue(serve, 6, 8, budget, seed=3))
    assert _streams(done) == want
    assert all(len(r.out) == r.max_new for r in done)
    assert srv.steps == jsrv.steps

    jsrv, srv = _servers(2, 8, 24)
    one = lambda i, rng: 1                                    # noqa: E731
    done = srv.run(_queue(serve, 1, 8, one, seed=2))
    assert _streams(done) == _streams(jsrv.run(_queue(jserve, 1, 8, one,
                                                      seed=2)))
    assert len(done[0].out) == 1 and srv.steps == 0


def test_server_matches_direct_prefill_and_decode():
    """A lone request's stream is greedy prefill + decode on a fresh
    cache of the same size."""
    _, srv = _servers(2, 8, 24)
    prompt = np.random.RandomState(1).randint(0, 512, 8).astype(np.int32)
    got = srv.run([serve.Request(rid=0, prompt=prompt, max_new=5)])[0].out
    model = srv.model
    logits, cache = model.prefill(srv.params,
                                  {"tokens": torch.as_tensor(prompt[None])},
                                  max_seq=24)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(4):
        logits, cache = model.decode_step(srv.params, cache,
                                          torch.tensor([[want[-1]]]))
        want.append(int(torch.argmax(logits[0, 0])))
    assert got == want


def test_main_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "on cpu" in out


def test_main_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
