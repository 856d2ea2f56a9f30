"""Batched serving driver: slot-based continuous batching over the
prefill/decode interface (port of ``repro/launch/serve.py``).

A fixed pool of B slots holds independent requests; finished slots are
refilled from the queue without stalling the others.  The decode step
always runs the full B-slot batch, as in JAX, with slot liveness a mask.
Prefill runs per request (left-padded to the slot prompt length) and its
KV is spliced into the batch cache.

Two behaviours of the JAX server are kept as they are: the cache position
``pos`` is shared by all slots (a refilled slot decodes at the global
``pos`` and attends to the zero KV between its prompt and ``pos``), and
``pos`` may run past ``max_seq`` (the cache write clamps to the last
position of the cache; RoPE and the mask use ``pos`` itself).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 12 --slots 4 --gen 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import api


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class Server:
    """Static-shape continuous batching: B slots, shared KV cache.

    The weights are drawn from ``seed`` on the model's device (torch draws
    other numbers than ``jax.random``); assign ``params`` before
    :meth:`run` to serve other weights.  Every slot is prefilled before
    the first decode step, so the dummy batch's cache changes no live
    request."""

    def __init__(self, model: api.Model, slots: int, prompt_len: int,
                 max_seq: int, seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.B = slots
        self.prompt_len = prompt_len
        self.max_seq = max_seq
        self.params = model.init(
            torch.Generator(device=self.device).manual_seed(seed))
        self.requests: list[Request | None] = [None] * slots
        self.steps = 0
        # batch cache built by prefilling a dummy batch once
        dummy = {"tokens": torch.zeros((slots, prompt_len), dtype=torch.long,
                                       device=self.device)}
        _, self.cache = model.prefill(self.params, dummy, max_seq=max_seq)
        self.next_tok = torch.zeros((slots, 1), dtype=torch.long,
                                    device=self.device)

    def _prefill_slot(self, slot: int, req: Request):
        toks = np.zeros((self.prompt_len,), np.int64)
        toks[-len(req.prompt):] = req.prompt[: self.prompt_len]
        batch = {"tokens": torch.as_tensor(toks, device=self.device)[None]}
        logits, cache1 = self.model.prefill(self.params, batch,
                                            max_seq=self.max_seq)

        # splice the single-request cache into the slot: the first dim
        # where it has 1 and the batch cache has B.  In place (the server
        # owns its cache; JAX builds a new one); 0-d leaves (``pos``) keep
        # the batch cache's value
        def splice(full, one):
            if one.ndim == 0:
                return full
            for d in range(one.ndim):
                if one.shape[d] == 1 and full.shape[d] == self.B:
                    full.narrow(d, slot, 1).copy_(one)
                    return full
            return full

        self.cache = {k: splice(self.cache[k], cache1[k]) for k in self.cache}
        self.requests[slot] = req
        tok = int(torch.argmax(logits[0, -1]))
        req.out.append(tok)
        # the prefill token counts toward the budget: a max_new=1 request
        # is complete right here and must not enter the decode loop
        if len(req.out) >= req.max_new:
            req.done = True
        self.next_tok[slot, 0] = tok

    def step(self):
        """One decode step for every live slot."""
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    self.next_tok)
        toks = torch.argmax(logits[:, 0], dim=-1)
        self.next_tok = toks[:, None]
        self.steps += 1
        host = toks.tolist()
        for i, req in enumerate(self.requests):
            if req is None or req.done:
                continue
            req.out.append(host[i])
            if len(req.out) >= req.max_new:
                req.done = True

    def run(self, queue: list[Request]) -> list[Request]:
        finished: list[Request] = []
        pending = list(queue)
        while pending or any(r and not r.done for r in self.requests):
            # refill free slots (continuous batching)
            for i in range(self.B):
                if (self.requests[i] is None or self.requests[i].done) and pending:
                    if self.requests[i] is not None:
                        finished.append(self.requests[i])
                    self._prefill_slot(i, pending.pop(0))
            # every slot may have finished at prefill (max_new=1): don't
            # burn a full-batch decode step with zero live requests
            if any(r is not None and not r.done for r in self.requests):
                self.step()
        finished.extend(r for r in self.requests if r is not None)
        return finished


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    model = api.build(cfg, device=args.device)
    rng = np.random.RandomState(0)
    queue = [Request(rid=i,
                     prompt=rng.randint(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                     max_new=args.gen + rng.randint(0, 5))
             for i in range(args.requests)]
    srv = Server(model, args.slots, args.prompt_len,
                 args.prompt_len + args.gen + 8)
    t0 = time.perf_counter()
    done = srv.run(queue)
    dt = time.perf_counter() - t0
    total_toks = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {total_toks} tokens, "
          f"{srv.steps} batch steps, {dt:.1f}s "
          f"({total_toks / dt:.1f} tok/s aggregate) on {srv.device}")
    for r in done[:4]:
        print(f"  req {r.rid}: {len(r.out)} tokens -> {r.out[:8]}...")
    if not all(r.done for r in done) or len(done) != args.requests:
        raise SystemExit("serve: not every request completed")


if __name__ == "__main__":
    main()
