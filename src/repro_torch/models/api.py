"""Model interface: ``build(cfg)`` -> :class:`Model` with spec / forward /
prefill / decode_step / cache_specs.

Port of ``repro/models/api.py:44-88`` for the dense family, the one family
ported so far; ``build`` refuses the others by name, and refuses what a
single card has no counterpart for (a sharding preset) or the dense
transformer does not run (experts, an embedding frontend).  ``loss_fn``
and ``cross_entropy`` come with the training slice.

A model lives on one device: ``build(cfg, device=None)`` resolves it as
every entry point of the port does (``cuda``, raising without a card,
unless the caller asks for ``"cpu"``), and :meth:`Model.init` draws the
parameters there.  ``forward``, ``prefill`` and ``decode_step`` run where
their arguments lie.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import params as pp, transformer
from repro_torch.models.config import ModelConfig

_FAMILIES = {"dense": transformer}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    spec: Any                                   # param Spec tree
    forward: Callable                           # (params, batch) -> (logits, aux)
    prefill: Callable                           # (params, batch, max_seq) -> (logits, cache)
    decode_step: Callable                       # (params, cache, token) -> (logits, cache)
    cache_specs: Callable                       # (batch, max_seq) -> Spec tree
    device: torch.device

    def init(self, generator: torch.Generator):
        """Random parameters on the model's device, drawn from
        ``generator`` (which must live on that device)."""
        return pp.init_params(self.spec, generator, self.device)

    def num_params(self) -> int:
        return pp.count_params(self.spec)


def build(cfg: ModelConfig, device=None) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: model family {cfg.family!r} is not "
                         f"ported to repro_torch (ported: "
                         f"{sorted(_FAMILIES)})")
    if cfg.num_experts:
        raise ValueError(f"{cfg.name}: MoE layers are not ported to "
                         f"repro_torch")
    if cfg.sharding_preset:
        raise ValueError(f"{cfg.name}: sharding preset "
                         f"{cfg.sharding_preset!r} needs a device mesh; "
                         f"repro_torch runs on one card")
    if cfg.frontend != "none":
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} is not "
                         f"ported to repro_torch")
    mod = _FAMILIES[cfg.family]
    return Model(
        cfg=cfg,
        spec=mod.specs(cfg),
        forward=lambda p, b: mod.forward(p, b, cfg),
        prefill=lambda p, b, max_seq=None: mod.prefill(p, b, cfg, max_seq=max_seq),
        decode_step=lambda p, c, t: mod.decode_step(p, c, t, cfg),
        cache_specs=lambda bs, max_seq: mod.cache_specs(cfg, bs, max_seq),
        device=resolve_device(device),
    )
