"""Architecture registry: the configurations ported so far (own copies of
``repro/configs/<arch>.py``).

``get(arch_id)`` -> full ModelConfig; ``get_smoke(arch_id)`` -> the
reduced one.  The other architecture ids of the JAX registry raise.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("qwen1.5-0.5b",)


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise ValueError(f"architecture {arch_id!r} is not ported to "
                         f"repro_torch (ported: {', '.join(ARCHS)})")
    return importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
