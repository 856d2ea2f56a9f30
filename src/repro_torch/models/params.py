"""Parameter specs: shapes + logical axes -> initialised tensors.

Port of ``repro/models/params.py:21-54,94``.  A model module builds a
nested dict of :class:`Spec`; :func:`init_params` draws it with JAX's
distributions, :func:`params_from_numpy` carries a JAX parameter tree
(as numpy arrays) across in the same nested layout, and
:func:`count_params` counts it.  The logical axes are kept as data (they
name the mesh axes of the JAX package's sharding rules, which a single
card does not have).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names per dim
    dtype: Any = torch.float32
    init: str = "fan_in"                   # fan_in | zeros | ones | normal
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"Spec: shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _init_one(spec: Spec, generator: torch.Generator, device
              ) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        s = spec.scale if spec.scale is not None else 0.02
    else:  # fan_in: the leading dim, as in JAX (L for stacked layer weights)
        fan = spec.shape[0] if spec.shape else 1
        s = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * s).to(spec.dtype)


def init_params(tree, generator: torch.Generator, device):
    """Tensors for every :class:`Spec` of ``tree`` on ``device`` (where
    ``generator`` must live): zeros/ones, or N(0, 1) times the spec's
    scale (default 0.02 for ``normal``, 1/sqrt(shape[0]) for ``fan_in``),
    drawn in f32 and cast to the spec's dtype.  torch draws other numbers
    than ``jax.random``; the distributions are JAX's."""
    return tree_map(
        lambda s: _init_one(s, generator, device) if is_spec(s) else s, tree)


def params_from_numpy(tree, device):
    """A parameter tree of numpy arrays (``jax.tree.map(np.asarray,
    params)`` of the JAX package) as torch tensors on ``device``
    (copies), in the same nested layout and dtypes."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def count_params(tree) -> int:
    return int(sum(math.prod(s.shape) for s in _leaves(tree)))
