"""Minimal functional module system for hemx.

The reference framework builds TF-1 graphs with variable scopes and ``reuse``
flags (reference: ops/layers.py, hem/ops/layers.py). The functional equivalent
is a pair of pure functions per layer:

* ``init(key, in_shape) -> (params, state, out_shape)`` — allocates parameter
  and state pytrees given the input shape (shape inference replaces the
  reference's explicit ``input_size``/``output_size`` arguments, which we still
  accept for parity and validation);
* ``apply(params, state, x, ctx) -> (y, new_state)`` — the forward pass.
  "Reuse" (e.g. a discriminator applied to both real and fake batches,
  reference: models/gan.py:59-61) is just applying the same params twice.

``Ctx`` carries trace-time call context: training mode, an RNG key that is
split deterministically per consumer, and an optional intermediates capture
dict (the replacement for TF graph collections such as
'conv_layers'/'dense_layers', reference: ops/layers.py:59-60).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Params = Any   # pytree of jnp arrays
State = Any    # pytree of jnp arrays (e.g. batch-norm moving stats)
Shape = Tuple[int, ...]


class Ctx:
    """Per-call context threaded through layer ``apply`` functions.

    Mutable at trace time only; safe under ``jit`` because every layer
    consumes RNG/records intermediates in a deterministic order.
    """

    def __init__(self, training: bool = False, rng: Optional[jax.Array] = None,
                 capture: bool = False):
        self.training = training
        self.rng = rng
        self.capture = capture
        self.intermediates: dict = {}
        # scope stack maintained by composite layers (sequential) so nested
        # records get unique hierarchical names ("encoder/c1" vs "decoder/c1"
        # — the TF variable-scope analog)
        self._scope: list = []

    def next_rng(self) -> jax.Array:
        if self.rng is None:
            raise ValueError("layer requires an RNG key but Ctx.rng is None")
        self.rng, key = jax.random.split(self.rng)
        return key

    def record(self, name: str, value: jax.Array) -> None:
        if self.capture:
            self.intermediates["/".join(self._scope + [name])] = value


@dataclasses.dataclass(frozen=True)
class Layer:
    """A layer: ``init(key, in_shape)`` + ``apply(params, state, x, ctx)``."""

    init: Callable[[jax.Array, Shape], Tuple[Params, State, Shape]]
    apply: Callable[[Params, State, Any, Ctx], Tuple[Any, State]]
    name: str = "layer"

    def __call__(self, params, state, x, ctx: Optional[Ctx] = None):
        if ctx is None:
            ctx = Ctx()
        return self.apply(params, state, x, ctx)


def identity(name: str = "identity") -> Layer:
    def init(key, in_shape):
        return {}, {}, in_shape

    def apply(params, state, x, ctx):
        return x, state

    return Layer(init, apply, name)


def sequential(*layers: Layer, name: str = "sequential") -> Layer:
    """Compose layers in order. Params/state are dicts keyed by layer name.

    Duplicate layer names get an ``_N`` suffix so all params stay addressable
    (mirrors TF's automatic scope uniquing).
    """
    names = _unique_names(layers)

    def init(key, in_shape):
        params, state = {}, {}
        shape = in_shape
        keys = jax.random.split(key, max(len(layers), 1))
        for k, n, layer in zip(keys, names, layers):
            p, s, shape = layer.init(k, shape)
            params[n] = p
            state[n] = s
        return params, state, shape

    def apply(params, state, x, ctx):
        new_state = dict(state)
        for n, layer in zip(names, layers):
            ctx._scope.append(n)   # inner records land under "<n>/..."
            x, new_state[n] = layer.apply(params[n], state[n], x, ctx)
            ctx._scope.pop()
            ctx.record(n, x)
        return x, new_state

    return Layer(init, apply, name)


def _unique_names(layers: Sequence[Layer]) -> list[str]:
    """Stable per-child keys: duplicate layer names get an ``_N`` suffix
    (mirrors TF's automatic scope uniquing), and a generated suffix that
    would shadow a later explicit name (``name='d_1'`` after two ``'d'``
    layers) keeps bumping until free."""
    names: list[str] = []
    used = {l.name for l in layers}
    counts: dict[str, int] = {}
    for l in layers:
        n = l.name
        if n in counts:
            k = counts[n]
            candidate = f"{n}_{k + 1}"
            while candidate in used:
                k += 1
                candidate = f"{n}_{k + 1}"
            counts[n] = k + 1
            n = candidate
        else:
            counts[l.name] = 0
        used.add(n)
        names.append(n)
    return names


def parallel_sum(*layers: Layer, name: str = "parallel_sum") -> Layer:
    """Apply layers to the same input and sum outputs (residual shortcuts)."""
    names = _unique_names(layers)

    def init(key, in_shape):
        params, state = {}, {}
        out_shape = None
        keys = jax.random.split(key, max(len(layers), 1))
        for k, n, layer in zip(keys, names, layers):
            p, s, shape = layer.init(k, in_shape)
            params[n] = p
            state[n] = s
            out_shape = shape
        return params, state, out_shape

    def apply(params, state, x, ctx):
        new_state = dict(state)
        total = None
        for n, layer in zip(names, layers):
            y, new_state[n] = layer.apply(params[n], state[n], x, ctx)
            total = y if total is None else total + y
        return total, new_state

    return Layer(init, apply, name)


def param_count(params: Params) -> int:
    return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))


def tree_bytes(params: Params) -> int:
    return sum(int(p.size) * p.dtype.itemsize
               for p in jax.tree_util.tree_leaves(params))
