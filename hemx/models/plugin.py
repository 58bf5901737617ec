"""Model plugin base + registry (reference: hem/models/ModelPlugin.py:4-38,
discovery shared with data plugins via hem/util/data.py:11-35).

A hemx model plugin is constructed as ``Model(args, mesh)`` (the reference's
``__init__(x, args)`` built a TF graph; here construction compiles jitted
steps and records shapes), then:

* ``init_state(rng, sample_batch) -> train_state`` (dict pytree);
* ``train(train_state, stream) -> (train_state, losses)`` — may pull several
  batches from ``stream`` (e.g. WGAN's n_disc_train loop pulls one fresh
  batch per critic step, exactly like the reference's repeated sess.run,
  models/gan.py:158-175);
* ``eval_losses(train_state, batch) -> dict`` for validation/test;
* ``write_summaries(writer, step, train_state, batch)`` host-side.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import Optional

from hemx.utils import terminal as term

_REGISTRY: dict[str, type] = {}
_SCANNED = False
_NON_PLUGIN_MODULES = {"plugin", "common", "networks"}


class ModelPlugin:
    name: str = ""

    #: Input-batch keys this model consumes, or None for all. The training
    #: loop drops unused keys BEFORE host->device transfer, so e.g. the v1
    #: image models never ship depth/location channels over the H2D
    #: link — bandwidth discipline the reference never needed since
    #: its tf.data graph only materialized referenced tensors.
    batch_keys: Optional[tuple] = None

    @staticmethod
    def arguments() -> dict:
        return {}

    def __init__(self, args, mesh):
        self.args = args
        self.mesh = mesh

    def init_state(self, rng, sample_batch) -> dict:
        raise NotImplementedError

    def train(self, train_state, stream):
        raise NotImplementedError

    def eval_losses(self, train_state, batch) -> dict:
        raise NotImplementedError

    def batches_per_train_call(self) -> int:
        """How many batches one ``train()`` call pulls from its stream
        (WGAN/IWGAN: n_disc_train critic batches + 1 generator batch).
        The device-resident pipeline uses this as its assembly group so
        one gather program feeds a whole train call."""
        return 1

    def write_summaries(self, writer, step, train_state, batch) -> None:
        pass

    def capture_activations(self, train_state, batch) -> Optional[dict]:
        """Per-layer activation stats for --summarize_activations (the
        reference's inline per-layer summaries, hem/ops/layers.py:121-131),
        as common.summarizable_stats output. None = unsupported."""
        return None

    def grad_report(self, train_state, batch) -> Optional[dict]:
        """Per-variable gradient stats for --summarize_gradients
        (reference: hem/ops/summaries.py:64-75), as
        common.summarizable_stats output. None = unsupported."""
        return None


def _scan() -> None:
    global _SCANNED
    if _SCANNED:
        return
    import hemx.models as pkg
    for modinfo in pkgutil.iter_modules(pkg.__path__):
        if modinfo.name.startswith("_") or modinfo.name in _NON_PLUGIN_MODULES:
            continue
        try:
            mod = importlib.import_module(f"hemx.models.{modinfo.name}")
        except Exception as e:
            term.message(f"WARNING: failed to import model plugin "
                         f"hemx.models.{modinfo.name}: {e}", term.WARNING)
            continue
        for obj in vars(mod).values():
            if (isinstance(obj, type) and obj is not ModelPlugin
                    and ModelPlugin in obj.__mro__[1:] and obj.name):
                _REGISTRY[obj.name] = obj
    _SCANNED = True


def register(cls: type) -> type:
    _REGISTRY[cls.name] = cls
    return cls


def get_model(name: str) -> Optional[type]:
    _scan()
    return _REGISTRY.get(name)


def available_models() -> list[str]:
    _scan()
    return sorted(_REGISTRY)
