"""Device mesh construction and sharding helpers.

The replacement for the reference's in-graph GPU towers
(reference: hem/util/scoping.py:66-89 tower_scope_range,
hem/util/training.py:23-56 average_gradients, hem/ops/input.py batch_slice):

* a ``data`` mesh axis over local (or all, multi-host) devices;
* the global batch is sharded over ``data``; params/opt-state are replicated
  over it; gradient reduction is whatever XLA inserts for the mean-loss grad
  over the sharded batch — a device-to-device all-reduce, not a host round
  trip;
* an optional second ``model`` axis (``--model_parallel N``) tensor-shards
  every conv/dense kernel's LAST dim (and its optimizer moments) over ``N``
  devices — output channels for conv HWIO / dense [in, out] kernels, input
  channels for deconv kernels (which use the TF conv2d_transpose
  [H, W, out, in] layout — CLAUDE.md) — GSPMD then partitions the conv work
  and activations channel-wise and inserts the boundary collectives. The
  reference has no analogue (its scaling story stops at 2-GPU towers); this
  is the scaling dimension for models whose params/activations outgrow one
  device's memory.
* an optional ``spatial`` axis (``--spatial_parallel N``) shards every image
  tensor's HEIGHT dim over ``N`` devices: params stay replicated across it,
  activations flow through the network spatially partitioned, and GSPMD
  inserts the conv halo exchanges (collective-permutes of the kernel-overlap
  rows). This is the sharded form of the reference's spatial decomposition
  (its host-side patch fan-out, paper_fullimage.py:302-316, splits scenes
  into 65x65 patches because one GPU can't hold the scene; spatial sharding
  instead keeps ONE image's activations distributed across devices) — the
  scaling dimension for images too large for one device's memory.

Multi-host: ``initialize_distributed`` wires jax.distributed so the same mesh
spans slices over DCN (the reference was single-process; this is the rebuild's
§2.8 communication-backend component).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op single-process)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(n_devices: int = 0, devices=None, model: int = 1,
              spatial: int = 1) -> Mesh:
    """Mesh over ``n_devices`` (0 = all available).

    Defaults to a 1-D data-parallel mesh, axes ``("data",)``. ``model=m>1``
    or ``spatial=s>1`` adds that axis as the inner mesh dim: batch rows
    shard over ``data``, image height over ``spatial``, kernel output
    channels over ``model`` (see module docstring). The inner axis takes
    consecutive devices (``model``'s per-layer channel collectives and
    ``spatial``'s halo exchanges fire far more often than ``data``'s one
    gradient all-reduce per step); on an all-to-all NVLink host every pair
    of devices is equally close, so the order costs nothing there.

    ``spatial`` and ``model`` are mutually exclusive: with both axes on one
    mesh, XLA's SPMD partitioner emits numerically WRONG conv weight
    gradients for every model family except plain supervised CNNs
    (measured on jax 0.8.x: cnn exact to 2e-5, vae/gan/wgan/iwgan first-
    order d-grads off by O(1) — the partitioner's "involuntary full
    rematerialization" path mis-accumulates kernel grads when channel- and
    height-sharding compose in one backward pass; Shardy does not fix it).
    Each axis is individually proven exact against single-device runs
    (tests/test_models.py::TestModelParallel / TestSpatialParallel), so the
    combination is rejected loudly here rather than silently corrupting
    training.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_devices and n_devices > 0:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available")
        devs = devs[:n_devices]
    model = max(int(model), 1)
    spatial = max(int(spatial), 1)
    if model > 1 and spatial > 1:
        raise ValueError(
            "--spatial_parallel and --model_parallel cannot be combined: "
            "XLA's SPMD partitioner produces wrong conv weight gradients "
            "when channel- and height-sharding compose in one backward "
            "pass (see make_mesh docstring). Use one axis with data "
            "parallelism instead.")
    if model * spatial == 1:
        return Mesh(np.array(devs), (DATA_AXIS,))
    if len(devs) % (model * spatial):
        asked = " x ".join(f"--{n} {v}" for n, v in
                           (("spatial_parallel", spatial),
                            ("model_parallel", model)) if v > 1)
        raise ValueError(f"{asked} does not divide {len(devs)} device(s)")
    shape = [len(devs) // (model * spatial), spatial, model]
    names = [DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS]
    keep = [i for i, s in enumerate(shape) if s > 1 or i == 0]
    grid = np.array(devs).reshape([shape[i] for i in keep])
    return Mesh(grid, tuple(names[i] for i in keep))


def model_axis_size(mesh: Mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def spatial_axis_size(mesh: Mesh) -> int:
    return mesh.shape.get(SPATIAL_AXIS, 1)


def data_axis_size(mesh: Mesh) -> int:
    """Batch-sharding degree: ``--batch_size`` is per data-shard, so the
    global batch is ``batch_size * data_axis_size`` (== device count on a
    pure-DP mesh; devices on the 'model' axis share one batch shard)."""
    return mesh.shape.get(DATA_AXIS, mesh.size)


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding (axis 0 over 'data'; replicated over the other
    axes). Rank-agnostic — for index slices and non-image leaves; image
    batches on a spatial mesh use :func:`batch_spec`."""
    return NamedSharding(mesh, P(DATA_AXIS))


def batch_spec(shape, spatial: int) -> P:
    """PartitionSpec for one batch leaf: axis 0 (rows) over 'data'; on a
    spatial mesh, axis 1 (image height, NHWC) of rank-3/4 leaves whose H
    divides ``spatial`` additionally shards over 'spatial'. Labels, latents
    and other low-rank leaves shard over 'data' only."""
    if (spatial > 1 and len(shape) >= 3 and shape[1] >= spatial
            and shape[1] % spatial == 0):
        return P(DATA_AXIS, SPATIAL_AXIS)
    return P(DATA_AXIS)


def batch_shardings(mesh: Mesh, tree):
    """Pytree of per-leaf NamedShardings for a host or device batch
    (rank-aware — see :func:`batch_spec`)."""
    s = spatial_axis_size(mesh)
    return jax.tree_util.tree_map(
        lambda x: NamedSharding(mesh, batch_spec(np.shape(x), s)), tree)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_spec(shape, model: int) -> P:
    """Tensor-parallel PartitionSpec for one train-state leaf.

    Kernels (ndim >= 2) shard their LAST dim over ``model`` when divisible —
    the output-channel dim for conv HWIO and dense [in, out] kernels, the
    INPUT-channel dim for deconv kernels (TF conv2d_transpose [H, W, out, in]
    layout); their optimizer moments (same shapes) follow the same rule.
    Everything else (biases, BN scale/stats, scalars, rng keys) replicates:
    they are O(C) or O(1), and GSPMD re-slices them against the sharded
    channel dim for free.
    """
    if (model > 1 and len(shape) >= 2 and shape[-1] >= model
            and shape[-1] % model == 0):
        return P(*([None] * (len(shape) - 1)), MODEL_AXIS)
    return P()


def state_shardings(mesh: Mesh, tree):
    """Pytree of NamedShardings for a train state: DP meshes replicate
    everything; a mesh with a 'model' axis applies :func:`param_spec`."""
    m = model_axis_size(mesh)
    return jax.tree_util.tree_map(
        lambda x: NamedSharding(mesh, param_spec(np.shape(x), m)), tree)
