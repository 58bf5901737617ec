"""Shared training-state machinery for model plugins.

Train state is a plain dict pytree (checkpointed leaf by leaf):
  {"params": {...}, "mstate": {...}, "opt": {...}, "step": int32, "rng": key}

``step`` increments once per train() call — v2 reference semantics (one
step = one model.train call, SURVEY.md §7.3): GAN critic substeps keep the
counter constant and only the generator apply bumps it (hemx/models/
gan.py:282,319), so summary cadences line up across model families.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from hemx.core import Ctx


def new_train_state(params, mstate, opt_states, seed: int, mesh=None) -> dict:
    ts = {
        "params": params,
        "mstate": mstate,
        "opt": opt_states,
        "step": jnp.zeros((), jnp.int32),
        "rng": jax.random.PRNGKey(seed),
    }
    if mesh is not None:
        # Place onto the mesh NOW so the first jitted step sees the same
        # sharding signature as steady-state calls. Without this, step
        # outputs (NamedSharding) differ from init arrays (SingleDevice
        # sharding) and the second call triggers a full recompile.
        # DP mesh: everything replicated. Mesh with a 'model' axis: kernels
        # (and their optimizer moments) shard output channels over it.
        from hemx.parallel.mesh import state_shardings
        ts = jax.device_put(ts, state_shardings(mesh, ts))
    return ts


def pin_batch_sharding(x, mesh, spatial: bool = True):
    """Constrain an on-device batch tensor's sharding on a spatial mesh.
    No-op on meshes without a 'spatial' axis (leaves DP/TP programs
    untouched bit-for-bit).

    ``spatial=True``: the canonical batch layout — rows over 'data', image
    height over 'spatial' (hemx.parallel.mesh.batch_spec).
    ``spatial=False``: rows over 'data' only (spatially replicated) — forces
    the consuming subprogram to run data-parallel.

    Why this exists: on a spatial mesh, generated images (G(z)) are born
    with whatever sharding GSPMD propagated from the replicated latent,
    while real inputs arrive (data, spatial)-sharded. When one grad closure
    feeds BOTH through the same conv weights, XLA's SPMD partitioner
    accumulates the two differently-sharded kernel-grad contributions
    through its "involuntary full rematerialization" path and produces
    WRONG gradients (measured: |dW| off by O(1) while the loss matches to
    1e-6; pinning the fake batch to the input layout makes sp ==
    single-device to f32 noise). The ``spatial=False`` form is the
    workaround for the second partitioner defect: reverse-over-reverse conv
    programs (the IWGAN gradient-penalty double-backprop) mis-partition
    under spatial sharding regardless of input layout, so the GP sub-term
    is pinned to the proven-exact data-parallel layout instead
    (tests/test_models.py::TestSpatialParallel covers both).
    """
    if mesh is None or not hasattr(x, "shape"):
        return x
    from hemx.parallel.mesh import DATA_AXIS, batch_spec, spatial_axis_size
    from jax.sharding import NamedSharding, PartitionSpec
    s = spatial_axis_size(mesh)
    if s <= 1:
        return x
    spec = (batch_spec(x.shape, s) if spatial
            else PartitionSpec(DATA_AXIS))
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def pin_replicated(tree, mesh):
    """Constrain every leaf of a pytree to fully-replicated sharding.
    Used on cross-program handoff values (e.g. the spatial-mesh IWGAN
    split-step's gradient trees): the producing program would otherwise
    emit GSPMD-chosen shardings (e.g. bias grads P('model')) that the
    consuming program's explicit in_shardings reject."""
    if mesh is None:
        return tree
    from jax.sharding import NamedSharding, PartitionSpec
    sh = NamedSharding(mesh, PartitionSpec())
    return jax.tree_util.tree_map(
        lambda x: jax.lax.with_sharding_constraint(x, sh), tree)


def step_rng(ts: dict) -> jax.Array:
    """Per-step key: fold the step counter into the state's base key.

    READ-ONLY paths (eval, predict, summaries) use this. Optimizer-applying
    steps must use :func:`split_step_rng` instead so consecutive sub-steps at
    a fixed ``step`` (the WGAN/IWGAN critic loop, artist/info_gan sub-phases)
    draw fresh randomness — the reference re-sampled ``tf.random_normal`` /
    ``tf.random_uniform`` on every ``sess.run`` (models/gan.py:57-58,221-222).
    """
    return jax.random.fold_in(ts["rng"], ts["step"])


def split_step_rng(ts: dict):
    """(sub_key, advanced_base) for an optimizer-applying sub-step.

    The caller threads ``advanced_base`` back into ``new_ts["rng"]`` so every
    optimizer apply — including critic-loop iterations that do NOT advance the
    step counter — consumes distinct randomness. Without this, all
    ``n_disc_train`` critic steps in one train() call would reuse one z (same
    fake batch) and one gradient-penalty alpha, silently changing WGAN/IWGAN
    dynamics vs the reference's per-sess.run sampling (models/gan.py:158-175).
    """
    sub, new_base = jax.random.split(jax.random.fold_in(ts["rng"], ts["step"]))
    return sub, new_base


def grad_finite_report(grads) -> dict:
    """Per-parameter finite-ness flags, named by tree path
    (the --check_numerics rebuild; reference: hem/util/training.py:52-53)."""
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    report = {}
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        report[name] = jnp.all(jnp.isfinite(leaf))
    return report


def raise_on_bad_grads(metrics: dict) -> None:
    """Host-side check of grad_finite_report output (loop calls this when
    --check_numerics). Raises with the offending parameter named, matching the
    reference's located-crash UX (doc/gradient_errors.txt)."""
    flags = metrics.get("grad_finite")
    if flags is None:
        return
    bad = [name for name, ok in flags.items() if not bool(ok)]
    if bad:
        raise FloatingPointError(
            "GRADIENT ERROR (NaN/Inf) on parameter(s): " + ", ".join(sorted(bad)))


def grad_norm(grads):
    """Global L2 norm of a gradient pytree — the cheap always-on gradient
    observability scalar (the reference logged per-variable gradient means,
    hem/ops/summaries.py:64-75; one global norm costs one scalar)."""
    import optax
    return optax.global_norm(grads)


def summarizable_stats(tree, max_sample: int = 65536) -> dict:
    """Per-leaf summary stats for --summarize_activations/--summarize_gradients
    (reference per-layer vocabulary: hem/ops/layers.py:121-131 scalar mean +
    histogram per layer output; hem/ops/summaries.py:13-42 zero-fraction;
    :64-75 per-variable gradient histograms).

    Device-side: runs INSIDE the capture jit so only a scalar mean,
    zero-fraction, and a bounded flat sample per leaf cross the D2H link —
    never the full activation/gradient tensors. The host builds the
    TF-bucketed HistogramProto from the sample.
    """
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        v = leaf.reshape(-1).astype(jnp.float32)
        out[name] = {
            "mean": jnp.mean(v),
            "zero_fraction": jnp.mean((v == 0.0).astype(jnp.float32)),
            "sample": v[:max_sample],
        }
    return out


def write_stat_summaries(writer, step: int, stats: dict, prefix: str) -> None:
    """Write summarizable_stats output under the reference tag taxonomy."""
    for name, s in stats.items():
        writer.scalar(f"{prefix}/{name}/mean",
                      float(jax.device_get(s["mean"])), step)
        writer.scalar(f"{prefix}/{name}/zero_fraction",
                      float(jax.device_get(s["zero_fraction"])), step)
        writer.histogram(f"{prefix}/{name}",
                         np.asarray(jax.device_get(s["sample"])), step)


def apply_updates_group(optimizer: optax.GradientTransformation, grads,
                        opt_state, params):
    updates, new_opt = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), new_opt


def host_scalars(metrics: dict) -> dict:
    """Pull scalar metrics to host floats in ONE device_get round trip.

    The transfer synchronizes with the step that produced the metrics, so
    callers control pipelining by choosing how often to call this (the
    training loop fetches at an interval unless --check_numerics needs
    per-step values).
    """
    host = jax.device_get(metrics)
    out = {}
    for k, v in host.items():
        if k == "grad_finite":
            out[k] = {n: bool(f) for n, f in v.items()}
        else:
            out[k] = float(v)
    return out


def unflatten(h: int, w: int, c: int):
    """Reshape (B, H*W*C) -> (B, h, w, c) as a Layer (decoder seeds)."""
    from hemx.core import Layer

    def init(key, in_shape):
        return {}, {}, (in_shape[0], h, w, c)

    def apply(params, state, x, ctx):
        return x.reshape(x.shape[0], h, w, c), state

    return Layer(init, apply, "unflatten")


def cast_inputs(x, dtype_name: str):
    if dtype_name == "bfloat16":
        return jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a,
            x)
    return x
