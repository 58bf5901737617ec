"""Data-parallel step wrapping.

``jit_step`` compiles a pure train step with the batch sharded over the mesh's
``data`` axis and everything else replicated. XLA inserts the gradient
all-reduce (scaling-book recipe: annotate shardings, let the compiler
place collectives). This replaces the reference's tower loop + CPU gradient
averaging (hem/util/training.py:23-56) with zero host involvement.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hemx.parallel.mesh import DATA_AXIS, data_sharding, replicated_sharding


def host_slice(batch, *, process_index=None, process_count=None):
    """Slice a GLOBAL host batch down to this process's portion.

    Multi-host data feeding (replaces the reference's batch_slice per-GPU
    slicing, hem/ops/input.py:10-26, at the host level): every process
    iterates the same seeded global order, keeps rows
    [pi*per : (pi+1)*per], and shard_batch assembles the global array from
    the local shards.
    """
    pc = jax.process_count() if process_count is None else process_count
    if pc == 1:
        return batch
    pi = jax.process_index() if process_index is None else process_index

    def sl(x):
        if x.shape[0] % pc:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by "
                f"{pc} processes — the remainder rows would silently "
                f"belong to no process")
        per = x.shape[0] // pc
        return x[pi * per:(pi + 1) * per]

    return jax.tree_util.tree_map(sl, batch)


def shard_batch(batch, mesh: Mesh):
    """Place a host (numpy) batch onto the mesh, sharded on axis 0 over
    'data' (and, on a spatial mesh, image height over 'spatial' —
    hemx.parallel.mesh.batch_spec).

    Single-host: a device_put of the global batch with the batch sharding.
    Multi-host: the GLOBAL batch is host-sliced to this process's portion
    and assembled via jax.make_array_from_process_local_data.
    """
    from hemx.parallel.mesh import batch_shardings

    shardings = batch_shardings(mesh, batch)
    if jax.process_count() > 1:
        local = host_slice(batch)
        return jax.tree_util.tree_map(
            lambda x, s: jax.make_array_from_process_local_data(
                s, np.asarray(x)),
            local, shardings)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), batch, shardings)


def jit_step(step_fn: Callable, mesh: Mesh, *, batch_argnums=(1,),
             donate_argnums=(0,), static_argnums=()) -> Callable:
    """jit ``step_fn(train_state, batch, ...)`` with mesh shardings.

    The train_state (argument 0) is donated (in-place update on device) and
    sharded by the mesh's rule — fully replicated on a DP mesh; kernel
    output channels over the 'model' axis on a tensor-parallel mesh
    (hemx.parallel.mesh.state_shardings). Batch arguments are sharded on
    their leading axis over 'data'. Outputs are left to XLA.
    """
    from hemx.parallel.mesh import (batch_shardings, model_axis_size,
                                    spatial_axis_size, state_shardings)

    repl = replicated_sharding(mesh)
    data = data_sharding(mesh)
    tp = model_axis_size(mesh) > 1
    sp = spatial_axis_size(mesh) > 1
    # tp/sp meshes need per-leaf sharding trees (kernel channels over
    # 'model'; image H over 'spatial'), which depend on the actual arg
    # shapes — build them per call and memoize on treedef+shapes (a
    # handful of model variants per process, the cache stays tiny).
    structured = tp or sp

    # cache the jitted function per call signature to avoid re-wrapping.
    _cache: dict = {}

    def _key_of(tree):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return treedef, tuple(np.shape(l) for l in leaves)

    def _jitted(args):
        n_args = len(args)
        if not structured:
            key: tuple = (n_args,)
            fn = _cache.get(key)
            if fn is None:
                in_shardings = tuple(data if i in batch_argnums else repl
                                     for i in range(n_args))
                fn = _cache[key] = jax.jit(step_fn,
                                           in_shardings=in_shardings,
                                           donate_argnums=donate_argnums,
                                           static_argnums=static_argnums)
            return fn

        has_state = 0 not in batch_argnums
        key = (n_args,
               _key_of(args[0]) if has_state else None,
               tuple(_key_of(args[i]) for i in batch_argnums if i < n_args))
        fn = _cache.get(key)
        if fn is not None:
            return fn
        in_shardings = [repl] * n_args
        for i in batch_argnums:
            if i < n_args:
                in_shardings[i] = batch_shardings(mesh, args[i])
        kwargs = {}
        if has_state:
            shards = state_shardings(mesh, args[0])
            in_shardings[0] = shards
            if 0 in donate_argnums:
                # Donating steps return (new_state, metrics) by framework
                # convention (ModelPlugin docstring). Pin the new state's
                # out_shardings to the SAME rule tree: otherwise GSPMD may
                # propagate e.g. P('model') onto a bias output, and the
                # next call's donated input then mismatches in_shardings
                # (donated args cannot be auto-resharded).
                kwargs["out_shardings"] = (shards, repl)
        fn = _cache[key] = jax.jit(step_fn,
                                   in_shardings=tuple(in_shardings),
                                   donate_argnums=donate_argnums,
                                   static_argnums=static_argnums,
                                   **kwargs)
        return fn

    def call(*args):
        return _jitted(args)(*args)

    return call
