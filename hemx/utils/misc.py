"""Misc utilities (reference: hem/util/misc.py, util.py).

The TF-graph-specific helpers (collection_to_dict, add_to_collection) have
no equivalent here — metrics travel as plain dicts. What remains:
``chunks`` (hem/util/misc.py chunks), ``fold`` batched evaluation
(util.py:339-350), ``visualize_parameters`` (hem/util/debug.py), and
``enable_compile_cache`` for the command-line entry points."""

from __future__ import annotations

import os

import numpy as np
import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep XLA's compiled programs on disk across processes; returns the
    cache directory in use.

    Called by the command-line entry points only (library import and the
    tests leave JAX's config alone). When ``JAX_COMPILATION_CACHE_DIR`` is
    set, JAX reads it itself and nothing is set here. Otherwise the cache is
    ``.jax_cache/`` at the checkout root: a fixed path, so each run finds
    what the runs before it compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def chunks(lst, n: int):
    """Yield successive n-sized chunks (reference: hem/util/misc.py)."""
    for i in range(0, len(lst), n):
        yield lst[i:i + n]


def fold(fn, arrays, batch_size: int):
    """Apply ``fn`` over ``arrays`` in batches and average scalar results
    (reference: util.py:339-350 'fold' batched eval). ``arrays`` is a dict of
    equal-length numpy arrays; ``fn(batch_dict) -> float``."""
    n = len(next(iter(arrays.values())))
    if n < batch_size:
        raise ValueError(
            f"fold: {n} rows is smaller than one batch ({batch_size}) — "
            f"averaging zero batches would silently report 0.0")
    total = 0.0
    count = 0
    # drop-remainder batching, like the reference's fixed num_batches loop
    # (util.py:339-350) and the pipeline's batches_per_epoch
    for i in range(0, n - batch_size + 1, batch_size):
        batch = {k: v[i:i + batch_size] for k, v in arrays.items()}
        total += float(fn(batch))
        count += 1
    return total / count


def visualize_parameters(params) -> str:
    """Human-readable parameter table with totals
    (reference: hem/util/debug.py visualize_parameters)."""
    rows = []
    total = 0
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        size = int(np.prod(leaf.shape)) if leaf.shape else 1
        total += size
        rows.append(f"{name:<60s} {str(tuple(leaf.shape)):<20s} {size:>12,d}")
    rows.append("-" * 94)
    rows.append(f"{'total':<60s} {'':<20s} {total:>12,d}")
    return "\n".join(rows)
