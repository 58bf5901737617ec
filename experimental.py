#!/usr/bin/env python
"""Multi-model composed training (reference: experimental.py).

Phase 1: train a mean_depth_estimator for --estimator_epochs (ref: 30).
Phase 2: freeze it and train an experimental_sampler for --epochs with the
estimator's per-image mean-depth prediction as a conditioning channel
(args mutated between phases exactly like the reference: experimental.py:39-59).
"""

from __future__ import annotations

import copy
import sys

import jax

import hemx
from hemx.models.plugin import get_model
from hemx.parallel.mesh import make_mesh
from hemx.utils.misc import enable_compile_cache


def main(argv=None) -> int:
    args = hemx.parse_args(argv, display=True)
    enable_compile_cache()
    from hemx.ops.layers import (set_compute_dtype, set_deconv_impl,
                                 set_default_precision)
    set_default_precision(getattr(args, "precision", "default"))
    set_compute_dtype(getattr(args, "dtype", None))
    set_deconv_impl(getattr(args, "deconv_impl", "dilated"))
    if getattr(args, "debug_nans", False):
        import jax
        jax.config.update("jax_debug_nans", True)
    hemx.init_working_dir(args)
    mesh = make_mesh(args.n_devices)
    splits = hemx.get_dataset_tensors(args)

    hemx.message("Phase 1: training mean_depth_estimator...")
    est_args = copy.copy(args)
    est_args.epochs = str(getattr(args, "estimator_epochs", 30))
    est_args.dir = args.dir + "/estimator"
    estimator = get_model("mean_depth_estimator")(est_args, mesh)
    est_result = hemx.train(estimator, splits, est_args, mesh)

    hemx.message("Phase 2: training experimental_sampler (composed)...")
    sampler_args = copy.copy(args)
    sampler_args.lr = 1e-4                       # experimental.py:58
    sampler_args.dir = args.dir + "/sampler"
    sampler = get_model("experimental_sampler")(sampler_args, mesh)
    sampler.set_estimator(estimator, est_result["train_state"])
    hemx.train(sampler, splits, sampler_args, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
