#!/usr/bin/env python
"""hemx training CLI (reference: train.py, paper_train.py).

Examples:
    python train.py --model cnn --dataset mnist --dir workspace/cnn_mnist
    python train.py @examples/iwgan.config --dir workspace/iwgan
    python train.py --model iwgan --dataset synthetic --n_devices 8 ...

Both the v1 flat CLI (train.py) and the v2 plugin CLI (paper_train.py) map to
this entry point; model/dataset plugins contribute their own flags.
"""

from __future__ import annotations

import sys

import jax

import hemx
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
        jax.config.update("jax_debug_nans", True)
    mesh = make_mesh(args.n_devices, model=getattr(args, "model_parallel", 1),
                     spatial=getattr(args, "spatial_parallel", 1))
    axes = " x ".join(f"{k}={v}" for k, v in mesh.shape.items())
    hemx.message(f"Mesh: {mesh.devices.size} device(s) "
                 f"({mesh.devices.flat[0].platform}, {axes})")
    # validate the model name BEFORE the dataset load: with the default
    # dataset (floorplan, no public download) a bad --model would otherwise
    # die in download() instead of exiting 2 with the available list
    model_cls = hemx.get_model(args.model)
    if model_cls is None:
        from hemx.models.plugin import available_models
        hemx.message(f"ERROR: unknown model '{args.model}'. "
                     f"Available: {available_models()}", hemx.ERROR)
        return 2
    splits = hemx.get_dataset_tensors(args)
    model = model_cls(args, mesh)
    try:
        hemx.train(model, splits, args, mesh)
    except FloatingPointError as e:
        # nonzero exit so repeat.sh-style wrappers restart from the last
        # checkpoint (reference: hem/util/training.py:173-175, repeat.sh)
        hemx.message(str(e), hemx.ERROR)
        return 255
    return 0


if __name__ == "__main__":
    sys.exit(main())
