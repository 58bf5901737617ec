#!/usr/bin/env python
"""v2 training entry with dataset mean-image statistics
(reference: paper_train.py).

Beyond train.py this computes the dataset's mean and variance depth images
over the full train+validate splits before training (paper_train.py:43-60),
saves them as PNGs in the workspace, and provides the mean image to models
that use it as a metrics baseline (the reference fed a
mean_image_placeholder into every summary run; hemx models read
``model.mean_image``)."""

from __future__ import annotations

import os
import sys

import numpy as np

import hemx
from hemx.ops.images import crop_to_bounding_box
from hemx.parallel.mesh import make_mesh
from hemx.summaries.montage import to_uint8
from hemx.summaries.png import encode_png
from hemx.utils.misc import enable_compile_cache


def dataset_depth_moments(splits, args, crop: bool = True):
    """Mean/variance depth images over train+validate
    (paper_train.py:43-60; crop matches the 29x29 paper models)."""
    total = None
    total_sq = None
    count = 0
    for name in ("train", "validate"):
        if name not in splits:
            continue
        for batch in splits[name].iter_epoch(args.batch_size, shuffle=False):
            if "depth" not in batch:  # image-only dataset: no depth stats
                return None, None
            d = batch["depth"]
            # uint8-shipping pipelines normalize on-device; these host-side
            # moments must normalize (and widen — (d**2) wraps mod 256 in
            # uint8) themselves
            if d.dtype == np.uint8:
                d = d.astype(np.float32) / 255.0
            else:
                d = d.astype(np.float64)
            if crop and d.shape[1] >= 46:
                d = np.asarray(crop_to_bounding_box(d, 17, 17, 29, 29))
            s = d.sum(axis=0)
            sq = (d ** 2).sum(axis=0)
            total = s if total is None else total + s
            total_sq = sq if total_sq is None else total_sq + sq
            count += d.shape[0]
    if count == 0:
        return None, None
    mean = total / count
    var = total_sq / count - mean ** 2
    return mean[..., 0], np.maximum(var[..., 0], 0.0)


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
    mesh = make_mesh(args.n_devices)
    # model check before the dataset load (same reasoning as train.py:
    # the default dataset has no public download, so a bad --model would
    # die in download() instead of exiting 2 with the available list)
    model_cls = hemx.get_model(args.model)
    if model_cls is None:
        from hemx.models.plugin import available_models
        hemx.message(f"ERROR: unknown model '{args.model}'. "
                     f"Available: {available_models()}", hemx.ERROR)
        return 2
    splits = hemx.get_dataset_tensors(args)
    model = model_cls(args, mesh)

    hemx.init_working_dir(args)
    hemx.message("Computing dataset depth statistics...")
    mean_img, var_img = dataset_depth_moments(splits, args)
    if mean_img is not None:
        with open(os.path.join(args.dir, "mean_image.png"), "wb") as f:
            f.write(encode_png(to_uint8(mean_img)))
        with open(os.path.join(args.dir, "var_image.png"), "wb") as f:
            rng = var_img.max() - var_img.min()
            f.write(encode_png(to_uint8((var_img - var_img.min())
                                        / max(rng, 1e-12))))
        np.save(os.path.join(args.dir, "mean_image.npy"), mean_img)
        if hasattr(model, "mean_image"):
            model.mean_image = mean_img.astype(np.float32)

    try:
        hemx.train(model, splits, args, mesh)
    except FloatingPointError as e:
        hemx.message(str(e), hemx.ERROR)
        return 255
    return 0


if __name__ == "__main__":
    sys.exit(main())
