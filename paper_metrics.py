#!/usr/bin/env python
"""Post-hoc Eigen-metric evaluation over full splits
(reference: paper_metrics.py).

Rebuilds the model from the run's options.json, restores a chosen checkpoint
(default: the reference's checkpoint-50, falling back to the latest), and
computes the Eigen et al. depth suite averaged over each split for:
* ``y_hat``  — the model's prediction,
* ``y_0``    — zero-residual baseline (the per-image mean only),
* ``y_mean`` — the dataset mean-depth image baseline
(reference: paper_metrics.py:115-163). Writes mean-depth PNGs and a JSON
report into <dir>/metrics/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

import jax

import hemx
from hemx.config import load_options
from hemx.metrics.eigen import EigenAccumulator, eigen_metrics
from hemx.models.plugin import get_model
from hemx.data.pipeline import make_place
from hemx.parallel.mesh import make_mesh
from hemx.summaries.montage import to_uint8
from hemx.summaries.png import encode_png
from hemx.train.checkpoint import CheckpointManager
from hemx.utils.misc import enable_compile_cache


def evaluate_split(model, ts, split, args, mesh, mean_image=None,
                   max_batches: int | None = None) -> dict:
    gb = args.batch_size * mesh.devices.size
    place = make_place(mesh, split)
    accs = {"y_hat": EigenAccumulator(), "y_0": EigenAccumulator()}
    if mean_image is not None:
        accs["y_mean"] = EigenAccumulator()
    # map predictions/targets back to [0,1] depth units via the model's
    # declared range — for the paper models (0,10) this is exactly the
    # reference's /10 (paper_metrics.py:13-15), and non-meter models
    # ([-1,1]/[0,1]) scale correctly instead of collapsing under a
    # hardcoded /10
    lo, hi = (model.depth_range() if hasattr(model, "depth_range")
              else (0.0, 1.0))
    scale = lambda v: (np.asarray(v) - lo) / (hi - lo)
    version = getattr(args, "model_version", None)
    n = 0
    for batch in split.iter_epoch(gb, shuffle=False):
        g, prep = model._jit_predict(ts, place(batch))
        # ONE device_get per batch: each get synchronizes with the device
        g_host, y_host = jax.device_get((g, prep["y"]))
        y = scale(y_host)
        y_hat = scale(g_host)
        y_bar = y.mean(axis=(1, 2, 3), keepdims=True)
        # y_0 baseline: zeros for model_version 'baseline' (reference feeds
        # a zero image: y_0 = g_0 = 0, paper_metrics.py:106-111), the
        # per-image mean for the mean_* versions (y_0 = 0 + y_bar)
        y0 = (np.zeros_like(y) if version == "baseline"
              else np.broadcast_to(y_bar, y.shape))
        variants = {"y_hat": y_hat, "y_0": y0}
        if mean_image is not None:
            variants["y_mean"] = np.broadcast_to(
                mean_image[None, :, :, None], y.shape)
        for name, pred in variants.items():
            m = eigen_metrics(np.clip(y, 1e-3, None),
                              np.clip(pred, 1e-3, None))
            accs[name].update({k: float(v) for k, v in m.items()})
        n += 1
        if max_batches and n >= max_batches:
            break
    return {name: acc.result() for name, acc in accs.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="hemx Eigen metric evaluation")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--checkpoint", type=int, default=50,
                        help="Epoch checkpoint to evaluate (reference used "
                             "checkpoint-50); falls back to latest.")
    parser.add_argument("--splits", nargs="*",
                        default=["train", "validate", "test"])
    parser.add_argument("--max_batches", type=int, default=0)
    a = parser.parse_args(argv)
    enable_compile_cache()

    opts = load_options(os.path.join(a.dir, "options.json"))
    args = types.SimpleNamespace(**opts)
    args.dir = a.dir
    mesh = make_mesh(getattr(args, "n_devices", 1) or 1)
    splits = hemx.get_dataset_tensors(args)
    model = get_model(args.model)(args, mesh)
    gb = args.batch_size * mesh.devices.size
    host_batch = next(splits["train"].iter_epoch(gb, shuffle=False))
    ts = model.init_state(jax.random.PRNGKey(args.seed), host_batch)
    mgr = CheckpointManager(a.dir)
    by_epoch = dict(mgr.checkpoints())
    path = by_epoch.get(a.checkpoint) or mgr.latest()
    wrapper = mgr.restore({"train_state": ts, "epoch": np.int64(0)}, path)
    ts = wrapper["train_state"]
    hemx.message(f"Evaluating {path}")

    mean_path = os.path.join(a.dir, "mean_image.npy")
    mean_image = np.load(mean_path) if os.path.exists(mean_path) else None

    out_dir = os.path.join(a.dir, "metrics")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    for split_name in a.splits:
        if split_name not in splits:
            continue
        hemx.message(f"split: {split_name}")
        report[split_name] = evaluate_split(
            model, ts, splits[split_name], args, mesh, mean_image,
            a.max_batches or None)
        for variant, metrics in report[split_name].items():
            line = ", ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            hemx.message(f"  {variant}: {line}")

    if mean_image is not None:
        with open(os.path.join(out_dir, "mean_depth.png"), "wb") as f:
            f.write(encode_png(to_uint8(mean_image)))
    with open(os.path.join(out_dir, "eigen_metrics.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    hemx.message(f"wrote {out_dir}/eigen_metrics.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
