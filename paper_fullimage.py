#!/usr/bin/env python
"""Full-image inference from a patch model (reference: paper_fullimage.py).

A 65x65-patch -> 29x29-depth model is applied to full images by sliding
patches at several strides, batch-inferring through the jitted generator,
and reassembling the overlapping 29x29 predictions with NaN-aware averaging
(reference: build_batch :90-110, forward_inference :112-123, reconstruct
:126-155). Per-stride RMSE and montage PNGs go to <dir>/fullimage/.

Compile notes: patches are padded to a fixed chunk size so one compiled
executable serves every stride (the reference padded to 1024-multiples and
chunked by 512); reassembly is host-side numpy.
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

import jax

import hemx
from hemx.config import load_options
from hemx.models.plugin import get_model
from hemx.parallel.dp import shard_batch
from hemx.parallel.mesh import make_mesh
from hemx.summaries.montage import to_uint8
from hemx.summaries.png import encode_png
from hemx.train.checkpoint import CheckpointManager
from hemx.utils.misc import enable_compile_cache

PATCH = 65
OUT = 29
OUT_OFFSET = 17  # the 29x29 output corresponds to input pixels [17,46)


def build_batch(image: np.ndarray, stride: int):
    """Slide PATCH x PATCH windows at ``stride``; returns (patches, coords)
    (reference: paper_fullimage.py:90-110)."""
    h, w, _ = image.shape
    patches, coords = [], []
    for top in range(0, h - PATCH + 1, stride):
        for left in range(0, w - PATCH + 1, stride):
            patches.append(image[top:top + PATCH, left:left + PATCH])
            coords.append((top, left))
    return np.stack(patches), coords


def forward_inference(model, ts, patches: np.ndarray, mesh, batch: dict,
                      chunk: int = 512,
                      depth_patches: np.ndarray | None = None) -> np.ndarray:
    """Run patches through the model generator in fixed-size chunks
    (reference: paper_fullimage.py:112-123).

    ``depth_patches`` are the TRUE depth windows sliced at the same coords —
    the reference fed them per chunk (``y_ph: depth_splits[i]``, :121), so a
    mean-adjusted model's y_bar is the real per-patch mean, not a constant.
    Falls back to a flat 0.5 template only when the scene has no depth.
    """
    n = patches.shape[0]
    pad = (-n) % chunk
    if pad:
        patches = np.concatenate([patches,
                                  np.repeat(patches[-1:], pad, axis=0)])
    if depth_patches is None:
        depth_full = np.zeros(
            (patches.shape[0],) + tuple(batch["depth"].shape[1:]),
            np.float32) + 0.5
    else:
        depth_full = depth_patches.astype(np.float32)
        if pad:
            depth_full = np.concatenate(
                [depth_full, np.repeat(depth_full[-1:], pad, axis=0)])
    outs = []
    extras = {k: np.repeat(np.asarray(v[:1]), chunk, axis=0)
              for k, v in batch.items() if k not in ("image", "depth")}
    for i in range(0, patches.shape[0], chunk):
        fake_batch = {"image": patches[i:i + chunk],
                      "depth": depth_full[i:i + chunk], **extras}
        g, _ = model._jit_predict(ts, shard_batch(fake_batch, mesh))
        outs.append(np.asarray(jax.device_get(g)))
    return np.concatenate(outs)[:n]


def reconstruct(shape, preds: np.ndarray, coords, depth_range):
    """NaN-aware overlap averaging of 29x29 outputs, mapped from the model's
    output range back to the dataset's [0,1] depth units
    (reference: paper_fullimage.py:126-155)."""
    h, w = shape
    lo, hi = depth_range
    total = np.zeros((h, w), np.float64)
    count = np.zeros((h, w), np.float64)
    for pred, (top, left) in zip(preds[..., 0], coords):
        t = top + OUT_OFFSET
        l = left + OUT_OFFSET
        total[t:t + OUT, l:l + OUT] += pred
        count[t:t + OUT, l:l + OUT] += 1
    out = np.full((h, w), np.nan)
    mask = count > 0
    out[mask] = total[mask] / count[mask]
    return (out - lo) / (hi - lo)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="hemx full-image inference")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--n_scenes", type=int, default=8)
    parser.add_argument("--strides", type=int, nargs="*",
                        default=[10, 8, 6, 4, 2, 1])
    parser.add_argument("--chunk", type=int, default=512)
    parser.add_argument("--scene_shape", type=int, nargs=3, default=None,
                        help="Override the dataset image shape for SCENES "
                             "(e.g. 96 96 3) so full images are larger than "
                             "the 65x65 training patches — the synthetic "
                             "analog of NYUv2's 427x561 frames vs 65x65 "
                             "crops.")
    a = parser.parse_args(argv)
    enable_compile_cache()

    opts = load_options(os.path.join(a.dir, "options.json"))
    args = types.SimpleNamespace(**opts)
    args.dir = a.dir
    mesh = make_mesh(getattr(args, "n_devices", 1) or 1)
    splits = hemx.get_dataset_tensors(args)
    scene_splits = splits
    if a.scene_shape:
        # scenes come from a larger rendering of the same distribution; the
        # model itself is initialized/restored at its training patch size
        scene_args = types.SimpleNamespace(**vars(args))
        scene_args.synthetic_shape = list(a.scene_shape)
        scene_splits = hemx.get_dataset_tensors(scene_args)
    model = get_model(args.model)(args, mesh)
    gb = args.batch_size * mesh.devices.size
    host_batch = next(splits["train"].iter_epoch(gb, shuffle=False))
    ts_init = model.init_state(jax.random.PRNGKey(args.seed), host_batch)
    mgr = CheckpointManager(a.dir)
    wrapper = mgr.restore({"train_state": ts_init, "epoch": np.int64(0)})
    ts = wrapper["train_state"]

    # Depth scale comes from the model's declared output range, NOT a
    # hardcoded constant: paper models predict meters (0,10), [-1,1]/[0,1]
    # models map accordingly (reference hardcoded /10 because all its
    # fullimage models were paper variants, paper_fullimage.py:151).
    depth_range = (model.depth_range() if hasattr(model, "depth_range")
                   else (0.0, 1.0))
    hemx.message(f"model depth range: {depth_range}")

    split = scene_splits[a.split]
    scenes = next(split.iter_epoch(min(a.n_scenes, split.count),
                                   shuffle=False))
    # uint8-shipping datasets normalize on-device in the training pipeline;
    # this CLI assembles patches host-side, so normalize here
    scenes = {k: (np.asarray(v).astype(np.float32) / 255.0
                  if np.asarray(v).dtype == np.uint8 else np.asarray(v))
              for k, v in scenes.items()}
    out_dir = os.path.join(a.dir, "fullimage")
    os.makedirs(out_dir, exist_ok=True)
    n_scenes = scenes["image"].shape[0]
    # recons[scene][stride] for the cross-stride comparison montages
    # (reference: paper_fullimage.py:302-316)
    recons: dict = {s: {} for s in range(n_scenes)}
    for stride in a.strides:
        rmses = []
        for s in range(n_scenes):
            image = np.asarray(scenes["image"][s])
            depth = np.asarray(scenes["depth"][s])[..., 0]
            if image.shape[0] < PATCH or image.shape[1] < PATCH:
                hemx.message(f"scene smaller than {PATCH}px; skipping",
                             hemx.WARNING)
                return 0
            patches, coords = build_batch(image, stride)
            scene_depth = np.asarray(scenes["depth"][s])
            depth_patches = np.stack(
                [scene_depth[t:t + PATCH, l:l + PATCH] for t, l in coords])
            preds = forward_inference(model, ts, patches, mesh, host_batch,
                                      a.chunk, depth_patches=depth_patches)
            recon = reconstruct(image.shape[:2], preds, coords, depth_range)
            valid = ~np.isnan(recon)
            rmse = float(np.sqrt(np.mean(
                (recon[valid] - depth[valid]) ** 2)))
            rmses.append(rmse)
            recons[s][stride] = recon
            vis = np.where(np.isnan(recon), 0.0, recon)
            with open(os.path.join(
                    out_dir, f"scene{s}_stride{stride}.png"), "wb") as f:
                f.write(encode_png(to_uint8(np.clip(vis, 0, 1))))
        hemx.message(f"stride {stride}: mean rmse "
                     f"{float(np.mean(rmses)):.4f} over {len(rmses)} scenes")

    # per-scene comparison grid: [RGB | ground truth | recon per stride]
    for s in range(n_scenes):
        image = np.asarray(scenes["image"][s])
        depth = np.asarray(scenes["depth"][s])[..., 0]
        cols = [image.mean(axis=-1), depth]
        cols += [np.where(np.isnan(recons[s][st]), 0.0, recons[s][st])
                 for st in a.strides]
        grid = np.concatenate([np.clip(c, 0, 1) for c in cols], axis=1)
        with open(os.path.join(out_dir, f"scene{s}_comparison.png"),
                  "wb") as f:
            f.write(encode_png(to_uint8(grid)))
    hemx.message(f"comparison montages: {out_dir}/scene*_comparison.png "
                 f"(columns: rgb, gt, strides {a.strides})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
