#!/usr/bin/env python
"""Post-hoc visualization CLI (reference: visualize.py).

Flags mirror the reference (visualize.py:262-276): --sample, --timelapse,
--activations, --weights, --bestfit, --loss, --all. Outputs are PNGs (and a
loss-curve PDF) written to <dir>/visualize/.

Instead of TF meta-graph surgery by tensor name (visualize.py:186-191), the
model is rebuilt from the run's options.json and the checkpoint restored —
then model hooks (sample/reconstruct/capture) provide the tensors.

--bestfit is the reference's gradient ascent in image space
(visualize.py:206-247): 20 steps of normalized input gradients maximizing a
conv channel's mean activation, Gaussian blur every 4 steps, L2 decay 1e-4 —
implemented as a jitted jax.grad loop.
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

import jax
import jax.numpy as jnp

import hemx
from hemx.config import load_options
from hemx.core import Ctx
from hemx.models.plugin import get_model
from hemx.data.pipeline import make_place
from hemx.parallel.mesh import make_mesh
from hemx.summaries.montage import factorization, montage, to_uint8
from hemx.summaries.png import encode_png
from hemx.summaries.reader import get_tag_values
from hemx.train.checkpoint import CheckpointManager
from hemx.utils.misc import enable_compile_cache


def load_run(run_dir: str):
    """Rebuild model + restore latest checkpoint from a workspace dir."""
    opts = load_options(os.path.join(run_dir, "options.json"))
    args = types.SimpleNamespace(**opts)
    args.dir = run_dir
    mesh = make_mesh(getattr(args, "n_devices", 1) or 1)
    splits = hemx.get_dataset_tensors(args)
    model = get_model(args.model)(args, mesh)
    gb = args.batch_size * mesh.devices.size
    host_batch = next(splits["train"].iter_epoch(gb, shuffle=False))
    ts = model.init_state(jax.random.PRNGKey(args.seed), host_batch)
    mgr = CheckpointManager(run_dir)
    wrapper = mgr.restore({"train_state": ts, "epoch": np.int64(0)})
    return args, mesh, splits, model, wrapper["train_state"], host_batch, mgr


def _save(out_dir: str, name: str, image: np.ndarray) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(np.clip(image, 0, 1))))
    return path


def _model_samples(model, ts, n: int, rng):
    if hasattr(model, "_sample"):            # GAN family
        return np.asarray(jax.device_get(model._sample(ts, rng, n)))
    if hasattr(model, "_decode_samples"):    # VAE
        return np.asarray(jax.device_get(model._decode_samples(ts, rng, n)))
    return None


def visualize_samples(run, out_dir: str) -> None:
    args, mesh, splits, model, ts, batch, mgr = run
    n = getattr(args, "examples", 64)
    samples = _model_samples(model, ts, n, jax.random.PRNGKey(0))
    if samples is None and hasattr(model, "_jit_recon"):
        place = make_place(mesh, splits["train"])
        samples = np.asarray(jax.device_get(
            model._jit_recon(ts, place(batch))))[:n]
    if samples is not None:
        _save(out_dir, "samples.png", montage(samples))
        hemx.message(f"wrote {out_dir}/samples.png")


def visualize_timelapse(run, out_dir: str) -> None:
    """One sample grid per checkpoint (reference: visualize.py:144-167).
    Generative models sample; autoencoders reconstruct a fixed batch."""
    args, mesh, splits, model, ts, batch, mgr = run
    place = make_place(mesh, splits["train"])
    device_batch = place(batch)
    frames = []
    for epoch, path in mgr.checkpoints():
        wrapper = mgr.restore({"train_state": ts, "epoch": np.int64(0)}, path)
        s = _model_samples(model, wrapper["train_state"],
                           min(16, args.examples), jax.random.PRNGKey(0))
        if s is None and hasattr(model, "_jit_recon"):
            s = np.asarray(jax.device_get(
                model._jit_recon(wrapper["train_state"], device_batch)))[:16]
        if s is None:
            return
        frames.append(montage(s, grid=(4, 4)))
        _save(out_dir, f"timelapse-{epoch:04d}.png", frames[-1])
    if frames:
        hemx.message(f"wrote {len(frames)} timelapse frames to {out_dir}")


def _normalized_image(splits, mesh, batch, model):
    """The training pipeline normalizes on-device (Split.device_transform);
    a raw host batch here may be uint8 0-255 — run it through the same
    placement so captures/bestfit see the distribution the net trained on."""
    from hemx.data.pipeline import make_place
    placed = make_place(mesh, splits["train"], keys=model.batch_keys)(batch)
    return jnp.asarray(placed["image"])


def _apply_captured(model, ts, x, ctx):
    """Run the model's forward with capture, covering every family:
    _forward (cnn/vae/artist/estimator — handles its own input rescale),
    bare _net, or the GAN discriminator on [-1,1] inputs."""
    if hasattr(model, "_forward"):
        model._forward(ts["params"], ts["mstate"], x, ctx)
    elif hasattr(model, "_net"):
        model._net.apply(ts["params"], ts["mstate"], x, ctx)
    elif hasattr(model, "_nets") and "discriminator" in getattr(model, "_nets", {}):
        d = model._nets["discriminator"]
        d.apply(ts["params"]["discriminator"], ts["mstate"]["discriminator"],
                2.0 * (x - 0.5), ctx)


def _capture_layers(model, ts, batch, mesh, splits=None):
    """Per-layer activations via Ctx capture on the model's main net."""
    if splits is not None:
        x = _normalized_image(splits, mesh, batch, model)
    else:
        x = jnp.asarray(batch["image"])
    ctx = Ctx(training=False, rng=jax.random.PRNGKey(0), capture=True)
    _apply_captured(model, ts, x, ctx)
    return {k: v for k, v in ctx.intermediates.items()
            if hasattr(v, "ndim") and v.ndim == 4}


def visualize_activations(run, out_dir: str) -> None:
    """Filter-response montages per conv layer (reference: visualize.py:88-118)."""
    args, mesh, splits, model, ts, batch, mgr = run
    layers = _capture_layers(model, ts, batch, mesh, splits)
    for name, act in layers.items():
        a = np.asarray(jax.device_get(act))[0]          # first example
        a = np.transpose(a, (2, 0, 1))[:, :, :, None]    # filters as images
        lo, hi = a.min(), a.max()
        a = (a - lo) / max(hi - lo, 1e-12)
        _save(out_dir, f"activations-{name.replace('/', '_')}.png", montage(a))
    if layers:
        hemx.message(f"wrote {len(layers)} activation montages to {out_dir}")


def visualize_weights(run, out_dir: str) -> None:
    """First-layer filter grids (reference: visualize.py:122-141)."""
    args, mesh, splits, model, ts, batch, mgr = run
    flat = jax.tree_util.tree_flatten_with_path(ts["params"])[0]
    count = 0
    for path, leaf in flat:
        arr = np.asarray(jax.device_get(leaf))
        if arr.ndim == 4 and arr.shape[0] >= 3 and arr.shape[2] in (1, 3, 4):
            # HWIO kernel with displayable input channels
            k = np.transpose(arr[:, :, :3, :], (3, 0, 1, 2))
            lo, hi = k.min(), k.max()
            k = (k - lo) / max(hi - lo, 1e-12)
            name = "_".join(str(getattr(p, "key", p)) for p in path)
            _save(out_dir, f"weights-{name}.png", montage(k))
            count += 1
    hemx.message(f"wrote {count} weight grids to {out_dir}")


def _gaussian_blur(x, sigma: float = 1.0):
    """Separable 5-tap Gaussian blur, NHWC."""
    r = jnp.arange(-2, 3, dtype=jnp.float32)
    k = jnp.exp(-(r ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    kh = k.reshape(5, 1, 1, 1) * jnp.eye(x.shape[-1]).reshape(1, 1, x.shape[-1], x.shape[-1])
    kw = k.reshape(1, 5, 1, 1) * jnp.eye(x.shape[-1]).reshape(1, 1, x.shape[-1], x.shape[-1])
    from hemx.ops.layers import conv2d_op
    return conv2d_op(conv2d_op(x, kh, 1, "SAME"), kw, 1, "SAME")


def visualize_bestfit(run, out_dir: str, layer: str | None = None,
                      n_filters: int = 16) -> None:
    """Gradient ascent in image space (reference: visualize.py:206-247)."""
    args, mesh, splits, model, ts, batch, mgr = run
    layers = _capture_layers(model, ts, batch, mesh, splits)
    if not layers:
        hemx.message("no conv layers to fit", hemx.WARNING)
        return
    layer = layer or sorted(layers)[0]
    x_shape = (1,) + tuple(np.asarray(batch["image"]).shape[1:])

    def act_mean(x, idx):
        ctx = Ctx(training=False, rng=jax.random.PRNGKey(0), capture=True)
        _apply_captured(model, ts, x, ctx)
        # idx stays traced (a static idx would recompile the whole
        # forward+backward once per filter)
        return jnp.mean(jnp.take(ctx.intermediates[layer], idx, axis=-1))

    grad_fn = jax.jit(jax.grad(act_mean))
    images = []
    n_filters = min(n_filters, int(layers[layer].shape[-1]))
    for idx in range(n_filters):
        x = jax.random.uniform(jax.random.PRNGKey(idx), x_shape) * 0.2 + 0.4
        for i in range(20):
            g = grad_fn(x, jnp.asarray(idx))
            g = g / (jnp.sqrt(jnp.mean(g ** 2)) + 1e-8)
            x = x + 0.1 * g
            x = x * (1.0 - 1e-4)            # L2 decay (visualize.py:240)
            if i % 4 == 0:
                x = _gaussian_blur(x)       # blur every 4 (visualize.py:243)
        img = np.asarray(jax.device_get(x))[0]
        lo, hi = img.min(), img.max()
        images.append((img - lo) / max(hi - lo, 1e-12))
    _save(out_dir, f"bestfit-{layer.replace('/', '_')}.png",
          montage(np.stack(images)))
    hemx.message(f"wrote bestfit montage for layer '{layer}'")


def visualize_loss(run, out_dir: str) -> None:
    """Loss curves from the run's tfevents (reference: visualize.py --loss)."""
    args, mesh, splits, model, ts, batch, mgr = run
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from hemx.summaries.reader import get_all_events
    fig, ax = plt.subplots(figsize=(8, 5))
    found = False
    for phase in ("train", "validate"):
        events = get_all_events(os.path.join(args.dir, phase))
        for tag, rows in sorted(events.items()):
            if not tag.startswith("losses/"):
                continue
            steps = [r[1] for r in rows]
            vals = [r[2] for r in rows]
            ax.plot(steps, vals, label=f"{phase}/{tag.split('/', 1)[1]}")
            found = True
    if not found:
        hemx.message("no loss events found", hemx.WARNING)
        return
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(os.path.join(out_dir, "loss.pdf"), bbox_inches="tight")
    plt.close(fig)
    hemx.message(f"wrote {out_dir}/loss.pdf")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="hemx run visualizer")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--timelapse", action="store_true")
    parser.add_argument("--activations", action="store_true")
    parser.add_argument("--weights", action="store_true")
    parser.add_argument("--bestfit", action="store_true")
    parser.add_argument("--loss", action="store_true")
    parser.add_argument("--layer", default=None,
                        help="Layer name for --bestfit.")
    parser.add_argument("--all", action="store_true")
    a = parser.parse_args(argv)
    enable_compile_cache()

    run = load_run(a.dir)
    out_dir = os.path.join(a.dir, "visualize")
    if a.sample or a.all:
        visualize_samples(run, out_dir)
    if a.timelapse or a.all:
        visualize_timelapse(run, out_dir)
    if a.activations or a.all:
        visualize_activations(run, out_dir)
    if a.weights or a.all:
        visualize_weights(run, out_dir)
    if a.bestfit or a.all:
        visualize_bestfit(run, out_dir, a.layer)
    if a.loss or a.all:
        visualize_loss(run, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
