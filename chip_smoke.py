#!/usr/bin/env python
"""Smoke test of hemx's training path on an NVIDIA GPU.

    python chip_smoke.py              # every phase below, on one GPU
    python chip_smoke.py --multichip  # only the IWGAN train call on 4 GPUs
                                      # against the same call on 1

Everything runs in this one process: a JAX process reserves most of a
card's memory when it first uses it, so a second process beside it would
fail for want of memory.

Phases, in order:

device       JAX's first device must be a GPU (there is no CPU fallback).
             Prints its kind, the device count, and nvidia-smi's name and
             power limit for the card.
train_iwgan  ``train.main`` with the reference IWGAN config (adam 1e-4,
             betas 0.5/0.9, batch 512, latent 200) on 64x64x3 uint8
             synthetic images through the device-resident input cache: one
             epoch, then ``--epochs +1`` resumed from its checkpoint.
train_cnn    ``train.main`` with the CNN autoencoder at the reference
             transcript's config (rmsprop 1e-4, batch 1024) through the
             streaming input path (``--no-device_data_cache``).
numerics     (a) one IWGAN train call (5 critic steps with the
             gradient-penalty double-backprop, then 1 generator step) at
             full width and batch 32, float32 with precision 'highest', on
             the GPU against the same call jitted on the CPU, the plain
             reference; (b) the same call under the shipped defaults;
             (c) the grouped device gather + u8_normalize against numpy;
             (d) deconv2d_op 'dilated' and 'phase_split' against the CPU.
timing       the IWGAN train call at batch 512 (float32 and bfloat16) and
             one train call's batch assembly, after warm-up. These are
             bring-up findings, not benchmark metrics.

The last line is ``{"ok": true, "device": {...}}`` only when every phase
passed; otherwise the exit code is 1.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

import jax
import jax.numpy as jnp

from hemx.utils.misc import enable_compile_cache

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(ROOT, "workspace", "chip_smoke")

# (a) and --multichip: float32 'highest' on both sides, so the only
# differences are summation order inside convs and reductions.
LOSS_RTOL = 1e-4
# (a): sgd parameter updates (new - old) must agree elementwise to this
# rtol plus a tree-global atol of UPDATE_TOL x the largest update anywhere
# in the tree, as in the data-parallel equality tests: leaves whose true
# update is ~0 (e.g. where relu/lrelu cut the gradient) carry only
# summation-order noise, which a per-element tolerance would reject. GPU
# and CPU run different conv algorithms, and each of the 5 critic updates
# feeds the next, so their updates differ more than two CPU meshes do;
# a wrong gradient is off by O(1) of the largest update (PERF.md).
UPDATE_TOL = 5e-3
# (b): losses under the shipped defaults against (a)'s reference.
DEFAULTS_LOSS_RTOL = 2e-2
NORMALIZE_ATOL = 1e-6  # (c)
DECONV_TOL = 1e-4      # (d), relative to the output's largest magnitude


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def phase_device(need: int) -> str:
    """Fail unless JAX sees ``need`` GPUs; returns nvidia-smi's
    "name, power.limit" line(s)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's devices are {devs}")
    if len(devs) < need:
        raise RuntimeError(f"{need} GPUs needed, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say("device", f"{devs[0].device_kind}, {len(devs)} device(s)")
    for line in smi.splitlines():
        say("device", f"nvidia-smi: {line}")
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# train_iwgan / train_cnn: the CLI entry point
# ---------------------------------------------------------------------------

def _last_losses(run_dir: str, tags) -> dict:
    """Last logged value of each train-loss tag; all logged values must be
    finite."""
    from hemx.summaries.reader import get_all_events, get_tag_values
    logdir = os.path.join(run_dir, "train")
    events = get_all_events(logdir)
    out = {}
    for tag in tags:
        vals = [v for _, v in get_tag_values(logdir, tag, events)]
        if not vals or not np.all(np.isfinite(vals)):
            raise AssertionError(f"{run_dir}: {tag} = {vals}")
        out[tag] = vals[-1]
    return out


def _ckpt_counter(run_dir: str, epoch: int) -> tuple[int, int]:
    """(epoch, train-call counter) stored in checkpoint-<epoch>."""
    path = os.path.join(run_dir, f"checkpoint-{epoch}.npz")
    if not os.path.exists(path):
        raise AssertionError(f"no {path}")
    with np.load(path) as z:
        return int(z["['epoch']"]), int(z["['train_state']['step']"])


def _train(argv) -> None:
    import train
    rc = train.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"train.main exited {rc}")


def phase_train_iwgan(batch: int = 512, image: int = 64, latent: int = 200,
                      calls: int = 3, count: int = 4096) -> None:
    run = os.path.join(WORKDIR, "iwgan")
    shutil.rmtree(run, ignore_errors=True)
    argv = ["--model", "iwgan", "--dataset", "synthetic",
            "--optimizer", "adam", "--lr", "1e-4", "--beta1", "0.5",
            "--beta2", "0.9", "--batch_size", batch, "--latent_size", latent,
            "--synthetic_shape", image, image, 3, "--synthetic_u8",
            "--synthetic_count", count, "--synthetic_eval_count", batch,
            "--epoch_size", calls, "--seed", 1, "--dir", run]
    t0 = time.perf_counter()
    _train(argv + ["--epochs", 1])
    say("train_iwgan", f"epoch 1: {time.perf_counter() - t0:.1f} s (compile "
                       f"included)")
    t0 = time.perf_counter()
    _train(argv + ["--epochs", "+1"])
    say("train_iwgan", f"epoch 2 (resumed): {time.perf_counter() - t0:.1f} s")
    losses = _last_losses(run, ("losses/g_loss", "losses/d_loss"))
    first, second = _ckpt_counter(run, 1), _ckpt_counter(run, 2)
    if first != (1, calls) or second != (2, 2 * calls):
        raise AssertionError(f"(epoch, step) of checkpoint-1 {first}, of "
                             f"checkpoint-2 {second}: the +1 run did not "
                             f"resume from checkpoint-1")
    say("train_iwgan", f"finite losses {losses}; checkpoint-1 {first}, "
                       f"checkpoint-2 {second} (epoch, step): resumed")


def phase_train_cnn(batch: int = 1024, image: int = 64, calls: int = 4,
                    count: int = 4096) -> None:
    run = os.path.join(WORKDIR, "cnn")
    shutil.rmtree(run, ignore_errors=True)
    t0 = time.perf_counter()
    _train(["--model", "cnn", "--dataset", "synthetic",
            "--optimizer", "rmsprop", "--lr", "1e-4", "--batch_size", batch,
            "--synthetic_shape", image, image, 3, "--synthetic_u8",
            "--synthetic_count", count, "--synthetic_eval_count", batch,
            "--no-device_data_cache", "--epoch_size", calls, "--epochs", 1,
            "--seed", 1, "--dir", run])
    losses = _last_losses(run, ("losses/loss",))
    _ckpt_counter(run, 1)
    say("train_cnn", f"streaming input path, {calls} steps at bs{batch}: "
                     f"{time.perf_counter() - t0:.1f} s (compile included); "
                     f"finite losses {losses}; checkpoint-1 written")


# ---------------------------------------------------------------------------
# numerics: the IWGAN train call against a reference run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def policy(dtype: str, precision: str):
    """hemx's compute dtype and precision policy (what train.py's --dtype
    and --precision set), restored to train.py's defaults on exit."""
    from hemx.ops.layers import set_compute_dtype, set_default_precision
    set_compute_dtype(dtype)
    set_default_precision(precision)
    try:
        with contextlib.ExitStack() as stack:
            if precision == "highest":
                stack.enter_context(jax.default_matmul_precision("highest"))
            yield
    finally:
        set_compute_dtype(None)
        set_default_precision("default")


def iwgan_batches(n: int, batch: int, image: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((batch, image, image, 3), dtype=np.float32)}
            for _ in range(n)]


@dataclasses.dataclass
class Call:
    losses: dict       # metric name -> float
    start: dict        # host train state before the call
    params: list       # host param leaves after the call
    span: int          # fewest devices any state leaf lives on
    sharded: bool      # some param leaf is split over devices


def iwgan_train_call(devices, batches, *, latent: int, model: int = 1,
                     spatial: int = 1, init: dict | None = None) -> Call:
    """One IWGAN train call (``len(batches) - 1`` critic steps, then one
    generator step) on a mesh over ``devices``, with sgd so that the
    parameter updates are exactly lr x grad. ``init`` (a host train state)
    replaces the model's own initialisation, so two calls can start from
    the same values."""
    from hemx.config import default_args
    from hemx.models.plugin import get_model
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import (data_axis_size, make_mesh,
                                    state_shardings)

    mesh = make_mesh(devices=devices, model=model, spatial=spatial)
    gb, h, w, c = batches[0]["image"].shape
    args = default_args(model="iwgan", batch_size=gb // data_axis_size(mesh),
                        latent_size=latent, n_disc_train=len(batches) - 1,
                        optimizer="sgd", lr=1e-3, seed=0,
                        synthetic_shape=[h, w, c])
    m = get_model("iwgan")(args, mesh)
    ts = m.init_state(jax.random.PRNGKey(0), batches[0])
    if init is not None:
        ts = jax.device_put(init, state_shardings(mesh, init))
    start = jax.device_get(ts)  # the call donates ts
    ts, metrics = m.train(ts, iter([shard_batch(b, mesh) for b in batches]))
    leaves = jax.tree_util.tree_leaves(ts)
    params = jax.tree_util.tree_leaves(ts["params"])
    return Call(
        losses={k: float(v) for k, v in jax.device_get(metrics).items()},
        start=start,
        params=[np.asarray(x) for x in jax.device_get(params)],
        span=min(len(x.sharding.device_set) for x in leaves),
        sharded=any(not x.sharding.is_fully_replicated for x in params))


def compare_calls(ref: Call, got: Call, loss_rtol: float = LOSS_RTOL,
                  update_tol: float = UPDATE_TOL) -> dict:
    """Check ``got`` against ``ref`` (both from ``ref.start``): losses to
    ``loss_rtol``, parameter updates to ``update_tol`` (see UPDATE_TOL).
    Returns the largest relative loss difference and the largest
    |update difference| / (largest update + |that element's update|),
    which must stay below ``update_tol``; raises AssertionError past the
    tolerances."""
    loss = max(abs(got.losses[k] - ref.losses[k]) / abs(ref.losses[k])
               for k in ref.losses)
    old = [np.asarray(x, np.float64)
           for x in jax.tree_util.tree_leaves(ref.start["params"])]
    d_ref = [p.astype(np.float64) - o for p, o in zip(ref.params, old)]
    d_got = [p.astype(np.float64) - o for p, o in zip(got.params, old)]
    scale = max(np.abs(d).max() for d in d_ref)
    update = max((np.abs(a - b) / (scale + np.abs(b))).max()
                 for a, b in zip(d_got, d_ref))
    if loss > loss_rtol:
        raise AssertionError(f"losses {got.losses} vs {ref.losses}: relative "
                             f"difference {loss:.3g} > {loss_rtol}")
    if update > update_tol:
        raise AssertionError(f"parameter updates differ by {update:.3g} > "
                             f"{update_tol} (see compare_calls)")
    return {"loss": loss, "update": update}


def _precision_probe(phase: str) -> None:
    """What float32 precision 'default' means on this device: a matmul and
    a conv at the critic's widths, 'default' against 'highest'."""
    from jax import lax
    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal((2048, 2048), np.float32))
    img = jax.device_put(rng.standard_normal((32, 32, 32, 200), np.float32))
    ker = jax.device_put(rng.standard_normal((5, 5, 200, 400), np.float32))

    def conv(p):
        return jax.jit(lambda a, k: lax.conv_general_dilated(
            a, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=p))(img, ker)

    for name, fn in (("matmul 2048^3", lambda p: jax.jit(
            lambda a: jnp.dot(a, a, precision=p))(x)),
                     ("conv 5x5/2 200->400 on 32x32x32", conv)):
        hi = np.asarray(fn(lax.Precision.HIGHEST), np.float64)
        lo = np.asarray(fn(lax.Precision.DEFAULT), np.float64)
        err = np.linalg.norm(lo - hi) / np.linalg.norm(hi)
        say(phase, f"float32 {name}: precision 'default' vs 'highest' "
                   f"relative error {err:.3g}")


def _u8_pipeline(rows: int, batch: int, image: int, group: int, mesh):
    from hemx.data.pipeline import (ArraySource, DeviceDataPipeline, Split,
                                    u8_image_device_transform)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (rows, image, image, 3), dtype=np.uint8)
    split = Split(ArraySource({"image": u8}), name="train",
                  device_transform=u8_image_device_transform())
    return u8, split, DeviceDataPipeline(split, batch, mesh=mesh,
                                         keys=("image",), group=group)


def phase_numerics(batch: int = 32, image: int = 64, latent: int = 200,
                   group_batch: int = 512, rows: int = 4096) -> None:
    from hemx.ops.layers import deconv2d_op, set_deconv_impl
    from hemx.parallel.mesh import make_mesh
    p = "numerics"
    cpu, gpu = jax.devices("cpu")[:1], jax.devices()[:1]
    batches = iwgan_batches(6, batch, image)

    # (a)
    with policy("float32", "highest"):
        t0 = time.perf_counter()
        ref = iwgan_train_call(cpu, batches, latent=latent)
        t1 = time.perf_counter()
        got = iwgan_train_call(gpu, batches, latent=latent, init=ref.start)
    d = compare_calls(ref, got)
    say(p, f"(a) IWGAN train call bs{batch} {image}x{image} latent {latent}, "
           f"float32 'highest': CPU reference {ref.losses} "
           f"({t1 - t0:.1f} s), GPU {got.losses}; loss rel diff "
           f"{d['loss']:.3g} (rtol {LOSS_RTOL}), update diff "
           f"{d['update']:.3g} (tol {UPDATE_TOL}, see compare_calls)")

    # (b)
    for dtype in ("bfloat16", "float32"):
        with policy(dtype, "default"):
            got = iwgan_train_call(gpu, batches, latent=latent,
                                   init=ref.start)
        rel = {k: abs(got.losses[k] - ref.losses[k]) / abs(ref.losses[k])
               for k in ref.losses}
        say(p, f"(b) {dtype}, precision 'default': GPU {got.losses}; loss "
               f"rel diff vs (a)'s reference "
               f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} } "
               f"(limit {DEFAULTS_LOSS_RTOL})")
        if max(rel.values()) >= DEFAULTS_LOSS_RTOL:
            raise AssertionError(f"{dtype}/default losses off by {rel}")
    _precision_probe(p)

    # (c) the device-cache batch assembly: one train call's group of 6
    lo, hi = 0.0, 1.0
    u8, split, pipe = _u8_pipeline(rows, group_batch, image, 6,
                                   make_mesh(devices=gpu))
    got = [np.asarray(b["image"]) for b in itertools.islice(pipe.epoch(0), 6)]
    idx = list(itertools.islice(split.iter_epoch_indices(group_batch), 6))
    err = max(np.abs(g - (u8[i].astype(np.float32) / 255 * (hi - lo) + lo))
              .max() for g, i in zip(got, idx))
    say(p, f"(c) grouped gather + u8_normalize, 6 x {group_batch} x "
           f"{image}x{image}x3 uint8: max abs err vs numpy {err:.3g} "
           f"(atol {NORMALIZE_ATOL})")
    if not err <= NORMALIZE_ATOL:
        raise AssertionError(f"u8_normalize off by {err}")

    # (d) the generator's transposed convs at their real widths
    rng = np.random.default_rng(1)
    ch, hw = 4 * latent, 4
    with policy("float32", "highest"):
        while hw < image:
            out_ch = ch // 2 if 2 * hw < image else 3
            x = rng.standard_normal((batch, hw, hw, ch), np.float32)
            k = rng.standard_normal((5, 5, out_ch, ch), np.float32) * 0.05

            def deconv(impl, dev, out=(2 * hw, 2 * hw)):
                set_deconv_impl(impl)
                try:
                    return np.asarray(jax.jit(
                        lambda a, b: deconv2d_op(a, b, out))(
                            jax.device_put(x, dev), jax.device_put(k, dev)))
                finally:
                    set_deconv_impl("dilated")

            want = deconv("dilated", cpu[0])
            errs = {impl: float(np.abs(deconv(impl, gpu[0]) - want).max()
                                / np.abs(want).max())
                    for impl in ("dilated", "phase_split")}
            say(p, f"(d) deconv {hw}x{hw}x{ch} -> {2 * hw}x{2 * hw}x{out_ch}:"
                   f" GPU vs CPU 'dilated', max err / max |y|: {errs} "
                   f"(tol {DECONV_TOL})")
            if max(errs.values()) > DECONV_TOL:
                raise AssertionError(f"deconv {hw}->{2 * hw}: {errs}")
            ch, hw = out_ch, 2 * hw


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _entry_ops(hlo: str) -> dict:
    """Opcode counts of an optimized HLO module's ENTRY computation."""
    body = hlo[hlo.index("\nENTRY"):]
    body = body[:body.index("\n}")]
    ops = collections.Counter()
    for line in body.splitlines()[1:]:
        m = re.search(r"=\s.*?\s([a-z][\w\-]*)\(", line)
        if m:
            ops[m.group(1)] += 1
    return dict(ops)


def phase_timing(smi: str, batch: int = 512, image: int = 64,
                 latent: int = 200, steps: int = 10, warmup: int = 2,
                 rows: int = 4096, reps: int = 20) -> None:
    import bench
    from hemx.ops.layers import set_compute_dtype
    from hemx.parallel.mesh import make_mesh
    p = "timing"
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(dtype)
        try:
            r = bench.run_compute(argparse.Namespace(
                batch=batch, image=image, latent=latent, steps=steps,
                warmup=warmup, no_fused=False))
        finally:
            set_compute_dtype(None)
        say(p, f"IWGAN train call bs{batch} {image}x{image} latent {latent}, "
               f"{dtype}, precision 'default': "
               f"{r['detail']['step_time_s'] * 1e3} ms/call, {r['value']} "
               f"img/s ({steps} calls after {warmup} warm-up; {smi})")

    mesh = make_mesh(devices=jax.devices()[:1])
    _, split, pipe = _u8_pipeline(rows, batch, image, 6, mesh)
    jax.block_until_ready(list(itertools.islice(pipe.epoch(0), 6)))
    times = []
    for e in range(1, reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(list(itertools.islice(pipe.epoch(e), 6)))
        times.append(time.perf_counter() - t0)
    idx = pipe._place_idx(np.arange(6 * batch))
    ops = _entry_ops(pipe._assemble_group.lower(pipe.ds, idx).compile()
                     .as_text())
    say(p, f"batch assembly for one IWGAN train call (index slice H2D + "
           f"gather + u8_normalize of 6 x {batch} x {image}x{image}x3 from "
           f"{rows} device-resident rows): median "
           f"{np.median(times) * 1e3} ms, min {min(times) * 1e3} ms over "
           f"{reps} ({smi}); compiled ENTRY ops {ops}")
    stats = jax.devices()[0].memory_stats() or {}
    say(p, f"peak device memory {stats.get('peak_bytes_in_use')} bytes")


# ---------------------------------------------------------------------------
# --multichip
# ---------------------------------------------------------------------------

def phase_multichip(devices=None, batch: int = 32, image: int = 64,
                    latent: int = 200) -> None:
    """The IWGAN train call on 4 devices under the three meshes users
    select with --n_devices / --model_parallel / --spatial_parallel,
    against the same call on one device at the same global batch."""
    devices = list(devices or jax.devices()[:4])
    p = "multichip"
    batches = iwgan_batches(6, batch, image)
    with policy("float32", "highest"):
        ref = iwgan_train_call(devices[:1], batches, latent=latent)
        say(p, f"1 device: {ref.losses}")
        for name, kw in (("data=4", {}),
                         ("data=2 x model=2", {"model": 2}),
                         ("data=2 x spatial=2", {"spatial": 2})):
            got = iwgan_train_call(devices, batches, latent=latent,
                                   init=ref.start, **kw)
            if got.span != len(devices):
                raise AssertionError(f"{name}: some train-state leaf lives on "
                                     f"{got.span} device(s) only")
            if kw.get("model") and not got.sharded:
                raise AssertionError(f"{name}: no parameter is sharded")
            d = compare_calls(ref, got)
            say(p, f"{name}: {got.losses}; loss rel diff {d['loss']:.3g} "
                   f"(rtol {LOSS_RTOL}), update diff {d['update']:.3g} "
                   f"(tol {UPDATE_TOL}); state on all {got.span} devices")


# ---------------------------------------------------------------------------

def _count_cache_events() -> collections.Counter:
    counts = collections.Counter()
    jax.monitoring.register_event_listener(
        lambda event, **kw: counts.update([event]))
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multichip", action="store_true",
                        help="Run only the IWGAN train call on 4 GPUs "
                             "(data=4, data=2 x model=2, data=2 x "
                             "spatial=2) against the same call on 1.")
    a = parser.parse_args(argv)
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        # the numerics reference runs on the CPU backend
        jax.config.update("jax_platforms", plats + ",cpu")
    cache_dir = enable_compile_cache()
    events = _count_cache_events()

    try:
        smi = phase_device(4 if a.multichip else 1)
    except Exception:
        traceback.print_exc()
        say("device", "FAILED")
        return 1
    if a.multichip:
        phases = [("multichip", phase_multichip)]
    else:
        phases = [("train_iwgan", phase_train_iwgan),
                  ("train_cnn", phase_train_cnn),
                  ("numerics", phase_numerics),
                  ("timing", lambda: phase_timing(smi))]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase; the exit code says it all
            traceback.print_exc()
            failed.append(name)
            say(name, f"FAILED after {time.perf_counter() - t0:.1f} s")
        else:
            say(name, f"ok ({time.perf_counter() - t0:.1f} s)")
    hits = events["/jax/compilation_cache/cache_hits"]
    asked = events["/jax/compilation_cache/compile_requests_use_cache"]
    print(f"compile cache {cache_dir}: {hits} hits of {asked} requests",
          flush=True)
    if failed:
        print(f"FAILED: {', '.join(failed)}", flush=True)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
