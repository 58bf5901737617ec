"""Training loop (reference: hem/util/training.py:98-175, train.py:254-329).

Semantics reproduced:
* ``--epochs n`` trains to epoch n; ``--epochs +n`` trains n more from the
  restored epoch (hem/util/training.py:115);
* baseline checkpoint + summary at step 0 before any training
  (hem/util/training.py:126-130);
* summary cadence: 10x/epoch for the first 3 epochs, then 3x/epoch, plus one
  at each epoch end (hem/util/training.py:143-150);
* one checkpoint per epoch keyed by the epoch counter
  (hem/util/training.py:162);
* validation after every epoch; test at --test_epochs
  (hem/util/training.py:164-169);
* on NaN/Inf with --check_numerics the process exits nonzero so an outer
  restart loop (repeat.sh) can resume from the last checkpoint.

The data stream is continuous across epochs (the reference's tf.data
``repeat()``): models may pull several batches per train() call (WGAN's
critic loop), so an "epoch" is a fixed number of train() calls, not a fixed
number of pipeline batches — exactly the reference's accounting.
"""

from __future__ import annotations

import os
import time
import jax
import numpy as np

from hemx.config import init_working_dir
from hemx.parallel.mesh import data_axis_size, spatial_axis_size
from hemx.models import common
from hemx.data.pipeline import (DeviceDataPipeline, Pipeline, make_place,
                                make_place_stages)
from hemx.summaries.events import SummaryWriterSet
from hemx.train.checkpoint import CheckpointManager
from hemx.utils import terminal as term
from hemx.utils.terminal import MovingAverage

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


def _continuous_stream(pipeline: Pipeline, start_epoch: int = 0):
    e = start_epoch
    while True:
        yield from pipeline.epoch(e)
        e += 1


def train(model, splits, args, mesh, *, reset: bool = False) -> dict:
    """Train ``model`` on ``splits`` per ``args``. Returns the final train state
    wrapper {"train_state", "epoch"}."""
    init_working_dir(args)
    ckpt = CheckpointManager(args.dir, args.max_to_keep)
    writers = SummaryWriterSet(args.dir)
    global_batch = args.batch_size * data_axis_size(mesh)
    train_split = splits["train"]
    transfer, transform = make_place_stages(mesh, train_split,
                                            keys=model.batch_keys)
    place = lambda b: transform(transfer(b))
    batches = train_split.batches_per_epoch(global_batch)
    if args.epoch_size > 0:
        batches = min(batches, args.epoch_size)
    if batches == 0:
        raise ValueError(f"dataset ({train_split.count}) smaller than one "
                         f"global batch ({global_batch})")

    pipeline = None
    if getattr(args, "device_data_cache", True):
        pipeline = DeviceDataPipeline.maybe(
            train_split, global_batch, mesh=mesh, keys=model.batch_keys,
            shuffle=args.shuffle, seed=args.seed,
            budget_mb=getattr(args, "device_cache_mb", 1024),
            group=model.batches_per_train_call())
    if pipeline is not None:
        term.message("Input: device-resident dataset cache "
                     "(on-chip batch gather, no per-step H2D)")
    else:
        # streaming fallback (dataset over --device_cache_mb, multi-process,
        # or host batch_transform): group each train() call's batches into
        # ONE H2D transfer + one on-device split program instead of one
        # transfer dispatch per batch (make_group_place_stages)
        # (grouping happens AFTER the host batch_transform inside
        # iter_epoch, so per-batch augmentation rng is unaffected)
        group = model.batches_per_train_call()
        if group > 1:
            from hemx.data.pipeline import make_group_place_stages
            gtransfer, gtransform = make_group_place_stages(
                mesh, train_split, keys=model.batch_keys)
            pipeline = Pipeline(train_split, global_batch,
                                shuffle=args.shuffle, seed=args.seed,
                                place=gtransfer, post=gtransform,
                                group=group)
        else:
            pipeline = Pipeline(train_split, global_batch,
                                shuffle=args.shuffle, seed=args.seed,
                                place=transfer, post=transform)

    # shapes + init
    host_batch = next(train_split.iter_epoch(global_batch, shuffle=False))
    if model.batch_keys:
        host_batch = {k: v for k, v in host_batch.items()
                      if k in model.batch_keys}
    s = spatial_axis_size(mesh)
    if s > 1:
        # batch_spec's divisibility condition would otherwise silently fall
        # back to data-parallel sharding for the input leaf, leaving the
        # 'spatial' devices doing fully redundant work; reject loudly here
        # where the real input heights are known (mid-network activations
        # with strided-down H legitimately use the same fallback).
        for k, v in host_batch.items():
            shp = np.shape(v)
            if len(shp) >= 3 and (shp[1] < s or shp[1] % s):
                raise ValueError(
                    f"--spatial_parallel {s} does not divide the height "
                    f"{shp[1]} of input '{k}' {tuple(shp[1:])}; the input "
                    f"would silently shard data-parallel only, wasting the "
                    f"spatial axis. Pick a dividing height or drop "
                    f"--spatial_parallel.")
    summary_batch = place(host_batch)
    ts = model.init_state(jax.random.PRNGKey(args.seed), host_batch)

    current_epoch = 0
    latest = ckpt.latest()
    if latest and not reset:
        wrapper = ckpt.restore({"train_state": ts, "epoch": np.int64(0)}, latest)
        ts = wrapper["train_state"]
        current_epoch = int(wrapper["epoch"])
        term.message(f"Resumed from {latest} (epoch {current_epoch})")

    epochs = str(args.epochs)
    max_epochs = (current_epoch + int(epochs[1:]) if epochs.startswith("+")
                  else int(epochs))

    stream = _continuous_stream(pipeline, current_epoch)

    def write_train_summary(step: int, metrics: dict | None = None,
                            end_of_epoch: bool = False) -> None:
        w = writers["train"]
        if metrics:
            w.scalars({f"losses/{k}": v for k, v in metrics.items()
                       if k != "grad_finite"}, step)
        model.write_summaries(w, step, ts, summary_batch)
        if getattr(args, "summarize_activations", False):
            stats = model.capture_activations(ts, summary_batch)
            if stats:
                common.write_stat_summaries(w, step, stats, "activations")
        if getattr(args, "summarize_gradients", False):
            stats = model.grad_report(ts, summary_batch)
            if stats:
                common.write_stat_summaries(w, step, stats, "gradients")
        if end_of_epoch and getattr(args, "summarize_weights", False):
            flat = jax.tree_util.tree_flatten_with_path(ts["params"])[0]
            for path, leaf in flat:
                name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                for p in path)
                host = np.asarray(jax.device_get(leaf))
                w.histogram(f"weights/{name}", host, step)
                w.scalar(f"weights_mean/{name}", float(host.mean()), step)

    if int(jax.device_get(ts["step"])) == 0 and current_epoch == 0:
        term.message("Generating baseline summaries and checkpoint...")
        ckpt.save({"train_state": ts, "epoch": np.int64(0)}, 0)
        write_train_summary(0)

    profiling = False
    if args.profile:
        profile_dir = os.path.join(args.dir, "profile")
        os.makedirs(profile_dir, exist_ok=True)

    term.message("Starting training...")
    start_time = time.time()
    for epoch in range(current_epoch, max_epochs):
        iterator = range(batches)
        if tqdm is not None:
            iterator = tqdm(iterator, desc=f"Epoch {epoch + 1:3d}", unit="batch",
                            leave=False)
        avg = MovingAverage()
        shown = {}  # previously displayed values for the +/-/~ markers
        # --summary_freq overrides the reference cadence (10x/epoch for the
        # first 3 epochs, then 3x/epoch — hem/util/training.py:143-150)
        per_epoch = (args.summary_freq if getattr(args, "summary_freq", 0)
                     else (10 if epoch < 3 else 3))
        cadence = max(batches // per_epoch, 1)
        # Metric fetch interval: each host_scalars call is a device->host
        # transfer that SYNCHRONIZES with the just-dispatched step, so
        # fetching every step would leave the device idle while the host
        # dispatches the next one. Fetch every few steps (the tqdm postfix
        # lags a little); --check_numerics restores per-step fetches since
        # the NaN check must see every gradient.
        fetch_every = 1 if args.check_numerics else min(cadence, 4)
        prof_start = min(10, max(batches - 2, 0))
        prof_stop = min(prof_start + 10, batches - 1)
        running: dict = {}
        host_step: int | None = None
        for i in iterator:
            if (args.profile and epoch == current_epoch and i == prof_start
                    and not profiling):
                jax.profiler.start_trace(profile_dir)
                profiling = True
            ts, metrics = model.train(ts, stream)
            if args.profile and profiling and i == prof_stop:
                jax.block_until_ready(ts)
                jax.profiler.stop_trace()
                profiling = False
            if (i % fetch_every == 0 or i % cadence == 0
                    or i == batches - 1):
                # Fold the step counter into the SAME device_get as the
                # metrics — a separate fetch would cost a second
                # synchronizing transfer per summary write.
                host = common.host_scalars({**metrics, "_step": ts["step"]})
                host_step = int(host.pop("_step"))
                if args.check_numerics:
                    common.raise_on_bad_grads(host)
                running = avg.update({k: v for k, v in host.items()
                                      if k != "grad_finite"})
                if tqdm is not None:
                    # v1 postfix UX: each loss carries +/-/~ vs the last
                    # display (reference util.py:196-212)
                    iterator.set_postfix(term.delta_postfix(running, shown))
                    shown = dict(running)
            if i % cadence == 0:
                write_train_summary(host_step, host)

        # the i == batches-1 fetch above guarantees host_step is current
        step = (host_step if host_step is not None
                else int(jax.device_get(ts["step"])))
        write_train_summary(step, running, end_of_epoch=True)
        ckpt.save({"train_state": ts, "epoch": np.int64(epoch + 1)}, epoch + 1)
        if "validate" in splits:
            inference(model, ts, splits["validate"], args, mesh,
                      writers["validate"], step, label="Validation")
        if (epoch + 1) in (args.test_epochs or []) and "test" in splits:
            inference(model, ts, splits["test"], args, mesh,
                      writers["test"], step, label="Test")

    # NOTE: the reference only evaluates the test split when (epoch+1) is in
    # --test_epochs (hem/util/training.py:164-169) and never at end-of-training;
    # default runs must not touch the test set.

    elapsed = int(time.time() - start_time)
    term.message(f"\nTraining complete! Elapsed time: {elapsed}s")
    writers.close()
    return {"train_state": ts, "epoch": max_epochs}


def inference(model, ts, split, args, mesh, writer, step: int, *,
              label: str = "Validation", max_batches: int | None = None) -> dict:
    """Average eval losses over a split and write one summary
    (reference: hem/util/misc.py:85-93)."""
    global_batch = args.batch_size * data_axis_size(mesh)
    keys = getattr(model, "batch_keys", None)
    feeder = None
    if getattr(args, "device_data_cache", True):
        feeder = DeviceDataPipeline.maybe(
            split, global_batch, mesh=mesh, keys=keys, shuffle=False,
            seed=0, budget_mb=getattr(args, "device_cache_mb", 1024))
    if feeder is not None:
        batch_iter = feeder.epoch(0)
    else:
        place = make_place(mesh, split, keys=keys)
        batch_iter = (place(b) for b in
                      split.iter_epoch(global_batch, shuffle=False))
    n = split.batches_per_epoch(global_batch)
    if max_batches:
        n = min(n, max_batches)
    avg = MovingAverage()
    running: dict = {}
    # Dispatch eval batches ahead of the fetch, draining every DRAIN_EVERY
    # queued batches: each device_get synchronizes with the device (vs once
    # per batch naively), while the chunk bound keeps peak HBM O(chunk) —
    # every pending computation pins its placed input batch on device, so
    # an unbounded queue would scale device memory with split size.
    DRAIN_EVERY = 16
    queued = []

    def drain():
        nonlocal running
        for losses in jax.device_get(queued):
            running = avg.update({k: float(v) for k, v in losses.items()})
        queued.clear()

    for batch in batch_iter:
        queued.append(model.eval_losses(ts, batch))
        if len(queued) >= DRAIN_EVERY:
            drain()
        n -= 1
        if n <= 0:
            break
    drain()
    if running:
        writer.scalars({f"losses/{k}": v for k, v in running.items()}, step)
        term.message(f"{label}: " + ", ".join(f"{k}={v:.5g}"
                                              for k, v in running.items()))
    return running
