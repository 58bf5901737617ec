"""Host-side input pipeline.

Rebuild of the reference's tf.data flow — map(parse) -> cache -> repeat ->
shuffle(buffer) -> batch (data.py:34-60, hem/util/data.py:73-77) — as plain
numpy on the host, feeding devices through an async prefetcher.

Deviations (documented):
* the cache stores *compact* decoded samples (e.g. uint8 images); float
  normalization runs per-batch (``Split.batch_transform``). Numerics are
  identical; memory is ~4x smaller than the reference's post-map cache.
* shuffling permutes the whole epoch (seeded per epoch) instead of a
  10k-element streaming buffer — a strictly stronger shuffle.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from hemx.data.tfrecord import read_all_records


class ArraySource:
    """In-memory source: dict of equal-length numpy arrays."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        self.arrays = arrays
        lengths = {len(v) for v in arrays.values()}
        assert len(lengths) == 1, "all arrays must share leading dim"
        self._n = lengths.pop()

    def __len__(self) -> int:
        return self._n

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class TFRecordSource:
    """TFRecord-backed source; parses per record and caches compactly.

    ``parse`` maps record bytes -> dict of numpy arrays (one sample).
    """

    def __init__(self, paths: list[str], parse: Callable[[bytes], dict],
                 cache: bool = True,
                 sample_filter: Optional[Callable[[dict], bool]] = None):
        self.paths = paths
        self.parse = parse
        self._cache_enabled = cache
        self._filter = sample_filter
        self._records: Optional[list[bytes]] = None
        self._materialized: Optional[ArraySource] = None

    def _load_records(self) -> list[bytes]:
        if self._records is None:
            recs: list[bytes] = []
            for p in self.paths:
                recs.extend(read_all_records(p))
            self._records = recs
        return self._records

    def _materialize(self) -> ArraySource:
        if self._materialized is None:
            samples = [self.parse(r) for r in self._load_records()]
            if self._filter is not None:
                samples = [s for s in samples if self._filter(s)]
            if not samples:
                raise ValueError(f"no records in {self.paths}")
            arrays = {k: np.stack([s[k] for s in samples])
                      for k in samples[0]}
            self._materialized = ArraySource(arrays)
            if self._cache_enabled:
                self._records = None  # free raw bytes
        return self._materialized

    def __len__(self) -> int:
        return len(self._materialize())

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return self._materialize().batch(idx)


class Split:
    """One dataset split with reference batching semantics.

    Batch count per epoch = floor(count / global_batch) (drop remainder,
    matching tf.data batch + the reference's iterations-per-epoch math).
    """

    def __init__(self, source, *, batch_transform: Optional[Callable] = None,
                 name: str = "train", transform_needs_rng: bool = False,
                 device_transform: Optional[Callable] = None):
        self.source = source
        self.batch_transform = batch_transform
        self.name = name
        # device_transform: jittable dict->dict applied AFTER device
        # placement. Datasets use it to ship compact uint8 images over the
        # host->device link and normalize on the device
        # (hemx.ops.normalize.u8_normalize, fused by XLA; replaces the
        # reference's host-side /255 in tf.data map fns)
        self.device_transform = device_transform
        # transform_needs_rng: batch_transform takes (batch, rng) and applies
        # per-draw augmentation (e.g. NYUv2 joint random crops, which the
        # reference re-sampled every epoch via tf.random_crop in the map fn —
        # hem/data/nyuv2.py:192-208; hemx caches decoded samples and crops at
        # batch-assembly time instead)
        self.transform_needs_rng = transform_needs_rng

    @property
    def count(self) -> int:
        return len(self.source)

    def batches_per_epoch(self, global_batch: int) -> int:
        return self.count // global_batch

    def iter_epoch_indices(self, global_batch: int, *, shuffle: bool = True,
                           seed: int = 0,
                           epoch: int = 0) -> Iterator[np.ndarray]:
        """The epoch's batch index slices (the shuffle half of iter_epoch).
        Device-resident feeding (DeviceDataPipeline) consumes these directly
        so only ~KB of indices cross the host->device link per batch."""
        n = self.count
        nb = n // global_batch
        if shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        for b in range(nb):
            yield order[b * global_batch:(b + 1) * global_batch]

    def iter_epoch(self, global_batch: int, *, shuffle: bool = True,
                   seed: int = 0, epoch: int = 0) -> Iterator[dict]:
        for b, idx in enumerate(self.iter_epoch_indices(
                global_batch, shuffle=shuffle, seed=seed, epoch=epoch)):
            batch = self.source.batch(idx)
            if self.batch_transform is not None:
                if self.transform_needs_rng:
                    brng = np.random.default_rng(
                        np.random.SeedSequence([seed, epoch, b]))
                    batch = self.batch_transform(batch, brng)
                else:
                    batch = self.batch_transform(batch)
            yield batch


def to_grayscale(split: Split, key: str = "image") -> Split:
    """``--grayscale``: convert a split's RGB images to single-channel luma
    (reference: train.py:229-231, tf.image.rgb_to_grayscale — ITU-R BT.601
    weights 0.2989/0.5870/0.1140).

    The conversion happens ONCE on the materialized compact arrays, so the
    model inits with 1-channel inputs and the split stays eligible for the
    device-resident cache (at a third of the HBM). Deviations (documented):
    uint8 sources stay uint8 with luma rounded to nearest — at most 0.5/255
    from the reference's convert-after-/255 float path; non-RGB leaves
    (e.g. 1-channel MNIST) pass through untouched, where the reference's
    flag crashed its own hardcoded-3-channel models.
    """
    # Memoize per ORIGINAL source object: datasets alias sources across
    # splits (e.g. cifar's validate shares test's source), and both the
    # host copy and the _device_arrays HBM memo rely on that aliasing —
    # converting each split independently would double host RAM, run the
    # conversion twice, and place two identical copies in device memory.
    memo = getattr(split.source, "_grayscale_source", None)
    if memo is not None and key in memo:
        split.source = memo[key]
        return split
    try:
        arrays = DeviceDataPipeline._source_arrays(split)
    except TypeError:
        raise ValueError(
            f"--grayscale: split '{split.name}' has no in-memory image "
            f"arrays to convert") from None
    img = arrays.get(key)
    if img is None or img.ndim != 4 or img.shape[-1] != 3:
        return split
    w = np.array([0.2989, 0.5870, 0.1140], np.float32)
    luma = img.astype(np.float32) @ w
    if img.dtype == np.uint8:
        luma = np.round(luma).astype(np.uint8)
    else:
        luma = luma.astype(img.dtype)
    converted = ArraySource({**arrays, key: luma[..., None]})
    if memo is None:
        memo = split.source._grayscale_source = {}
    memo[key] = converted
    split.source = converted
    return split


def _tf1_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """TF1 `tf.image.resize_images` default bilinear (align_corners=False):
    src coordinate = dst index * (in/out) — NO half-pixel offset (the
    TF1 corner convention the reference ran under) — with edge clamp."""
    n, ih, iw, c = img.shape
    ys = np.arange(h, dtype=np.float64) * (ih / h)
    xs = np.arange(w, dtype=np.float64) * (iw / w)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    f = img.astype(np.float32)
    r0 = f[:, y0]
    r1 = f[:, y1]
    top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
    bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_images(split: Split, size, key: str = "image") -> Split:
    """``--resize H W``: resize a split's images at the input layer for ANY
    dataset (reference: train.py:162-166,226-228 tf.image.resize_images on
    the pipeline tensor; its help text says 'w x h' but the value is passed
    straight to resize_images, whose size is [height, width] — the actual
    behavior, reproduced here).

    One-time conversion of the materialized compact arrays (the model then
    inits at the resized shape and the split stays device-cache eligible),
    memoized per original source like to_grayscale so aliased splits share
    one converted copy. uint8 sources stay uint8 (rounded), matching the
    --grayscale deviation note.
    """
    h, w = int(size[0]), int(size[1])
    memo = getattr(split.source, "_resize_source", None)
    if memo is not None and (key, h, w) in memo:
        split.source = memo[(key, h, w)]
        return split
    try:
        arrays = DeviceDataPipeline._source_arrays(split)
    except TypeError:
        raise ValueError(
            f"--resize: split '{split.name}' has no in-memory image "
            f"arrays to convert") from None
    img = arrays.get(key)
    if img is None or img.ndim != 4:
        return split
    if img.shape[1:3] == (h, w):  # already at target (e.g. the nyuv2
        return split              # plugin consumed --resize in its parse)
    out = _tf1_bilinear(img, h, w)
    if img.dtype == np.uint8:
        out = np.round(np.clip(out, 0, 255)).astype(np.uint8)
    else:
        out = out.astype(img.dtype)
    converted = ArraySource({**arrays, key: out})
    if memo is None:
        memo = split.source._resize_source = {}
    memo[(key, h, w)] = converted
    split.source = converted
    return split


def u8_image_device_transform(keys=("image",), lo: float = 0.0,
                              hi: float = 1.0):
    """Standard device transform: uint8 image channels -> float [lo, hi]
    (hemx.ops.normalize.u8_normalize, which XLA fuses into its consumer)."""
    def transform(batch: dict) -> dict:
        from hemx.ops.normalize import u8_normalize
        out = dict(batch)
        for k in keys:
            if k in out:
                out[k] = u8_normalize(out[k], lo, hi)
        return out
    return transform


def make_place_stages(mesh, split=None, keys=None):
    """(transfer, transform): the two halves of host-batch placement.

    ``transfer`` (safe on the prefetch thread) drops keys the model never
    reads and device_puts the sharded batch — pure H2D, no XLA program.
    ``transform`` (consumer thread ONLY) dispatches the split's jitted
    device transform (e.g. uint8 -> float normalization).

    The split matters: every multi-device XLA program must be enqueued from
    ONE thread so per-device queues see collectives in one order — the CPU
    backend's in-process collectives hard-deadlock on cross-thread enqueue
    interleaving, and ordering discipline is correct on real meshes too.
    """
    import jax
    from hemx.parallel.dp import shard_batch

    dt = getattr(split, "device_transform", None) if split is not None else None
    jdt = jax.jit(dt) if dt is not None else None

    def transfer(b):
        if keys:
            b = {k: v for k, v in b.items() if k in keys}
        return shard_batch(b, mesh)

    def transform(b):
        return jdt(b) if jdt is not None else b

    return transfer, transform


def make_place(mesh, split=None, keys=None):
    """Single-threaded placement: transfer + transform in one call
    (summary batches, inference loops). For the prefetch Pipeline use
    make_place_stages so the jitted transform stays on the consumer thread.
    """
    transfer, transform = make_place_stages(mesh, split, keys)
    return lambda b: transform(transfer(b))


def make_group_place_stages(mesh, split=None, keys=None):
    """(transfer, transform) for GROUPED streaming placement
    (``Pipeline(group=k)``).

    ``transfer`` (prefetch thread) concatenates a LIST of k host batches
    and ships them as ONE sharded device_put — one H2D transfer per k
    batches instead of k. ``transform``
    (consumer thread ONLY — the single-enqueue-thread discipline of
    make_place_stages) splits the super-batch back into k device batches
    with one jitted program, applying the split's device transform to
    each, with out_shardings pinned to the canonical batch layout (the
    same contract as DeviceDataPipeline's grouped gather). Values and
    order are identical to the per-batch path (equality-tested:
    tests/test_data.py::TestGroupedStreaming).

    Why: the per-batch streaming path pays a transfer dispatch per batch,
    which dominates when batches are small and a train call pulls several
    of them (WGAN/IWGAN). Whether grouping pays on the H100's PCIe link is
    not measured yet (ROADMAP speed item 6). The epoch tail (k' < k
    batches) compiles one extra split program.
    """
    import jax
    from hemx.parallel.dp import shard_batch
    from hemx.parallel.mesh import batch_shardings

    dt = getattr(split, "device_transform", None) if split is not None else None

    def transfer(batches: list) -> tuple:
        if keys:
            batches = [{k: v for k, v in b.items() if k in keys}
                       for b in batches]
        k = len(batches)
        if k == 1:
            return 1, shard_batch(batches[0], mesh)
        joined = {key: np.concatenate([b[key] for b in batches])
                  for key in batches[0]}
        return k, shard_batch(joined, mesh)

    jitted: dict = {}

    def transform(item) -> tuple:
        import jax.numpy as jnp
        k, joined = item
        if k == 1:
            b = joined
            if dt is not None:
                fn = jitted.get(1)
                if fn is None:
                    fn = jitted[1] = jax.jit(dt)
                b = fn(b)
            return (b,)
        fn = jitted.get(k)
        if fn is None:
            # batch_spec depends only on rank and H, which splitting along
            # axis 0 preserves — the super-batch's sharding tree IS each
            # part's sharding tree
            sh = batch_shardings(mesh, joined)

            def split_transform(j, _k=k):
                parts = {key: jnp.split(v, _k) for key, v in j.items()}
                out = []
                for i in range(_k):
                    b = {key: v[i] for key, v in parts.items()}
                    out.append(dt(b) if dt is not None else b)
                return tuple(out)

            fn = jitted[k] = jax.jit(
                split_transform, out_shardings=tuple(sh for _ in range(k)))
        return fn(joined)

    return transfer, transform


class DeviceDataPipeline:
    """Device-resident dataset feeding: the whole (compact, e.g. uint8)
    dataset is placed in device memory ONCE and batches are assembled
    on-device by a jitted gather + device_transform, so per-batch traffic
    over the host->device link is a ~KB index slice instead of megabytes
    of image data.

    Why this exists: batch assembly + normalization happen on the device
    with no per-step H2D of image data, so the input pipeline cannot
    become the bottleneck for datasets that fit the budget (the reference
    kept its post-map cache in HOST RAM and shipped float batches every
    step — data.py:34-60).

    Eligibility (see :meth:`maybe`): single process, in-memory source
    (ArraySource or materialized TFRecordSource), no host-side
    batch_transform, total bytes within budget. The placed arrays are
    memoized on the Split so train + per-epoch validation reuse one copy.
    """

    def __init__(self, split: Split, global_batch: int, *, mesh,
                 keys=None, shuffle: bool = True, seed: int = 0,
                 group: int = 1):
        import jax
        from hemx.parallel.mesh import (batch_shardings, data_sharding,
                                        replicated_sharding)

        self.split = split
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        self.group = max(int(group), 1)
        self._data = data_sharding(mesh)
        repl = replicated_sharding(mesh)

        arrays = self._source_arrays(split)
        use = {k: v for k, v in arrays.items() if not keys or k in keys}
        # Per-key output shardings: rows over 'data', image height over
        # 'spatial' on a spatial mesh (gathers preserve rank, and the
        # device_transform is shape/structure-preserving by contract).
        batch_sh = batch_shardings(mesh, use)
        cache_key = (tuple(sorted(use)), id(mesh))
        # memoized on the SOURCE, not the Split: validate/test splits alias
        # one source (e.g. mnist), and per-split memoization would place
        # the same dataset in HBM once per split
        memo = getattr(split.source, "_device_arrays", None)
        if memo is None:
            memo = split.source._device_arrays = {}
        if cache_key not in memo:
            memo[cache_key] = {k: jax.device_put(v, repl)
                               for k, v in use.items()}
        self.ds = memo[cache_key]

        dt = split.device_transform

        def assemble(ds, idx):
            import jax.numpy as jnp
            batch = {k: jnp.take(v, idx, axis=0) for k, v in ds.items()}
            return dt(batch) if dt is not None else batch

        self._assemble = jax.jit(assemble, in_shardings=(repl, self._data),
                                 out_shardings=batch_sh)

        def assemble_group(ds, idx):
            """``group`` batches from ONE flat [group*B] index gather:
            one program per train call instead of one per batch (6 for
            the WGAN/IWGAN 5-critic+G call). Values are identical to
            ``group`` separate assembles of the same index slices.
            """
            import jax.numpy as jnp
            gathered = {k: jnp.take(v, idx, axis=0) for k, v in ds.items()}
            parts = {k: jnp.split(v, self.group) for k, v in gathered.items()}
            out = []
            for i in range(self.group):
                batch = {k: v[i] for k, v in parts.items()}
                out.append(dt(batch) if dt is not None else batch)
            return tuple(out)

        self._assemble_group = (jax.jit(assemble_group,
                                        in_shardings=(repl, self._data),
                                        out_shardings=tuple(
                                            batch_sh for _ in range(self.group)))
                                if self.group > 1 else None)
        self._place_idx = lambda idx: jax.device_put(
            np.asarray(idx, np.int32), self._data)

    @staticmethod
    def _source_arrays(split: Split):
        src = split.source
        if isinstance(src, ArraySource):
            return src.arrays
        if isinstance(src, TFRecordSource):
            return src._materialize().arrays
        raise TypeError(f"no in-memory arrays for {type(src).__name__}")

    @classmethod
    def maybe(cls, split: Split, global_batch: int, *, mesh, keys=None,
              shuffle: bool = True, seed: int = 0,
              budget_mb: int = 1024, group: int = 1):
        """The pipeline if the split qualifies, else None (caller falls
        back to the host-streaming Pipeline). Instances are memoized on the
        split so repeated callers (per-epoch validation) reuse one jitted
        assemble program instead of recompiling."""
        import jax
        if jax.process_count() > 1:
            return None
        if split.batch_transform is not None:
            return None
        memo_key = (global_batch, tuple(sorted(keys or ())), shuffle, seed,
                    id(mesh), max(int(group), 1))
        memo = getattr(split, "_device_pipelines", None)
        if memo is None:
            memo = split._device_pipelines = {}
        if memo_key in memo:
            return memo[memo_key]
        try:
            arrays = cls._source_arrays(split)
        except TypeError:
            return None
        use = {k: v for k, v in arrays.items() if not keys or k in keys}
        if not use:
            return None
        if sum(v.nbytes for v in use.values()) > budget_mb * 1024 * 1024:
            return None
        memo[memo_key] = cls(split, global_batch, mesh=mesh, keys=keys,
                             shuffle=shuffle, seed=seed, group=group)
        return memo[memo_key]

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Device batches for one epoch — same seeded order as the host
        Pipeline. All XLA dispatch happens on the caller's thread (the
        single-thread enqueue discipline of make_place_stages holds by
        construction: there is no producer thread). With ``group`` > 1,
        ``group`` consecutive batches are assembled by one gather program
        (identical values/order; the epoch tail that doesn't fill a group
        falls back to the per-batch program)."""
        pending: list[np.ndarray] = []
        for idx in self.split.iter_epoch_indices(
                self.global_batch, shuffle=self.shuffle, seed=self.seed,
                epoch=epoch):
            if self._assemble_group is None:
                yield self._assemble(self.ds, self._place_idx(idx))
                continue
            pending.append(idx)
            if len(pending) == self.group:
                flat = np.concatenate(pending)
                pending = []
                yield from self._assemble_group(self.ds,
                                                self._place_idx(flat))
        for idx in pending:
            yield self._assemble(self.ds, self._place_idx(idx))


class Pipeline:
    """Background-threaded prefetch of host batches onto devices.

    Two-deep by default: while the device runs step N, the host assembles and
    transfers batch N+1 (replaces tf.data's prefetching; SURVEY.md §2.9 item 9).

    ``group=k`` (with the make_group_place_stages place/post pair) ships k
    consecutive batches per H2D transfer: the worker hands ``place`` a LIST
    of k host batches (the epoch tail may be shorter) and the consumer
    fans the tuple that ``post`` returns back out into single batches —
    same values, same order, 1/k-th the transfer round trips.
    """

    def __init__(self, split: Split, global_batch: int, *, shuffle: bool = True,
                 seed: int = 0, place: Optional[Callable] = None,
                 post: Optional[Callable] = None, depth: int = 2,
                 group: int = 1):
        self.split = split
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        self.place = place or (lambda x: x)
        # post runs on the CONSUMER thread (jitted device transforms must be
        # enqueued from one thread — see make_place_stages)
        self.post = post or (lambda x: x)
        self.depth = depth
        self.group = max(int(group), 1)

    def epoch(self, epoch: int) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err: list[BaseException] = []
        grouped = self.group > 1

        def worker():
            try:
                pending: list = []
                for batch in self.split.iter_epoch(
                        self.global_batch, shuffle=self.shuffle,
                        seed=self.seed, epoch=epoch):
                    if not grouped:
                        q.put(self.place(batch))
                        continue
                    pending.append(batch)
                    if len(pending) == self.group:
                        q.put(self.place(pending))
                        pending = []
                if pending:
                    q.put(self.place(pending))
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if grouped:
                yield from self.post(item)
            else:
                yield self.post(item)
        t.join()
        if err:
            raise err[0]
