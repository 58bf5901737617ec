"""Configuration / CLI argument system.

Reproduces the reference UX (reference: hem/util/arguments.py:10-179,
hem/util/misc.py:72-105, train.py:25-37):

* ``@file`` config files with ``key value`` lines and ``#`` comments;
* three-phase parsing: general args -> dataset-plugin args -> model-plugin
  args, chained through ``parse_known_args`` with an unknown-arg warning;
* CLI overrides config file;
* every run's resolved options are dumped to ``<dir>/options.config``
  (re-ingestable) plus a JSON twin.

Deltas: ``--n_gpus`` is kept as an alias for ``--n_devices``
(mesh size); new flags ``--dtype`` (compute dtype) and ``--mesh`` are added.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import uuid

import hemx.utils.terminal as term


class CustomArgumentParser(argparse.ArgumentParser):
    """Parser whose @-files accept `key value` lines and `#` comments
    (reference: hem/util/misc.py:72-82)."""

    def convert_arg_line_to_args(self, arg_line):
        line = arg_line.split("#", 1)[0].strip()
        if not line:
            return []
        parts = line.split()
        if not parts[0].startswith("-"):
            parts[0] = "--" + parts[0]
        return parts


def build_base_parser() -> CustomArgumentParser:
    parser = CustomArgumentParser(
        description="hemx training harness (JAX rebuild of hem).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        fromfile_prefix_chars="@",
        conflict_handler="resolve",
        epilog="Example: python train.py @path/to/config --dir workspace/run --lr 0.1",
    )

    misc = parser.add_argument_group("Miscellaneous")
    misc.add_argument("--seed", type=int, default=None,
                      help="RNG seed; randomized each run when unset.")
    misc.add_argument("--n_devices", "--n_gpus", dest="n_devices", type=int, default=0,
                      help="Devices in the data-parallel mesh (0 = all local devices).")
    misc.add_argument("--model_parallel", type=int, default=1,
                      help="Tensor-parallel degree: shard every conv/dense/"
                           "deconv kernel's last channel dim (output channels"
                           " for conv/dense, input channels for deconv's "
                           "[H,W,out,in] layout) over a second 'model' mesh "
                           "axis of this size (must divide the device "
                           "count). 1 = pure data parallelism. No reference "
                           "analogue — the scaling dimension for models too "
                           "large for one device's memory.")
    misc.add_argument("--spatial_parallel", type=int, default=1,
                      help="Spatial-parallel degree: shard every image "
                           "tensor's height dim over a 'spatial' mesh axis "
                           "of this size (must divide the device count and "
                           "the image height); GSPMD inserts the conv halo "
                           "exchanges. 1 = off. The sharded form of the "
                           "reference's patch-based spatial decomposition "
                           "(paper_fullimage.py:302-316) for images whose "
                           "activations outgrow one chip's HBM.")
    misc.add_argument("--profile", action="store_true", default=False,
                      help="Capture a jax.profiler trace of the first training steps "
                           "into <dir>/profile (actually wired, unlike the reference's "
                           "vestigial flag — train.py:262-265).")
    misc.add_argument("--check_numerics", action="store_true", default=False,
                      help="Check gradients for NaN/Inf each step and abort with the "
                           "offending parameter named (reference: hem/util/training.py:52-53).")
    misc.add_argument("--debug_nans", action="store_true", default=False,
                      help="Enable jax_debug_nans: raise at the first NaN-producing "
                           "op anywhere (slower; finer-grained than --check_numerics).")
    misc.add_argument("--summarize_activations", action="store_true",
                      default=False,
                      help="Write per-layer activation mean/zero-fraction/"
                           "histogram at every summary write (the reference's "
                           "inline per-layer summaries, hem/ops/layers.py:121-131 "
                           "— opt-in, adds one capture forward per write).")
    misc.add_argument("--summarize_gradients", action="store_true",
                      default=False,
                      help="Write per-variable gradient mean + histogram at "
                           "every summary write (reference: "
                           "hem/ops/summaries.py:64-75 — opt-in, adds one "
                           "backward pass per write).")
    misc.add_argument("--summarize_weights", action="store_true", default=False,
                      help="Write per-parameter histograms + means at each epoch end "
                           "(the reference's per-layer weight summaries, "
                           "hem/ops/summaries.py:52-61 — opt-in, they are large).")
    misc.add_argument("--model", type=str.lower, default="cnn",
                      help="Model plugin to train.")
    misc.add_argument("--examples", type=int, default=64,
                      help="Number of example images in montage summaries.")

    train = parser.add_argument_group("Training")
    train.add_argument("--epochs", default="3",
                       help="Epochs this run: integer for max, or +n for n more from checkpoint.")
    train.add_argument("--batch_size", type=int, default=256,
                       help="Batch size per device (global batch = batch_size * n_devices), "
                            "matching the reference's per-GPU meaning.")
    train.add_argument("--epoch_size", type=int, default=-1,
                       help="Iterations per epoch (-1 = full dataset).")
    train.add_argument("--dir", type=str, default=None,
                       help="Workspace dir (checkpoints, events, options.config). "
                            "A populated dir resumes training.")
    train.add_argument("--max_to_keep", type=int, default=0,
                       help="Recent checkpoints to keep; 0 keeps all.")
    train.add_argument("--test_epochs", nargs="*", type=int, default=[],
                       help="Epochs at which to run the test split.")
    train.add_argument("--summary_freq", type=int, default=0,
                       help="Extra in-epoch summaries (0 = reference cadence: "
                            "10x/epoch first 3 epochs then 3x/epoch).")
    train.add_argument("--dtype", type=str.lower, default="float32",
                       choices=["float32", "bfloat16"],
                       help="Compute dtype for the forward/backward pass "
                            "(params stay float32).")
    train.add_argument("--precision", type=str.lower, default="default",
                       choices=["default", "high", "highest"],
                       help="Matmul/conv precision for float32 operands: "
                            "'default' lets XLA pick (on the GPU: TF32 tensor "
                            "cores, fast); 'highest' = full f32 for strict "
                            "reference parity.")
    train.add_argument("--deconv_impl", type=str.lower, default="dilated",
                       choices=["dilated", "phase_split"],
                       help="Transposed-conv lowering: 'dilated' = textbook "
                            "lhs-dilated conv; 'phase_split' = same values "
                            "as s^2 dense convs + interleave (skips the "
                            "dilated form's zero-stuffed multiplies).")

    opt = parser.add_argument_group("Optimizer")
    opt.add_argument("--optimizer", type=str.lower, default="rmsprop")
    opt.add_argument("--lr", type=float, default=0.001)
    opt.add_argument("--loss", type=str.lower, default="l1")
    opt.add_argument("--momentum", type=float, default=0.01)
    opt.add_argument("--decay", type=float, default=0.9)
    opt.add_argument("--centered", action="store_true", default=False)
    opt.add_argument("--beta1", type=float, default=0.9)
    opt.add_argument("--beta2", type=float, default=0.999)

    data = parser.add_argument_group("Data")
    data.add_argument("--dataset", type=str.lower, default="floorplan")
    data.add_argument("--shuffle", action=argparse.BooleanOptionalAction,
                      default=True,
                      help="Shuffle training batches (--no-shuffle for "
                           "deterministic-order runs).")
    data.add_argument("--buffer_size", type=int, default=10000,
                      help="Shuffle buffer size (reference: data.py:49).")
    data.add_argument("--resize", type=int, nargs=2, default=None,
                      metavar=("H", "W"),
                      help="Resize input images at the input layer for any "
                           "dataset (reference: train.py:162-166,226-228 — "
                           "TF1-bilinear semantics; nyuv2's plugin arg of "
                           "the same name takes precedence there).")
    data.add_argument("--grayscale", action="store_true", default=False,
                      help="Convert RGB input images to single-channel luma "
                           "(reference: train.py:175-178,229-231 — there it "
                           "crashed its hardcoded-3-channel models; hemx "
                           "models derive channels from the data, so it "
                           "works end to end).")
    data.add_argument("--cache_dir", default=None,
                      help="On-disk cache location; in-memory cache when unset.")
    data.add_argument("--raw_dataset_dir", default="/tmp")
    data.add_argument("--dataset_dir", default="datasets")
    data.add_argument("--n_threads", type=int, default=os.cpu_count() or 1)
    data.add_argument("--device_data_cache",
                      action=argparse.BooleanOptionalAction, default=True,
                      help="Keep the whole compact dataset in device memory "
                           "and assemble batches on-chip (jitted gather + "
                           "normalize) when it fits --device_cache_mb: no "
                           "per-step H2D. Splits that don't qualify "
                           "(host-side augmentation, multi-process, too "
                           "large) stream via the host pipeline as before.")
    data.add_argument("--device_cache_mb", type=int, default=1024,
                      help="HBM budget for --device_data_cache, per split.")
    return parser


def parse_args(argv=None, display: bool = False):
    """Three-phase parse (reference: hem/util/arguments.py:152-171).

    ``--config FILE`` (v1 semantics, train.py:25-37) is rewritten to the
    ``@FILE`` form, which argparse re-expands in every phase so
    plugin-contributed flags inside config files resolve too."""
    import sys

    from hemx.data.plugin import get_dataset
    from hemx.models.plugin import get_model

    argv = list(sys.argv[1:] if argv is None else argv)
    while "--config" in argv:
        i = argv.index("--config")
        argv[i:i + 2] = ["@" + argv[i + 1]]

    parser = build_base_parser()
    args, leftover = parser.parse_known_args(argv)

    dataset_cls = get_dataset(args.dataset)
    if dataset_cls is not None:
        for k, v in dataset_cls.arguments().items():
            parser.add_argument(k, **v)
        args, leftover = parser.parse_known_args(leftover, namespace=args)

    model_cls = get_model(args.model)
    if model_cls is not None:
        for k, v in model_cls.arguments().items():
            parser.add_argument(k, **v)
        args, leftover = parser.parse_known_args(leftover, namespace=args)

    if leftover:
        term.message(f"WARNING: unknown and unused arguments provided: {leftover}",
                     format_style=term.WARNING)

    # record which flags are BooleanOptionalAction (incl. plugin-contributed
    # ones) so dump_options writes False values in their no- form — a bare
    # omission would silently re-enable a default-true flag on re-ingest.
    # Underscore-prefixed: skipped by the dump itself.
    args._negatable = {a.dest for a in parser._actions
                       if isinstance(a, argparse.BooleanOptionalAction)}

    if args.seed is None:
        args.seed = int.from_bytes(os.urandom(4), "little")
    random.seed(args.seed)

    if args.dir is None:
        args.dir = os.path.join("workspace", str(uuid.uuid4()))

    if display:
        for a in sorted(vars(args)):
            print(f"    {a} = {getattr(args, a)}")
    return args


def default_args(**overrides):
    """Args namespace with every CLI default resolved, no side effects.

    Programmatic entry (bench.py, __graft_entry__.py, tests) — equivalent to
    parsing an empty command line plus the requested plugin args."""
    import types

    ns = types.SimpleNamespace()
    parser = build_base_parser()
    for action in parser._actions:
        if action.dest not in ("help",):
            setattr(ns, action.dest, action.default)
    # plugin-contributed defaults commonly needed programmatically
    extra = dict(latent_size=200, n_disc_train=5, vae_parity_loss=False,
                 synthetic_count=1024, synthetic_shape=[64, 64, 3],
                 synthetic_eval_count=0, synthetic_u8=False,
                 cifar_resize=0, seed=42)
    for k, v in extra.items():
        setattr(ns, k, v)
    ns.dir = None
    for k, v in overrides.items():
        setattr(ns, k, v)
    return ns


def init_working_dir(args) -> str:
    """Create the workspace and dump resolved options
    (reference: hem/util/misc.py:96-105, train.py:206-213)."""
    os.makedirs(args.dir, exist_ok=True)
    dump_options(args, os.path.join(args.dir, "options.config"))
    with open(os.path.join(args.dir, "options.json"), "w") as f:
        json.dump({k: _jsonable(v) for k, v in vars(args).items()
                   if not k.startswith("_")}, f, indent=2, sort_keys=True)
    return args.dir


# Default-true booleans with a BooleanOptionalAction --no-<flag> companion:
# these must be dumped in their negative form when False or the
# options.config round-trip would silently re-enable them. parse_args
# derives the live set from the parser's actions (args._negatable, covers
# plugin flags too); this hardcoded set is the fallback for namespaces
# built without parse_args (tests, default_args).
_NEGATABLE_FLAGS = {"shuffle", "fused_critic_loop", "device_data_cache"}


def dump_options(args, path: str) -> None:
    negatable = getattr(args, "_negatable", _NEGATABLE_FLAGS)
    with open(path, "w") as f:
        f.write("# hemx resolved options (re-ingestable with @thisfile)\n")
        for k in sorted(vars(args)):
            if k.startswith("_"):  # bookkeeping, not a flag
                continue
            v = getattr(args, k)
            if isinstance(v, bool):
                if v:
                    f.write(f"{k}\n")
                elif k in negatable:
                    f.write(f"no-{k}\n")
            elif isinstance(v, (list, tuple)):
                if v:
                    f.write(f"{k} {' '.join(str(i) for i in v)}\n")
            elif v is not None:
                f.write(f"{k} {v}\n")


def load_options(path: str) -> dict:
    """Read an options.json back into a dict (post-hoc tooling rebuilds the
    model from this instead of TF meta-graph surgery —
    reference: paper_metrics.py:54-72)."""
    with open(path) as f:
        return json.load(f)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(i) for i in v]
    return str(v)
