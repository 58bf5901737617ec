"""hemx — a JAX/XLA rebuild of the `hem` autoencoder/GAN framework.

hemx re-implements, on JAX, every capability of the reference framework
(`algoterranean/3dgan`, a TF-1.x research stack for convolutional autoencoders,
VAEs, GAN/WGAN/IWGAN, pix2pix and a monocular-depth-estimation cGAN model zoo):

* a functional ops layer (dense/conv2d/deconv2d/residual, lrelu/selu, losses,
  image ops) replacing ``hem/ops`` — NHWC, pure functions over explicit pytrees;
* a plugin data layer (TFRecord IO without TensorFlow, dataset plugins with
  check/download/convert/parse) replacing ``hem/data``;
* a plugin model zoo replacing ``hem/models`` and v1 ``models/``;
* data parallelism via ``jax.sharding`` meshes + jit-inserted collectives,
  replacing the reference's in-graph GPU towers + CPU gradient averaging
  (reference: hem/util/scoping.py:66-89, hem/util/training.py:23-56);
* a training loop with epoch-keyed checkpoints, resume, ``+n`` epoch semantics
  (reference: hem/util/training.py:98-175);
* TensorBoard-compatible tfevents writing without TensorFlow
  (reference write path: hem/ops/summaries.py).

Layout is NHWC end-to-end; the reference v2 used NCHW
(hem/ops/layers.py:117-119) — conversion helpers live in ``hemx.ops.images``.
"""

__version__ = "0.1.0"

from hemx.core import Ctx, Layer, sequential, parallel_sum, identity
from hemx.ops.layers import (
    dense, conv2d, deconv2d, flatten, reshape, residual,
    batch_norm, instance_norm, dropout, activation,
)
from hemx.ops.activations import lrelu, selu, value_fraction
from hemx.ops.losses import rmse, rmse_scale_invariant, l1_loss, l2_loss
from hemx.ops.images import rescale, center_crop, crop_to_bounding_box, colorize, nhwc_to_nchw, nchw_to_nhwc
from hemx.utils.terminal import message, INFO, WARNING, ERROR
from hemx.config import parse_args, CustomArgumentParser, init_working_dir
from hemx.data.plugin import DataPlugin, get_dataset, get_dataset_tensors
from hemx.models.plugin import ModelPlugin, get_model
from hemx.train.optimizers import init_optimizer
from hemx.train.checkpoint import CheckpointManager
from hemx.train.loop import train, inference
from hemx.summaries.events import EventsWriter, SummaryWriterSet
from hemx.summaries.reader import get_all_events, get_tag_values
