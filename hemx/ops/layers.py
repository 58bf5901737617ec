"""Functional layer constructors.

JAX rebuild of the reference layer vocabulary
(reference: ops/layers.py — v1 NHWC; hem/ops/layers.py — v2 NCHW).
hemx is NHWC end-to-end, the layout XLA's GPU backend hands to cuDNN for
tensor-core convolutions.

Parity decisions (recorded per SURVEY.md §7.2 step 2):

* Xavier-uniform init for weights **and** biases (reference quirk,
  ops/layers.py:52-53).
* conv2d: SAME padding default; explicit ``padding`` arg supported (v2 adds
  VALID, hem/ops/layers.py).
* deconv2d semantics == ``tf.nn.conv2d_transpose``: the kernel is stored as
  ``[H, W, out, in]`` and the op is the gradient/transpose of the matching
  forward convolution (reference: ops/layers.py:137-145). v1 always produced
  exactly 2x spatial upsampling (output_shape computed as 2*input); v2 takes an
  explicit ``output_shape`` (hem/ops/layers.py:145,185-187). We support both:
  default ``out_hw=None`` doubles H and W; pass ``out_hw=(H, W)`` to override.
* batch_norm: TF contrib defaults — decay 0.999, epsilon 1e-3, center=True,
  scale=False — and, like the reference (which never passes is_training=False),
  **batch statistics are used in both training and eval** by default; moving
  averages are still tracked so ``eval_stats='moving'`` is available.
  Cross-replica behavior: under jit-with-sharding the batch statistics are
  computed over the *global* batch (XLA inserts the collectives), which is a
  documented improvement over the reference's unsynced last-tower-wins updates
  (models/gan.py:69-70).
* residual: two 3x3 convs where the shortcut is conv1's pre-norm output and is
  added to conv2's post-norm output (reference: hem/ops/layers.py:215-320,
  including its quirk that the ``dropout`` arg is used as *keep_prob*).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from hemx.core import Ctx, Layer
from hemx.ops import initializers

_CONV_DIMS = ("NHWC", "HWIO", "NHWC")

# Global precision policy for float32 convs and matmuls. 'default' lets
# XLA choose; on the GPU it may run them on TF32 tensor cores (about three
# decimal digits), and it is hemx's default. 'highest' keeps full f32 for
# strict numerical parity with the reference's f32 GPU math — enable via
# --precision highest. Golden unit tests run on CPU where 'default' is
# already exact f32. bf16 operands (--dtype bfloat16) are unaffected.
_PRECISION = lax.Precision.DEFAULT


def set_default_precision(name: str) -> None:
    global _PRECISION
    _PRECISION = {"highest": lax.Precision.HIGHEST,
                  "high": lax.Precision.HIGH,
                  "default": lax.Precision.DEFAULT}[name]


def get_default_precision():
    return _PRECISION


# Compute dtype policy (--dtype bfloat16): layers cast inputs and kernels to
# this dtype before the conv/matmul (halving HBM traffic for activations) while
# accumulating in f32. None = passthrough (params' dtype, default f32).
_COMPUTE_DTYPE = None


def set_compute_dtype(name: str | None) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = {None: None, "float32": None,
                      "bfloat16": jnp.bfloat16}[name]


def _cast_in(x, k):
    if _COMPUTE_DTYPE is not None:
        return x.astype(_COMPUTE_DTYPE), k.astype(_COMPUTE_DTYPE)
    if x.dtype != k.dtype:  # mixed callers (e.g. f32 BN output, bf16 kernel)
        return x.astype(k.dtype), k
    return x, k


# ---------------------------------------------------------------------------
# primitive functional ops (stateless, used by layers and by model code)
# ---------------------------------------------------------------------------

def conv2d_op(x, kernel, stride: int = 1, padding: str = "SAME"):
    """NHWC conv with HWIO kernel; mirrors tf.nn.conv2d(..., padding)."""
    x, kernel = _cast_in(x, kernel)
    return lax.conv_general_dilated(
        x, kernel,
        window_strides=(stride, stride),
        padding=padding,
        dimension_numbers=_CONV_DIMS,
        precision=_PRECISION,
    )


# Transposed-conv lowering strategy. 'dilated' is the textbook transpose
# (lhs-dilated conv — zero-stuffed input); 'phase_split' computes the same
# values as s^2 dense stride-1 convs over the *undilated* input (one per
# output phase) followed by an interleave — the dilated form
# multiplies (s^2-1)/s^2 zeros, so phase-split does s^2x fewer real MACs.
# Both paths sum exactly the same nonzero products per output element;
# selection via set_deconv_impl / --deconv_impl (which is faster on the
# H100 is not measured yet: ROADMAP speed item 5).
_DECONV_IMPL = "dilated"


def set_deconv_impl(name: str) -> None:
    global _DECONV_IMPL
    if name not in ("dilated", "phase_split"):
        raise ValueError(f"unknown deconv impl '{name}'")
    _DECONV_IMPL = name


def get_deconv_impl() -> str:
    return _DECONV_IMPL


def deconv2d_op(x, kernel, out_hw: Tuple[int, int], stride: int = 2,
                padding: str = "SAME"):
    """Transposed conv matching tf.nn.conv2d_transpose.

    ``kernel`` is ``[H, W, out_ch, in_ch]`` (TF conv2d_transpose layout).
    Implemented as the true transpose (input dilation) of the forward conv so
    numerics match TF/cuDNN. ``out_hw`` selects among the valid output sizes
    and drives the transpose arithmetic (it is the true adjoint for any
    legal size); ``padding`` declares which forward-conv padding this is the
    transpose of and validates ``out_hw`` against TF's legal range for it —
    SAME: ``(in-1)*s+1 .. in*s``; VALID: ``(in-1)*s+k .. in*s+k-1``
    (tf.nn.conv2d_transpose rejects mismatches the same way).
    """
    x, kernel = _cast_in(x, kernel)
    kh, kw, out_ch, in_ch = kernel.shape
    n, h, w, c = x.shape
    oh, ow = out_hw
    for axis, i_dim, o_dim, k_dim in (("H", h, oh, kh), ("W", w, ow, kw)):
        if padding == "SAME":
            lo, hi = (i_dim - 1) * stride + 1, i_dim * stride
        else:
            lo, hi = (i_dim - 1) * stride + k_dim, i_dim * stride + k_dim - 1
        if not lo <= o_dim <= hi:
            raise ValueError(
                f"deconv2d_op: output {axis}={o_dim} is not a valid "
                f"{padding} conv2d_transpose size for input {i_dim}, "
                f"kernel {k_dim}, stride {stride} (legal: {lo}..{hi})")
    pad_h = (h - 1) * stride + kh - oh
    pad_w = (w - 1) * stride + kw - ow
    # TF semantics: any of the `stride` valid output sizes may be requested
    # (floor division in the forward conv). Sizes beyond the natural
    # transpose size get zero rows/cols at the bottom/right — those input
    # positions were never touched by the forward conv, so their gradient
    # (== the transpose result) is zero.
    extra_h, extra_w = max(-pad_h, 0), max(-pad_w, 0)
    pad_h, pad_w = max(pad_h, 0), max(pad_w, 0)
    # transpose of conv = conv with input dilation `stride`, flipped kernel,
    # swapped in/out channels, padding (k-1-lo, k-1-hi).
    lo_h, hi_h = pad_h // 2, pad_h - pad_h // 2
    lo_w, hi_w = pad_w // 2, pad_w - pad_w // 2
    k = jnp.flip(kernel, (0, 1))            # [H, W, out, in]
    # contracting over in_ch and producing out_ch -> HWIO = [H, W, in, out]
    k = jnp.transpose(k, (0, 1, 3, 2))
    if _DECONV_IMPL == "phase_split" and stride > 1:
        y = _deconv_phase_split(x, k, stride,
                                (kh - 1 - lo_h, kw - 1 - lo_w),
                                (oh - extra_h, ow - extra_w))
    else:
        y = lax.conv_general_dilated(
            x, k,
            window_strides=(1, 1),
            padding=((kh - 1 - lo_h, kh - 1 - hi_h),
                     (kw - 1 - lo_w, kw - 1 - hi_w)),
            lhs_dilation=(stride, stride),
            dimension_numbers=_CONV_DIMS,
            precision=_PRECISION,
        )
    if extra_h or extra_w:
        y = jnp.pad(y, ((0, 0), (0, extra_h), (0, extra_w), (0, 0)))
    return y


def _deconv_phase_split(x, k, s: int, pad_lo: Tuple[int, int],
                        out_hw: Tuple[int, int]):
    """Transposed conv as ``s^2`` dense stride-1 convs + phase interleave.

    ``k`` is the flipped HWIO kernel of the equivalent dilated-conv form and
    ``pad_lo`` its top/left padding in dilated space; this computes exactly
    the sums the dilated conv computes (every nonzero tap, nothing else),
    without materializing the zero-stuffed input — output row ``p`` only
    receives kernel taps ``q`` with ``(p + q - pad_lo) % s == 0``, so each
    output phase ``a = p % s`` is a dense conv of the raw input with the
    kernel slice ``k[(pad_lo - a) % s :: s]``.
    """
    n, h, w, _ = x.shape
    kh, kw, _, out_ch = k.shape
    oh, ow = out_hw
    ph, pw = pad_lo

    def phase(a, k_dim, in_dim, o_dim, pad):
        q0 = (pad - a) % s
        m = len(range(q0, k_dim, s))
        off = (a + q0 - pad) // s
        n_a = max(0, -(-(o_dim - a) // s)) if a < o_dim else 0
        return q0, m, off, n_a

    n_h = -(-oh // s)  # ceil: padded per-phase row count for the interleave
    n_w = -(-ow // s)
    rows = []
    for a in range(s):
        q0a, ma, offa, na = phase(a, kh, h, oh, ph)
        cols = []
        for b in range(s):
            q0b, mb, offb, nb = phase(b, kw, w, ow, pw)
            if ma == 0 or mb == 0 or na == 0 or nb == 0:
                cols.append(jnp.zeros((n, n_h, n_w, out_ch), x.dtype))
                continue
            yp = lax.conv_general_dilated(
                x, k[q0a::s, q0b::s],
                window_strides=(1, 1),
                padding=((-offa, na - 1 + offa + ma - h),
                         (-offb, nb - 1 + offb + mb - w)),
                dimension_numbers=_CONV_DIMS,
                precision=_PRECISION,
            )
            if na < n_h or nb < n_w:
                yp = jnp.pad(yp, ((0, 0), (0, n_h - na), (0, n_w - nb),
                                  (0, 0)))
            cols.append(yp)
        rows.append(jnp.stack(cols, axis=0))
    t = jnp.stack(rows, axis=0)                  # (s_a, s_b, n, n_h, n_w, C)
    t = jnp.transpose(t, (2, 3, 0, 4, 1, 5))     # (n, n_h, s_a, n_w, s_b, C)
    return t.reshape(n, n_h * s, n_w * s, out_ch)[:, :oh, :ow]


def batch_norm_op(x, mean, var, beta, gamma, eps: float = 1e-3):
    inv = lax.rsqrt(var + eps)
    y = (x - mean) * inv
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


# ---------------------------------------------------------------------------
# norm / regularization layers
# ---------------------------------------------------------------------------

def batch_norm(*, decay: float = 0.999, eps: float = 1e-3, center: bool = True,
               scale: bool = False, renorm: bool = False,
               eval_stats: str = "batch", name: str = "batch_norm") -> Layer:
    """Batch normalization over all axes but the last (channel).

    ``eval_stats='batch'`` reproduces the reference's always-training BN;
    ``'moving'`` uses the tracked moving averages outside training.
    ``renorm`` enables batch renormalization (hem/ops/layers.py renorm flag).
    """

    def init(key, in_shape):
        c = in_shape[-1]
        params = {}
        if center:
            params["beta"] = jnp.zeros((c,), jnp.float32)
        if scale:
            params["gamma"] = jnp.ones((c,), jnp.float32)
        state = {"mean": jnp.zeros((c,), jnp.float32),
                 "var": jnp.ones((c,), jnp.float32)}
        return params, state, in_shape

    def apply(params, state, x, ctx: Ctx):
        axes = tuple(range(x.ndim - 1))
        beta = params.get("beta")
        gamma = params.get("gamma")
        use_batch_stats = ctx.training or eval_stats == "batch"
        if use_batch_stats:
            mean = jnp.mean(x, axes)
            var = jnp.var(x, axes)
            if renorm:
                sigma_mv = jnp.sqrt(state["var"] + eps)
                r = lax.stop_gradient(jnp.sqrt(var + eps) / sigma_mv)
                d = lax.stop_gradient((mean - state["mean"]) / sigma_mv)
                y = (x - mean) * lax.rsqrt(var + eps) * r + d
                if gamma is not None:
                    y = y * gamma
                if beta is not None:
                    y = y + beta
            else:
                y = batch_norm_op(x, mean, var, beta, gamma, eps)
            new_state = {
                "mean": decay * state["mean"] + (1.0 - decay) * mean,
                "var": decay * state["var"] + (1.0 - decay) * var,
            }
            # eval passes must not mutate moving stats
            if not ctx.training:
                new_state = state
            return y, new_state
        y = batch_norm_op(x, state["mean"], state["var"], beta, gamma, eps)
        return y, state

    return Layer(init, apply, name)


def instance_norm(*, eps: float = 1e-5, name: str = "instance_norm") -> Layer:
    """Per-sample, per-channel normalization (reference: hem/ops/images.py:73-89)."""

    def init(key, in_shape):
        return {}, {}, in_shape

    def apply(params, state, x, ctx):
        axes = tuple(range(1, x.ndim - 1))  # spatial axes, NHWC
        mean = jnp.mean(x, axes, keepdims=True)
        var = jnp.var(x, axes, keepdims=True)
        return (x - mean) * lax.rsqrt(var + eps), state

    return Layer(init, apply, name)


def dropout(keep_prob: float, name: str = "dropout") -> Layer:
    """Inverted dropout; matches tf.nn.dropout(keep_prob) semantics.

    Note: the reference passes its ``dropout`` layer argument directly as
    keep_prob (hem/ops/layers.py residual/conv paths); callers here do the same.
    """

    def init(key, in_shape):
        return {}, {}, in_shape

    def apply(params, state, x, ctx: Ctx):
        if not ctx.training or keep_prob >= 1.0:
            return x, state
        mask = jax.random.bernoulli(ctx.next_rng(), keep_prob, x.shape)
        return jnp.where(mask, x / keep_prob, 0.0), state

    return Layer(init, apply, name)


def activation(fn: Callable, name: str = "activation") -> Layer:
    def init(key, in_shape):
        return {}, {}, in_shape

    def apply(params, state, x, ctx):
        return fn(x), state

    return Layer(init, apply, name)


# ---------------------------------------------------------------------------
# parameterized layers
# ---------------------------------------------------------------------------

def _maybe_norm_layers(use_batch_norm, use_batch_renorm, use_instance_norm,
                       eval_stats):
    post = []
    if use_instance_norm:
        post.append(instance_norm())
    if use_batch_norm or use_batch_renorm:
        post.append(batch_norm(renorm=use_batch_renorm, eval_stats=eval_stats))
    return post


def dense(output_size: int, *, input_size: Optional[int] = None,
          init: Callable = initializers.xavier_uniform,
          use_batch_norm: bool = False, activation: Optional[Callable] = None,
          eval_stats: str = "batch", dtype=jnp.float32,
          name: str = "dense") -> Layer:
    """Fully connected layer (reference: ops/layers.py:27-63)."""

    bn = batch_norm(eval_stats=eval_stats) if use_batch_norm else None

    def init_fn(key, in_shape):
        in_features = in_shape[-1]
        if input_size is not None and input_size != in_features:
            raise ValueError(
                f"{name}: declared input_size {input_size} != actual {in_features}")
        kw, kb = jax.random.split(key)
        params = {"w": init(kw, (in_features, output_size), dtype),
                  "b": init(kb, (output_size,), dtype)}
        state = {}
        out_shape = tuple(in_shape[:-1]) + (output_size,)
        if bn is not None:
            bp, bs, _ = bn.init(key, out_shape)
            params["bn"] = bp
            state["bn"] = bs
        return params, state, out_shape

    def apply_fn(params, state, x, ctx: Ctx):
        xx, w = _cast_in(x, params["w"])
        # Output in the compute dtype, like the conv path. The f32 half of
        # the bf16-inputs/f32-accumulate policy holds at the hardware
        # level: tensor cores accumulate bf16 products in f32 and round
        # ONCE at the output — preferred_element_type here sets the output
        # dtype, not the accumulator.
        y = jnp.dot(xx, w, preferred_element_type=_COMPUTE_DTYPE or jnp.float32,
                    precision=_PRECISION) + params["b"].astype(
                        _COMPUTE_DTYPE or jnp.float32)
        new_state = state
        if bn is not None:
            y, bn_state = bn.apply(params["bn"], state["bn"], y, ctx)
            new_state = {**state, "bn": bn_state}
        if activation is not None:
            y = activation(y)
        return y, new_state

    return Layer(init_fn, apply_fn, name)


def conv2d(output_size: int, filter_size: int = 3, stride: int = 1, *,
           input_size: Optional[int] = None, padding: str = "SAME",
           init: Callable = initializers.xavier_uniform,
           use_batch_norm: bool = False, use_batch_renorm: bool = False,
           use_instance_norm: bool = False, dropout_keep: float = 0.0,
           activation: Optional[Callable] = None, eval_stats: str = "batch",
           dtype=jnp.float32, name: str = "conv2d") -> Layer:
    """2-D convolution (reference: ops/layers.py:66-108, hem/ops/layers.py:70-135).

    Order of fused post-ops matches the reference: conv+bias -> instance_norm
    -> batch_norm -> activation -> dropout.
    """
    norms = _maybe_norm_layers(use_batch_norm, use_batch_renorm,
                               use_instance_norm, eval_stats)
    drop = dropout(dropout_keep) if dropout_keep > 0 else None

    def init_fn(key, in_shape):
        n, h, w, c = in_shape
        if input_size is not None and input_size != c:
            raise ValueError(f"{name}: declared input_size {input_size} != actual {c}")
        kw, kb, kn = jax.random.split(key, 3)
        params = {"w": init(kw, (filter_size, filter_size, c, output_size), dtype),
                  "b": init(kb, (output_size,), dtype)}
        state = {}
        if padding == "SAME":
            oh, ow = -(-h // stride), -(-w // stride)
        else:
            oh = (h - filter_size) // stride + 1
            ow = (w - filter_size) // stride + 1
        out_shape = (n, oh, ow, output_size)
        for i, nl in enumerate(norms):
            p, s, _ = nl.init(kn, out_shape)
            params[f"norm{i}"] = p
            state[f"norm{i}"] = s
        return params, state, out_shape

    def apply_fn(params, state, x, ctx: Ctx):
        y = conv2d_op(x, params["w"], stride, padding)
        y = y + params["b"].astype(y.dtype)
        new_state = dict(state)
        for i, nl in enumerate(norms):
            y, s = nl.apply(params[f"norm{i}"], state[f"norm{i}"], y, ctx)
            new_state[f"norm{i}"] = s
        if activation is not None:
            y = activation(y)
        if drop is not None:
            y, _ = drop.apply({}, {}, y, ctx)
        return y, new_state

    return Layer(init_fn, apply_fn, name)


def deconv2d(output_size: int, filter_size: int = 3, stride: int = 2, *,
             input_size: Optional[int] = None, out_hw: Optional[Tuple[int, int]] = None,
             padding: str = "SAME", init: Callable = initializers.xavier_uniform,
             use_batch_norm: bool = False, use_batch_renorm: bool = False,
             use_instance_norm: bool = False, dropout_keep: float = 0.0,
             activation: Optional[Callable] = None, eval_stats: str = "batch",
             dtype=jnp.float32, name: str = "deconv2d") -> Layer:
    """Transposed convolution (reference: ops/layers.py:111-151, hem/ops/layers.py:138-212).

    v1 semantics by default (spatial dims double); pass ``out_hw`` for the v2
    explicit-output-shape form.
    """
    norms = _maybe_norm_layers(use_batch_norm, use_batch_renorm,
                               use_instance_norm, eval_stats)
    drop = dropout(dropout_keep) if dropout_keep > 0 else None

    def default_hw(h, w):
        # SAME doubles the spatial dims (v1 semantics); VALID inverts the
        # VALID forward conv's size arithmetic
        if padding == "SAME":
            return h * stride, w * stride
        return (h - 1) * stride + filter_size, (w - 1) * stride + filter_size

    def init_fn(key, in_shape):
        n, h, w, c = in_shape
        if input_size is not None and input_size != c:
            raise ValueError(f"{name}: declared input_size {input_size} != actual {c}")
        kw, kb, kn = jax.random.split(key, 3)
        # TF conv2d_transpose kernel layout: [H, W, out_ch, in_ch]
        params = {"w": init(kw, (filter_size, filter_size, output_size, c), dtype),
                  "b": init(kb, (output_size,), dtype)}
        state = {}
        oh, ow = out_hw if out_hw is not None else default_hw(h, w)
        out_shape = (n, oh, ow, output_size)
        for i, nl in enumerate(norms):
            p, s, _ = nl.init(kn, out_shape)
            params[f"norm{i}"] = p
            state[f"norm{i}"] = s
        return params, state, out_shape

    def apply_fn(params, state, x, ctx: Ctx):
        n, h, w, c = x.shape
        target = out_hw if out_hw is not None else default_hw(h, w)
        y = deconv2d_op(x, params["w"], target, stride, padding)
        y = y + params["b"].astype(y.dtype)
        new_state = dict(state)
        for i, nl in enumerate(norms):
            y, s = nl.apply(params[f"norm{i}"], state[f"norm{i}"], y, ctx)
            new_state[f"norm{i}"] = s
        if activation is not None:
            y = activation(y)
        if drop is not None:
            y, _ = drop.apply({}, {}, y, ctx)
        return y, new_state

    return Layer(init_fn, apply_fn, name)


def residual(output_size: int, filter_size: int = 3, stride: int = 1, *,
             input_size: Optional[int] = None, padding: str = "SAME",
             init: Callable = initializers.xavier_uniform,
             use_batch_norm: bool = False, use_batch_renorm: bool = False,
             use_instance_norm: bool = False, dropout_keep: float = 0.0,
             activation: Optional[Callable] = None, eval_stats: str = "batch",
             name: str = "residual") -> Layer:
    """Two-conv residual block (reference: hem/ops/layers.py:215-320).

    Shortcut = conv1 output *before* normalization; added to conv2's
    post-norm output, then activated — exactly the reference's wiring.

    stride must be 1: the reference applies ``stride`` to BOTH convs
    (hem/ops/layers.py:262,300) while sizing downstream layers as if it were
    applied once, so any stride>1 caller would hit a latent shape mismatch at
    the ``h + shortcut`` add. No reference config uses stride>1; we reject it
    eagerly instead of reproducing the broken geometry.
    """
    if stride != 1:
        raise ValueError(
            f"residual({name}): stride must be 1 (the reference's stride>1 "
            "path is internally inconsistent — see docstring)")
    norms_a = _maybe_norm_layers(use_batch_norm, use_batch_renorm,
                                 use_instance_norm, eval_stats)
    norms_b = _maybe_norm_layers(use_batch_norm, use_batch_renorm,
                                 use_instance_norm, eval_stats)
    drop = dropout(dropout_keep) if dropout_keep > 0 else None

    def init_fn(key, in_shape):
        n, h, w, c = in_shape
        if input_size is not None and input_size != c:
            raise ValueError(f"{name}: declared input_size {input_size} != actual {c}")
        ka, kb_, kn = jax.random.split(key, 3)
        ka_w, ka_b = jax.random.split(ka)
        kb_w, kb_b = jax.random.split(kb_)
        params = {
            "wa": init(ka_w, (filter_size, filter_size, c, output_size)),
            "ba": init(ka_b, (output_size,)),
            "wb": init(kb_w, (filter_size, filter_size, output_size, output_size)),
            "bb": init(kb_b, (output_size,)),
        }
        state = {}
        if padding == "SAME":
            oh, ow = -(-h // stride), -(-w // stride)
        else:
            oh = (h - filter_size) // stride + 1
            ow = (w - filter_size) // stride + 1
        out_shape = (n, oh, ow, output_size)
        for tag, norms in (("a", norms_a), ("b", norms_b)):
            for i, nl in enumerate(norms):
                p, s, _ = nl.init(kn, out_shape)
                params[f"norm_{tag}{i}"] = p
                state[f"norm_{tag}{i}"] = s
        return params, state, out_shape

    def apply_fn(params, state, x, ctx: Ctx):
        new_state = dict(state)
        h = conv2d_op(x, params["wa"], stride, padding)
        h = h + params["ba"].astype(h.dtype)
        shortcut = h
        for i, nl in enumerate(norms_a):
            h, s = nl.apply(params[f"norm_a{i}"], state[f"norm_a{i}"], h, ctx)
            new_state[f"norm_a{i}"] = s
        if activation is not None:
            h = activation(h)
        if drop is not None:
            h, _ = drop.apply({}, {}, h, ctx)
        h = conv2d_op(h, params["wb"], stride, padding)
        h = h + params["bb"].astype(h.dtype)
        for i, nl in enumerate(norms_b):
            h, s = nl.apply(params[f"norm_b{i}"], state[f"norm_b{i}"], h, ctx)
            new_state[f"norm_b{i}"] = s
        h = h + shortcut
        if activation is not None:
            h = activation(h)
        if drop is not None:
            h, _ = drop.apply({}, {}, h, ctx)
        return h, new_state

    return Layer(init_fn, apply_fn, name)


def flatten(name: str = "flatten") -> Layer:
    """Flatten to (batch, -1) (reference: ops/layers.py:154-169)."""

    def init(key, in_shape):
        size = 1
        for d in in_shape[1:]:
            size *= d
        return {}, {}, (in_shape[0], size)

    def apply(params, state, x, ctx):
        return x.reshape(x.shape[0], -1), state

    return Layer(init, apply, name)


def reshape(shape: Sequence[int], name: str = "reshape") -> Layer:
    """Reshape to an NHWC shape; -1 allowed in the batch slot
    (reference: hem/ops/layers.py:342-356, minus the NCHW transpose)."""

    def init(key, in_shape):
        out = tuple(in_shape[0] if d == -1 else d for d in shape)
        return {}, {}, out

    def apply(params, state, x, ctx):
        return x.reshape(tuple(shape)), state

    return Layer(init, apply, name)
