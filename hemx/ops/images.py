"""Image ops (reference: hem/ops/images.py).

hemx is NHWC; the NCHW<->NHWC helpers exist for interop with reference-style
configs and for montage/summary code.

``colorize`` is host-side by design: the reference ran an OpenCV colormap via
``tf.py_func`` *inside the graph* (hem/ops/images.py:10-50); on an accelerator a host
callback in the step would stall the device, so colorization happens at
summary-write time on numpy arrays (matplotlib colormaps replace cv2).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def rescale(x, orig_range, new_range):
    """Linear range remap (reference: hem/ops/images.py:53-70)."""
    o_lo, o_hi = orig_range
    n_lo, n_hi = new_range
    return (x - o_lo) * (n_hi - n_lo) / (o_hi - o_lo) + n_lo


def instance_norm_fn(x, eps: float = 1e-5):
    """Functional instance norm over spatial axes, NHWC
    (reference: hem/ops/images.py:73-89)."""
    axes = tuple(range(1, x.ndim - 1))
    mean = jnp.mean(x, axes, keepdims=True)
    var = jnp.var(x, axes, keepdims=True)
    return (x - mean) / jnp.sqrt(var + eps)


def center_crop(x, fraction: float):
    """Central crop by fraction, NHWC (reference: hem/ops/images.py:92-95)."""
    n, h, w, c = x.shape
    ch, cw = int(round(h * fraction)), int(round(w * fraction))
    top = (h - ch) // 2
    left = (w - cw) // 2
    return x[:, top:top + ch, left:left + cw, :]


def crop_to_bounding_box(x, offset_h: int, offset_w: int, target_h: int, target_w: int):
    """Fixed bounding-box crop, NHWC (reference: hem/ops/images.py:97-101)."""
    return x[:, offset_h:offset_h + target_h, offset_w:offset_w + target_w, :]


def nhwc_to_nchw(x):
    return jnp.transpose(x, (0, 3, 1, 2))


def nchw_to_nhwc(x):
    return jnp.transpose(x, (0, 2, 3, 1))


def colorize(images: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """Host-side colormap for 1-channel images -> RGB uint8-range floats in [0,1].

    Accepts (N, H, W, 1) or (H, W, 1) float arrays; values are min-max
    normalized per-image like the reference's cv2 path
    (hem/ops/images.py:10-50).
    """
    import matplotlib.cm as mcm  # lazy: matplotlib only needed for summaries

    arr = np.asarray(images, dtype=np.float64)
    squeeze = arr.ndim == 3
    if squeeze:
        arr = arr[None]
    arr = arr[..., 0]  # drop channel
    lo = arr.min(axis=(1, 2), keepdims=True)
    hi = arr.max(axis=(1, 2), keepdims=True)
    norm = (arr - lo) / np.maximum(hi - lo, 1e-12)
    colormap = mcm.get_cmap(cmap)
    rgb = colormap(norm)[..., :3].astype(np.float32)
    return rgb[0] if squeeze else rgb
