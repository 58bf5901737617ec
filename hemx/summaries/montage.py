"""Montage (image grid) construction on host numpy.

The reference built montages *in-graph* via split/concat/unstack
(ops/summaries.py:95-124, hem/ops/summaries.py:138-181). On an accelerator
that wastes step time; hemx assembles grids on host at summary-write time from the small
example slice the step already returns.
"""

from __future__ import annotations

import math

import numpy as np


def factorization(n: int) -> tuple[int, int]:
    """Squarest grid factorization (reference: ops/summaries.py:79-92)."""
    for i in range(int(math.sqrt(float(n))), 0, -1):
        if n % i == 0:
            return i, n // i
    return 1, n


def montage(images: np.ndarray, grid: tuple[int, int] | None = None,
            pad: int = 1) -> np.ndarray:
    """Stitch (N, H, W, C) float [0,1] images into one (GH, GW, C) image."""
    imgs = np.asarray(images)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    rows, cols = grid if grid is not None else factorization(n)
    out = np.ones((rows * (h + pad) + pad, cols * (w + pad) + pad, c),
                  dtype=imgs.dtype)
    for idx in range(min(n, rows * cols)):
        r, col = divmod(idx, cols)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        out[y0:y0 + h, x0:x0 + w] = imgs[idx]
    return out


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32) * 255.0, 0, 255).astype(np.uint8)
