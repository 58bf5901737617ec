"""On-device input normalization for the input pipeline.

``u8_normalize`` performs the uint8 -> float [lo, hi] conversion that the
reference performed on the host inside its tf.data map functions
(data.py:44-46, hem/data/*.py parse fns). hemx ships raw uint8 to the
device (4x less host->device traffic than float32) and converts there.

The conversion is plain ``jax.numpy`` on purpose: XLA fuses the convert and
multiply into the op that consumes it (the device-cache batch gather, the
first conv), so the float batch is never written to device memory on its
own. A hand-written kernel could not be fused that way and would have to
write the float batch (4x the uint8 bytes) and read it back.
"""

from __future__ import annotations

import jax.numpy as jnp


def u8_normalize(x, lo: float = 0.0, hi: float = 1.0):
    """uint8 array -> float32 in [lo, hi] (value/255 * (hi-lo) + lo)."""
    assert x.dtype == jnp.uint8, x.dtype
    scale = (hi - lo) / 255.0
    return x.astype(jnp.float32) * scale + lo


def u16_normalize(x, denom: float = 65535.0):
    """uint16 depth -> float32 [0,1] (NYUv2 path); jnp (XLA fuses it)."""
    return x.astype(jnp.float32) / denom
