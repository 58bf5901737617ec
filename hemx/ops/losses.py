"""Loss functions (reference: hem/ops/losses.py, models/*.py loss definitions)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def guarded_one_minus(p):
    """``1 - p`` protected from XLA's constant reassociation, for use under
    an additive-eps log guard.

    Every reference loss that takes ``log(eps + (1 - p))`` (models/vae.py:76,
    models/gan.py:196, hem/models/info_gan.py) relies on strict left-to-right
    TF1 evaluation: the eps keeps the log argument >= eps even when ``p``
    saturates to exactly 1.0. Under jit, XLA's algebraic simplifier folds
    ``eps + (1 - p)`` into ``(eps + 1) - p`` and constant-folds
    ``1e-8 + 1.0 -> 1.0`` in f32, annihilating the guard at COMPILE time —
    no parenthesization or clamp survives the rewrite (measured: a
    saturated sigmoid output produced ``log(0) = -inf`` inside the fused
    program — then ``0 * -inf = NaN`` killed a 100-epoch VAE run at its last
    epoch — while the same op-by-op computation was finite). The
    optimization barrier pins ``1 - p`` as an opaque value so the eps add
    happens at run time, exactly as the reference's unfused graph did.
    """
    return lax.optimization_barrier(1.0 - p)


def rmse(a, b):
    """Root mean squared error (reference: hem/ops/losses.py:10-11)."""
    return jnp.sqrt(jnp.mean((a - b) ** 2))


def rmse_scale_invariant(x, x_hat):
    """The reference's (idiosyncratic) scale-invariant RMSE:
    ``0.5 * (rmse(x, x_hat) + mean(x_hat - x))`` in LINEAR space
    (hem/ops/losses.py:14-15) — reproduced exactly for API parity. This is
    NOT Eigen et al.'s log-space formula; the reference's own evaluation
    used that separately (paper_metrics.py:20-22), which hemx provides as
    :func:`hemx.metrics.eigen.scale_invariant_log_rmse`."""
    return 0.5 * (rmse(x, x_hat) + jnp.mean(x_hat - x))


def l1_loss(x, y):
    """Mean absolute error (reference: models/cnn.py:75-79)."""
    return jnp.mean(jnp.abs(x - y))


def l2_loss(x, y):
    return jnp.mean((x - y) ** 2)


def bernoulli_recon_loss(x, x_hat, eps: float = 1e-8):
    """Sum-reduced Bernoulli reconstruction loss (reference: models/vae.py:75-79).

    Sum reduction is kept deliberately so loss magnitudes match
    examples/examples.org (see BASELINE.md row 4).

    The second term's guard must be ``eps + (1 - x_hat)`` with the
    subtraction FIRST, exactly as the reference parenthesizes it
    (models/vae.py:76) — AND the subtraction must be pinned behind an
    optimization barrier or XLA re-folds it at compile time; see
    :func:`guarded_one_minus` for the measured failure.
    """
    ll = x * jnp.log(eps + x_hat) \
        + (1.0 - x) * jnp.log(eps + guarded_one_minus(x_hat))
    return -jnp.sum(ll)


def kl_gaussian_loss(z_mean, z_stddev, eps: float = 1e-8):
    """Sum-reduced KL(q||N(0,1)) in the reference's stddev-head
    parameterization (reference: models/vae.py:81-83)."""
    term = jnp.square(z_mean) + jnp.square(z_stddev) \
        - jnp.log(eps + jnp.square(z_stddev)) - 1.0
    return 0.5 * jnp.sum(term)


def gan_g_loss(d_fake, eps: float = 1e-8):
    """Non-saturating generator loss -E[log D(G(z))] over sigmoid outputs
    (reference: models/gan.py:195)."""
    return jnp.mean(-jnp.log(d_fake + eps))


def gan_d_loss(d_real, d_fake, eps: float = 1e-8):
    """Discriminator log loss (reference: models/gan.py:196).

    ``1 - d_fake`` is barrier-pinned: XLA otherwise folds the eps guard
    away and a D output saturated at exactly 1.0 turns the loss into
    ``-log(0) = inf`` (see :func:`guarded_one_minus`)."""
    return jnp.mean(-jnp.log(d_real + eps)
                    - jnp.log(guarded_one_minus(d_fake) + eps))


def wgan_g_loss(d_fake):
    """Wasserstein generator loss (reference: models/gan.py:198)."""
    return -jnp.mean(d_fake)


def wgan_d_loss(d_real, d_fake):
    """Wasserstein critic loss (reference: models/gan.py:199)."""
    return jnp.mean(d_fake) - jnp.mean(d_real)


def sigmoid_xent(logits, labels):
    """tf.nn.sigmoid_cross_entropy_with_logits equivalent (v2 GAN losses,
    e.g. hem/models/improved_sampler.py loss paths)."""
    return jnp.maximum(logits, 0.0) - logits * labels + jnp.log1p(jnp.exp(-jnp.abs(logits)))


def gradient_penalty(d_apply, x_real, x_fake, alpha, *, per_sample: bool = False,
                     pin=None):
    """IWGAN gradient penalty (reference: models/gan.py:214-231).

    The reference computes ``slopes = sqrt(sum(grad**2))`` over the WHOLE
    batch (no per-sample axis — models/gan.py:229), which is arguably a bug
    but is reproduced by default for parity. ``per_sample=True`` gives the
    corrected per-sample norm from the IWGAN paper.

    Args:
      d_apply: callable image-batch -> critic scores (closed over params).
      x_real, x_fake: (B, ...) batches.
      alpha: (B, 1) or broadcastable uniform interpolation coefficients.
      pin: optional array -> array sharding pin applied to the interpolant
        and the inner input-gradient. On spatial meshes the GAN models pass
        a data-parallel pin here: XLA's SPMD partitioner computes wrong
        weight gradients for reverse-over-reverse conv programs under
        spatial sharding, so the GP sub-term runs in the proven-exact DP
        layout (hemx.models.common.pin_batch_sharding docstring).
    """
    # Broadcast alpha to the batch's native rank instead of flattening to
    # (B, -1) and back: elementwise-identical values, but the interpolant
    # keeps the inputs' layout/sharding — on a spatial mesh the flatten
    # collapses the height dim into the flat axis and forces a resharding
    # of the GP input (the double-backprop then mixes sharding regimes).
    a = jnp.reshape(alpha, (-1,) + (1,) * (x_real.ndim - 1))
    interp = x_real + a * (x_fake - x_real)
    if pin is not None:
        interp = pin(interp)

    def d_sum(z):
        return jnp.sum(d_apply(z))

    grads = jax.grad(d_sum)(interp)
    if pin is not None:
        grads = pin(grads)
    if per_sample:
        slopes = jnp.sqrt(jnp.sum(grads.reshape(grads.shape[0], -1) ** 2, axis=1))
    else:
        slopes = jnp.sqrt(jnp.sum(grads ** 2))
    return jnp.mean((slopes - 1.0) ** 2)
