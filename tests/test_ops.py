"""Golden tests for the ops layer (the reference's test_losses.py pattern,
hem/ops/test_losses.py:6-27, extended to layers per SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hemx.core import Ctx, sequential
from hemx.ops import initializers
from hemx.ops.activations import lrelu, selu, value_fraction
from hemx.ops.layers import (batch_norm, conv2d, conv2d_op, deconv2d,
                             deconv2d_op, dense, dropout, flatten, residual)
from hemx.ops.losses import (bernoulli_recon_loss, gan_d_loss, gan_g_loss,
                             gradient_penalty, kl_gaussian_loss, rmse,
                             rmse_scale_invariant, sigmoid_xent, wgan_d_loss,
                             wgan_g_loss)
from hemx.ops.images import center_crop, crop_to_bounding_box, rescale


class TestLosses:
    def test_rmse_zero(self):
        a = jnp.ones((4, 4))
        assert float(rmse(a, a)) == 0.0

    def test_rmse_known(self):
        # reference golden case: constant difference of 1 -> rmse 1
        a = jnp.zeros((3, 3))
        b = jnp.ones((3, 3))
        assert float(rmse(a, b)) == pytest.approx(1.0)
        assert float(rmse(a, 2 * b)) == pytest.approx(2.0)

    def test_rmse_scale_invariant_equal(self):
        a = jnp.ones((4, 4)) * 3.0
        assert float(rmse_scale_invariant(a, a)) == pytest.approx(0.0, abs=1e-5)

    def test_rmse_scale_invariant_reference_formula(self):
        # the reference's linear-space formula 0.5*(rmse + mean(x_hat - x))
        # (hem/ops/losses.py:14-15), reproduced verbatim — the Eigen
        # log-space variant lives in hemx.metrics.eigen
        x = jnp.array([[1.0, 2.0], [3.0, 4.0]])
        x_hat = 2 * x
        expected = 0.5 * (float(rmse(x, x_hat)) + float(jnp.mean(x_hat - x)))
        assert float(rmse_scale_invariant(x, x_hat)) == pytest.approx(
            expected, rel=1e-6)

    def test_gan_losses(self):
        # asymmetric values: 1-d_fake != d_real, so the two D-loss terms
        # are distinguishable (a term mix-up/doubling can't cancel out)
        d_real = jnp.array([0.9, 0.6])
        d_fake = jnp.array([0.3, 0.2])
        g = float(gan_g_loss(d_fake))
        assert g == pytest.approx(-np.mean(np.log([0.3, 0.2])), rel=1e-4)
        d = float(gan_d_loss(d_real, d_fake))
        expected = -np.mean(np.log([0.9, 0.6])) - np.mean(np.log([0.7, 0.8]))
        assert d == pytest.approx(expected, rel=1e-3)

    def test_wgan_losses(self):
        d_real = jnp.array([2.0, 4.0])
        d_fake = jnp.array([1.0, 3.0])
        assert float(wgan_g_loss(d_fake)) == pytest.approx(-2.0)
        assert float(wgan_d_loss(d_real, d_fake)) == pytest.approx(-1.0)

    def test_sigmoid_xent_matches_formula(self):
        logits = jnp.array([-3.0, -0.5, 0.0, 2.0])
        labels = jnp.array([0.0, 1.0, 1.0, 0.0])
        got = np.asarray(sigmoid_xent(logits, labels))
        p = 1 / (1 + np.exp(-np.asarray(logits)))
        want = -(np.asarray(labels) * np.log(p)
                 + (1 - np.asarray(labels)) * np.log(1 - p))
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_vae_losses_sum_reduced(self):
        # x has values < 1 so the (1-x)log(1-x_hat) complement term is
        # nonzero (an implementation that drops it must fail here)
        x = np.array([[1.0, 0.25, 0.5, 0.0], [0.75, 0.0, 1.0, 0.5]])
        x_hat = np.array([[0.5, 0.9, 0.4, 0.1], [0.2, 0.3, 0.8, 0.6]])
        want = -np.sum(x * np.log(x_hat) + (1 - x) * np.log(1 - x_hat))
        assert float(bernoulli_recon_loss(
            jnp.asarray(x), jnp.asarray(x_hat))) == pytest.approx(
                want, rel=1e-4)
        # KL at its zero point (mu=0, sigma=1)...
        zm = jnp.zeros((2, 3))
        zs = jnp.ones((2, 3))
        assert float(kl_gaussian_loss(zm, zs)) == pytest.approx(0.0, abs=1e-5)
        # ...and away from it: 0.5*sum(mu^2 + s^2 - log s^2 - 1)
        zm = np.array([[0.5, -1.0, 0.0]])
        zs = np.array([[1.5, 0.5, 2.0]])
        want = 0.5 * np.sum(zm**2 + zs**2 - np.log(zs**2) - 1.0)
        assert float(kl_gaussian_loss(
            jnp.asarray(zm), jnp.asarray(zs))) == pytest.approx(
                want, rel=1e-4)

    def test_vae_recon_loss_finite_at_saturation(self):
        # Regression: a saturated x_hat == 1 pixel under an x == 1 label.
        # The eps guard eps + (1 - x_hat) must be pinned behind an
        # optimization barrier: UNDER JIT, XLA's algebraic simplifier folds
        # it into (eps + 1) - x_hat and rounds 1e-8 + 1.0 -> 1.0 in f32
        # (verified on the CPU backend), so the fused program
        # computes 0 * log(0) = NaN while the eager ops are finite — this
        # killed a 100-epoch VAE run at its last epoch, twice, before the
        # barrier fix (hemx.ops.losses.guarded_one_minus).
        x = jnp.asarray(np.float32([[1.0, 0.0, 0.5]]))
        x_hat = jnp.asarray(np.float32([[1.0, 0.0, 0.5]]))
        for wrap in (lambda f: f, jax.jit):  # the jit path is the regression
            val, grad = wrap(jax.value_and_grad(
                lambda xh: bernoulli_recon_loss(x, xh)))(x_hat)
            assert np.isfinite(float(val))
            assert np.isfinite(np.asarray(grad)).all()
            # the saturated-corner terms equal the reference's guarded values
            want = -np.sum([np.log(1e-8 + 1.0), np.log(1e-8 + 1.0),
                            np.log(1e-8 + 0.5) * 0.5
                            + np.log(1e-8 + 0.5) * 0.5])
            assert float(val) == pytest.approx(want, rel=1e-5)

    def test_gan_d_loss_finite_at_saturation(self):
        # Same XLA guard-folding hazard in the GAN discriminator loss:
        # d_fake == 1.0 must give -log(eps), not -log(0) = inf, under jit.
        d_real = jnp.asarray(np.float32([0.5, 1.0]))
        d_fake = jnp.asarray(np.float32([1.0, 0.0]))
        val = jax.jit(gan_d_loss)(d_real, d_fake)
        assert np.isfinite(float(val))
        want = np.mean([-np.log(0.5 + 1e-8) - np.log(1e-8),
                        -np.log(1.0 + 1e-8) - np.log(1.0 + 1e-8)])
        assert float(val) == pytest.approx(want, rel=1e-5)

    def test_gradient_penalty_linear_critic(self):
        # critic f(x) = sum(2x): grad is 2 everywhere.
        def d_apply(x):
            return 2.0 * jnp.sum(x.reshape(x.shape[0], -1), axis=1)

        x = jnp.zeros((4, 2, 2, 1))
        g = jnp.ones((4, 2, 2, 1))
        alpha = jnp.full((4, 1), 0.5)
        # per-sample: |grad| per sample = 2*sqrt(4)=4 -> (4-1)^2 = 9
        gp = gradient_penalty(d_apply, x, g, alpha, per_sample=True)
        assert float(gp) == pytest.approx(9.0, rel=1e-5)
        # reference whole-batch quirk: |grad| = 2*sqrt(16)=8 -> 49
        gp_ref = gradient_penalty(d_apply, x, g, alpha, per_sample=False)
        assert float(gp_ref) == pytest.approx(49.0, rel=1e-5)
        # documented contract: alpha may be broadcastable (scalar / (1,1)),
        # not only (B, 1) — same result for a uniform alpha either way
        for a in (jnp.asarray(0.5), jnp.full((1, 1), 0.5)):
            gp_b = gradient_penalty(d_apply, x, g, a, per_sample=True)
            assert float(gp_b) == pytest.approx(9.0, rel=1e-5)


class TestActivations:
    def test_lrelu(self):
        x = jnp.array([-1.0, 0.0, 2.0])
        np.testing.assert_allclose(np.asarray(lrelu(x)), [-0.2, 0.0, 2.0],
                                   rtol=1e-6)

    def test_selu_fixed_point(self):
        # SELU(0) = 0; for large positive x it's scale*x
        assert float(selu(jnp.array(0.0))) == 0.0
        assert float(selu(jnp.array(10.0))) == pytest.approx(10.507, rel=1e-3)

    def test_selu_grad_finite_at_large_inputs(self):
        # the where+expm1 double-branch trap: without clamping the negative
        # branch's input, grad is NaN for x >= ~88.7 in f32 (0 * inf)
        g = jax.grad(lambda v: selu(v))(jnp.array(120.0))
        assert np.isfinite(float(g))
        assert float(g) == pytest.approx(1.0507, rel=1e-3)

    def test_value_fraction(self):
        x = jnp.array([0.0, 0.0, 1.0, 2.0])
        assert float(value_fraction(x)) == pytest.approx(0.5)


class TestImages:
    def test_rescale(self):
        x = jnp.array([0.0, 0.5, 1.0])
        np.testing.assert_allclose(np.asarray(rescale(x, (0, 1), (-1, 1))),
                                   [-1.0, 0.0, 1.0], rtol=1e-6)

    def test_center_crop(self):
        x = jnp.arange(4 * 10 * 10 * 2, dtype=jnp.float32).reshape(4, 10, 10, 2)
        y = center_crop(x, 0.5)
        assert y.shape == (4, 5, 5, 2)

    def test_crop_to_bounding_box(self):
        x = jnp.zeros((1, 8, 8, 1))
        y = crop_to_bounding_box(x, 2, 3, 4, 5)
        assert y.shape == (1, 4, 5, 1)


class TestLayers:
    def test_dense_shapes_and_linearity(self):
        layer = dense(7, name="d")
        params, state, out_shape = layer.init(jax.random.PRNGKey(0), (4, 3))
        assert out_shape == (4, 7)
        x = jnp.ones((4, 3))
        y, _ = layer.apply(params, state, x, Ctx())
        manual = (np.asarray(x, np.float64) @ np.asarray(params["w"], np.float64)
                  + np.asarray(params["b"], np.float64))
        np.testing.assert_allclose(np.asarray(y), manual, rtol=1e-5)

    def test_dense_input_size_validation(self):
        layer = dense(7, input_size=5)
        with pytest.raises(ValueError):
            layer.init(jax.random.PRNGKey(0), (4, 3))

    def test_conv2d_same_stride2_shape(self):
        layer = conv2d(8, 5, 2)
        params, state, out_shape = layer.init(jax.random.PRNGKey(0), (2, 64, 64, 3))
        assert out_shape == (2, 32, 32, 8)
        y, _ = layer.apply(params, state, jnp.ones((2, 64, 64, 3)), Ctx())
        assert y.shape == (2, 32, 32, 8)

    def test_conv2d_golden_identity_kernel(self):
        # 1x1 conv with identity kernel == input
        x = jax.random.normal(jax.random.PRNGKey(1), (2, 4, 4, 3))
        k = jnp.eye(3).reshape(1, 1, 3, 3)
        y = conv2d_op(x, k, 1, "SAME")
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-5)

    def test_conv2d_golden_sum_kernel(self):
        # 3x3 all-ones kernel on all-ones input, interior = 9
        x = jnp.ones((1, 5, 5, 1))
        k = jnp.ones((3, 3, 1, 1))
        y = np.asarray(conv2d_op(x, k, 1, "SAME"))
        assert y[0, 2, 2, 0] == pytest.approx(9.0)
        assert y[0, 0, 0, 0] == pytest.approx(4.0)  # corner: SAME zero-pad

    def test_deconv2d_is_conv_transpose(self):
        """deconv2d_op must equal the vjp of the matching forward conv —
        i.e. exactly tf.nn.conv2d_transpose semantics."""
        key = jax.random.PRNGKey(0)
        k1, k2, k3 = jax.random.split(key, 3)
        # forward conv: (1, 8, 8, 6) -> (1, 4, 4, 2) with SAME/stride 2
        kernel_fwd = jax.random.normal(k1, (5, 5, 6, 2))  # HWIO
        y_like = jax.random.normal(k2, (1, 4, 4, 2))

        def fwd(x):
            return conv2d_op(x, kernel_fwd, 2, "SAME")

        x0 = jnp.zeros((1, 8, 8, 6))
        _, vjp = jax.vjp(fwd, x0)
        expected = vjp(y_like)[0]
        # TF deconv kernel layout [H, W, out, in] with out=6 (image channels),
        # in=2 — numerically the same array as the forward HWIO kernel.
        got = deconv2d_op(y_like, kernel_fwd, (8, 8), 2, "SAME")
        np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                                   rtol=1e-4, atol=1e-5)

    def test_deconv2d_valid_is_valid_conv_transpose(self):
        """padding='VALID' must be the vjp of the VALID forward conv (the v2
        reference's deconv supports VALID; the padding arg used to be
        accepted and silently ignored)."""
        key = jax.random.PRNGKey(3)
        k1, k2 = jax.random.split(key)
        # VALID forward: (1, 9, 9, 4) -> (1, 3, 3, 2) with k=5 stride 2
        kernel_fwd = jax.random.normal(k1, (5, 5, 4, 2))
        y_like = jax.random.normal(k2, (1, 3, 3, 2))

        def fwd(x):
            return conv2d_op(x, kernel_fwd, 2, "VALID")

        _, vjp = jax.vjp(fwd, jnp.zeros((1, 9, 9, 4)))
        expected = vjp(y_like)[0]
        got = deconv2d_op(y_like, kernel_fwd, (9, 9), 2, "VALID")
        np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                                   rtol=1e-4, atol=1e-5)

    def test_deconv2d_rejects_illegal_output_size(self):
        """tf.nn.conv2d_transpose parity: an output size outside the legal
        range for the declared padding raises instead of silently computing
        the wrong geometry."""
        k = jnp.ones((5, 5, 1, 2))
        x = jnp.ones((1, 4, 4, 2))
        with pytest.raises(ValueError, match="not a valid"):
            deconv2d_op(x, k, (16, 16), 2, "VALID")  # VALID wants 11..12
        with pytest.raises(ValueError, match="not a valid"):
            deconv2d_op(x, k, (11, 11), 2, "SAME")  # SAME wants 7..8

    def test_deconv2d_phase_split_matches_dilated(self):
        """The phase-split lowering (s^2 dense convs + interleave) computes
        the same values and gradients as the lhs-dilated transpose, for
        every legal output size, both paddings, odd shapes, and stride 3.
        It sums exactly the nonzero taps the dilated form sums, so any
        difference is f32 reduction-order rounding."""
        from hemx.ops.layers import get_deconv_impl, set_deconv_impl
        rng = np.random.default_rng(7)
        cases = [
            # (stride, kh, h, out_h, padding) — incl. the DCGAN G shape
            (2, 5, 4, 8, "SAME"), (2, 5, 4, 7, "SAME"),
            (2, 4, 5, 9, "SAME"), (2, 5, 3, 10, "VALID"),
            (3, 5, 3, 9, "SAME"), (2, 1, 4, 8, "SAME"),
        ]
        assert get_deconv_impl() == "dilated"  # module default
        try:
            for stride, k_sz, h, oh, pad in cases:
                x = jnp.asarray(rng.standard_normal((2, h, h, 3),
                                                    dtype=np.float32))
                k = jnp.asarray(rng.standard_normal((k_sz, k_sz, 4, 3),
                                                    dtype=np.float32))
                ct = jnp.asarray(rng.standard_normal((2, oh, oh, 4),
                                                     dtype=np.float32))

                def loss(x, k, impl, oh=oh, stride=stride, pad=pad):
                    set_deconv_impl(impl)
                    y = deconv2d_op(x, k, (oh, oh), stride, pad)
                    return jnp.sum(y * ct), y

                (_, ya), (dxa, dka) = (
                    jax.value_and_grad(loss, (0, 1), has_aux=True)(
                        x, k, "dilated"))
                (_, yb), (dxb, dkb) = (
                    jax.value_and_grad(loss, (0, 1), has_aux=True)(
                        x, k, "phase_split"))
                for a, b in ((ya, yb), (dxa, dxb), (dka, dkb)):
                    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                               rtol=1e-5, atol=1e-5)
        finally:
            set_deconv_impl("dilated")

    def test_deconv2d_phase_split_double_backprop(self):
        """phase_split is built from standard primitives, so grad-of-grad
        (the IWGAN gradient-penalty composition) must compose and match
        the dilated path."""
        from hemx.ops.layers import set_deconv_impl
        x = jax.random.normal(jax.random.PRNGKey(5), (2, 4, 4, 3))
        k = jax.random.normal(jax.random.PRNGKey(6), (5, 5, 4, 3))

        def gp(x, impl):
            set_deconv_impl(impl)
            inner = lambda x: jnp.sum(deconv2d_op(x, k, (8, 8)) ** 2)
            return jnp.sum(jax.grad(inner)(x) ** 2)

        try:
            ga = jax.grad(gp)(x, "dilated")
            gb = jax.grad(gp)(x, "phase_split")
            np.testing.assert_allclose(np.asarray(ga), np.asarray(gb),
                                       rtol=1e-4, atol=1e-4)
        finally:
            set_deconv_impl("dilated")

    @pytest.mark.parametrize("spatial", [1, 2])
    def test_deconv2d_phase_split_sharded(self, spatial):
        """Both lowerings are exact under GSPMD sharding — batch over
        'data' (and height over 'spatial'): the phase-split path's kernel
        slicing + phase interleave must not trip the partitioner corners
        that broke other conv compositions (hemx/parallel/mesh.py)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from hemx.ops.layers import set_deconv_impl
        from hemx.parallel.mesh import make_mesh

        mesh = make_mesh(0, spatial=spatial)
        x = jax.random.normal(jax.random.PRNGKey(3), (8, 8, 8, 3))
        k = jax.random.normal(jax.random.PRNGKey(4), (5, 5, 4, 3))
        ct = jax.random.normal(jax.random.PRNGKey(5), (8, 16, 16, 4))

        def value_and_grads(x, k):
            def loss(x, k):
                y = deconv2d_op(x, k, (16, 16), 2, "SAME")
                return jnp.sum(y * ct), y
            (_, y), (dx, dk) = jax.value_and_grad(
                loss, (0, 1), has_aux=True)(x, k)
            return y, dx, dk

        set_deconv_impl("dilated")
        ref = jax.tree_util.tree_map(np.asarray, value_and_grads(x, k))
        x_spec = P("data", "spatial") if spatial > 1 else P("data")
        in_shardings = (NamedSharding(mesh, x_spec), NamedSharding(mesh, P()))
        try:
            for impl in ("dilated", "phase_split"):
                set_deconv_impl(impl)
                # fresh jit wrapper per impl: the lowering choice is read at
                # trace time, so a shared wrapper would reuse the first trace
                got = jax.jit(value_and_grads, in_shardings=in_shardings)(x, k)
                for a, b in zip(ref, jax.tree_util.tree_map(np.asarray, got)):
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        finally:
            set_deconv_impl("dilated")

    def test_deconv2d_layer_valid_default_inference(self):
        """Default output size honors padding: VALID inverts the VALID
        forward-conv arithmetic instead of blindly doubling."""
        layer = deconv2d(16, 5, 2, padding="VALID")
        params, state, out_shape = layer.init(jax.random.PRNGKey(0),
                                              (2, 8, 8, 32))
        assert out_shape == (2, 19, 19, 16)
        y, _ = layer.apply(params, state, jnp.ones((2, 8, 8, 32)), Ctx())
        assert y.shape == (2, 19, 19, 16)

    def test_deconv2d_layer_doubles_spatial(self):
        layer = deconv2d(16, 5, 2)
        params, state, out_shape = layer.init(jax.random.PRNGKey(0), (2, 8, 8, 32))
        assert out_shape == (2, 16, 16, 16)
        y, _ = layer.apply(params, state, jnp.ones((2, 8, 8, 32)), Ctx())
        assert y.shape == (2, 16, 16, 16)

    def test_batch_norm_normalizes(self):
        layer = batch_norm()
        params, state, _ = layer.init(jax.random.PRNGKey(0), (8, 4, 4, 3))
        x = 5.0 + 3.0 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4, 3))
        y, new_state = layer.apply(params, state, x, Ctx(training=True))
        np.testing.assert_allclose(np.asarray(jnp.mean(y)), 0.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(jnp.std(y)), 1.0, atol=1e-2)
        # moving stats moved toward batch stats
        assert float(new_state["mean"].mean()) != 0.0

    def test_batch_norm_eval_batch_stats_parity(self):
        # reference always uses batch stats (never passes is_training=False)
        layer = batch_norm(eval_stats="batch")
        params, state, _ = layer.init(jax.random.PRNGKey(0), (8, 3))
        x = 7.0 + jax.random.normal(jax.random.PRNGKey(1), (8, 3))
        y, new_state = layer.apply(params, state, x, Ctx(training=False))
        np.testing.assert_allclose(np.asarray(jnp.mean(y)), 0.0, atol=1e-4)
        # but eval must not mutate moving stats
        np.testing.assert_allclose(np.asarray(new_state["mean"]),
                                   np.asarray(state["mean"]))

    def test_sequential_threads_layer_state(self):
        """Composite layers must RETURN their children's new state —
        sequential used to copy the old state dict and drop the children's
        updates, silently freezing every nested BN's moving stats at init."""
        from hemx.core import parallel_sum

        net = sequential(batch_norm(name="bn"))
        params, state, _ = net.init(jax.random.PRNGKey(0), (8, 4, 4, 3))
        x = 5.0 + jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4, 3))
        _, new_state = net.apply(params, state, x, Ctx(training=True))
        assert float(np.abs(np.asarray(new_state["bn"]["mean"])).sum()) > 0
        # parallel_sum too
        from hemx.core import identity
        net2 = parallel_sum(batch_norm(name="bn"), identity())
        p2, s2, _ = net2.init(jax.random.PRNGKey(0), (8, 4, 4, 3))
        _, ns2 = net2.apply(p2, s2, x, Ctx(training=True))
        assert float(np.abs(np.asarray(ns2["bn"]["mean"])).sum()) > 0

    def test_composite_name_uniquing(self):
        """Duplicate child names get _N suffixes without shadowing explicit
        names (sequential), and parallel_sum uniquifies too (it used to key
        by raw layer.name, silently overwriting same-named branches)."""
        from hemx.core import parallel_sum

        net = sequential(dense(4, name="d"), dense(4, name="d"),
                         dense(4, name="d_1"))
        params, state, _ = net.init(jax.random.PRNGKey(0), (2, 4))
        assert len(params) == 3 and "d" in params and "d_1" in params
        x = jnp.ones((2, 4))
        y, _ = net.apply(params, state, x, Ctx())
        assert y.shape == (2, 4)
        ps = parallel_sum(dense(4, name="b"), dense(4, name="b"))
        pp, st, _ = ps.init(jax.random.PRNGKey(0), (2, 4))
        assert len(pp) == 2
        y2, _ = ps.apply(pp, st, x, Ctx())
        # two distinct param sets summed — not one branch applied twice
        w0, w1 = pp["b"]["w"], pp["b_1"]["w"]
        assert not np.allclose(np.asarray(w0), np.asarray(w1))
        np.testing.assert_allclose(
            np.asarray(y2),
            np.asarray((x @ w0 + pp["b"]["b"]) + (x @ w1 + pp["b_1"]["b"])),
            rtol=1e-5)

    def test_dropout_train_vs_eval(self):
        layer = dropout(0.5)
        x = jnp.ones((100, 100))
        y_eval, _ = layer.apply({}, {}, x, Ctx(training=False))
        np.testing.assert_allclose(np.asarray(y_eval), np.asarray(x))
        y_train, _ = layer.apply({}, {}, x, Ctx(training=True,
                                                rng=jax.random.PRNGKey(0)))
        kept = np.asarray(y_train) > 0
        assert 0.4 < kept.mean() < 0.6
        # inverted scaling
        np.testing.assert_allclose(np.asarray(y_train)[kept], 2.0, rtol=1e-6)

    def test_residual_shapes(self):
        layer = residual(8, 3, use_batch_norm=True, activation=lrelu, name="r")
        params, state, out_shape = layer.init(jax.random.PRNGKey(0), (2, 16, 16, 4))
        assert out_shape == (2, 16, 16, 8)
        y, new_state = layer.apply(params, state, jnp.ones((2, 16, 16, 4)),
                                   Ctx(training=True))
        assert y.shape == (2, 16, 16, 8)

    def test_sequential_and_flatten(self):
        net = sequential(conv2d(4, 3, 2, name="c"), flatten(),
                         dense(10, name="d"), name="net")
        params, state, out_shape = net.init(jax.random.PRNGKey(0), (2, 8, 8, 1))
        assert out_shape == (2, 10)
        y, _ = net.apply(params, state, jnp.ones((2, 8, 8, 1)), Ctx())
        assert y.shape == (2, 10)

    def test_xavier_fans(self):
        # conv kernel (5,5,16,32): fan_in = 5*5*16, fan_out = 5*5*32
        k = initializers.xavier_uniform(jax.random.PRNGKey(0), (5, 5, 16, 32))
        limit = np.sqrt(6.0 / (5 * 5 * 16 + 5 * 5 * 32))
        assert float(jnp.abs(k).max()) <= limit + 1e-6
        assert float(jnp.abs(k).max()) >= 0.8 * limit  # actually fills range

    def test_capture_intermediates(self):
        net = sequential(dense(4, name="d1"), dense(2, name="d2"), name="net")
        params, state, _ = net.init(jax.random.PRNGKey(0), (3, 5))
        ctx = Ctx(capture=True)
        net.apply(params, state, jnp.ones((3, 5)), ctx)
        assert set(ctx.intermediates) == {"d1", "d2"}


class TestNormalize:
    def test_u8_normalize_matches_reference_math(self):
        """The XLA normalize must match /255 exactly for every lo/hi."""
        import numpy as np
        from hemx.ops.normalize import u8_normalize, u16_normalize
        x = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3),
                                              dtype=np.uint8)
        y = np.asarray(u8_normalize(jnp.asarray(x), 0.0, 1.0))
        np.testing.assert_allclose(y, x.astype(np.float32) / 255.0, atol=1e-7)
        y2 = np.asarray(u8_normalize(jnp.asarray(x), -1.0, 1.0))
        np.testing.assert_allclose(
            y2, x.astype(np.float32) / 255.0 * 2.0 - 1.0, atol=1e-6)
        d = np.random.default_rng(1).integers(0, 65536, (2, 8, 8, 1),
                                              dtype=np.uint16)
        yd = np.asarray(u16_normalize(jnp.asarray(d)))
        np.testing.assert_allclose(yd, d.astype(np.float32) / 65535.0,
                                   atol=1e-7)


class TestComputeDtype:
    def test_bf16_policy_casts_and_restores(self):
        from hemx.ops import layers as L
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 8, 3))
        k = jax.random.normal(jax.random.PRNGKey(1), (3, 3, 3, 4))
        try:
            L.set_compute_dtype("bfloat16")
            y = L.conv2d_op(x, k, 1, "SAME")
            assert y.dtype == jnp.bfloat16
        finally:
            L.set_compute_dtype(None)
        y32 = L.conv2d_op(x, k, 1, "SAME")
        assert y32.dtype == jnp.float32
        # bf16 result approximates the f32 one
        np.testing.assert_allclose(np.asarray(y, np.float32), np.asarray(y32),
                                   atol=0.15, rtol=0.1)
