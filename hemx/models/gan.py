"""GAN / WGAN / IWGAN (reference: models/gan.py — one file, three regimes
selected by model name, models/gan.py:84-89,192-205).

Parity notes:
* input rescaled [0,1] -> [-1,1] (models/gan.py:49-50);
* G: dense(latent -> 4*4*4L) + stride-2 5x5 deconv chain (BN+relu) ending
  tanh/no-BN (models/gan.py:234-254). The reference hardcodes four deconvs
  (4 -> 64 px); hemx derives the stage count from the image size so 32x32
  CIFAR runs natively (at 64x64 the architecture is identical);
* D: three stride-2 5x5 convs (first without BN; no BN at all for IWGAN,
  models/gan.py:274) then dense -> scalar; sigmoid only for vanilla GAN.
  Deviation: the reference reshapes D's conv output to a hardcoded
  [-1, 4*4*4L] (models/gan.py:280), which at 64x64 input silently splits
  each 8x8 feature map into four pseudo-samples; hemx flattens the true
  feature size (documented deviation — same behavior at 32x32 input);
* losses: log-loss / Wasserstein / Wasserstein+GP lambda=10
  (models/gan.py:192-231). The gradient penalty keeps the reference's
  whole-batch norm quirk by default (see hemx.ops.losses.gradient_penalty);
* training (models/gan.py:110-175): 'gan' runs D and G updates from ONE
  batch and one z in a single fused step (the reference's single sess.run of
  both train ops); 'wgan'/'iwgan' run n_disc_train critic steps, each pulling
  a FRESH batch, then one generator step on another fresh batch;
* WGAN clips D and G weights to +-0.01; hemx clips after the optimizer apply
  (the reference's control-dependency ordering was ambiguous; documented);
* step counter: +1 per train() call (v2 semantics, SURVEY.md §7.3).
"""

from __future__ import annotations

import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np

from hemx.core import Ctx, sequential
from hemx.models import common
from hemx.models.plugin import ModelPlugin
from hemx.ops.activations import lrelu
from hemx.ops.layers import conv2d, deconv2d, dense, flatten
from hemx.ops import losses as L
from hemx.parallel.dp import jit_step
from hemx.train.optimizers import clip_params, init_optimizer


class GanModel(ModelPlugin):
    name = "gan"
    model_type = "gan"
    batch_keys = ("image",)

    @staticmethod
    def arguments() -> dict:
        return {
            "--latent_size": dict(type=int, default=200),
            "--n_disc_train": dict(type=int, default=5,
                                   help="Critic steps per generator step "
                                        "(WGAN/IWGAN; reference train.py:106)."),
            "--gp_per_sample": dict(action="store_true", default=False,
                                    help="Use the IWGAN paper's per-sample "
                                         "gradient-penalty norm instead of the "
                                         "reference's whole-batch norm quirk "
                                         "(models/gan.py:229)."),
            "--fused_critic_loop": dict(
                action=argparse.BooleanOptionalAction,
                default=True,
                help="Compile the whole n_disc_train critic loop + generator "
                     "update as ONE XLA program per train() call (identical "
                     "numerics — the same step bodies, unrolled): one device "
                     "dispatch instead of six. --no-fused_critic_loop "
                     "restores per-substep dispatch."),
        }

    def __init__(self, args, mesh):
        super().__init__(args, mesh)
        self.g_optimizer = init_optimizer(args)
        self.d_optimizer = init_optimizer(args)

    # -- networks -------------------------------------------------------------
    def _build(self, in_shape):
        n, h, w, c = in_shape
        latent = self.args.latent_size
        if h != w or h % 4 != 0 or (h // 4) & (h // 4 - 1):
            raise ValueError(f"GAN requires square images with H/4 a power of 2; got {h}x{w}")
        n_up = int(math.log2(h // 4))
        use_d_bn = self.model_type != "iwgan"
        final_sigmoid = self.model_type == "gan"

        # generator: 4x4 seed, halving channels each upsample, last layer tanh
        g_layers = [dense(4 * 4 * 4 * latent, use_batch_norm=True,
                          activation=jax.nn.relu, name="fc1"),
                    common.unflatten(4, 4, 4 * latent)]
        ch = 4 * latent
        for i in range(n_up - 1):
            ch //= 2
            g_layers.append(deconv2d(ch, 5, 2, use_batch_norm=True,
                                     activation=jax.nn.relu, name=f"dc{i+1}"))
        g_layers.append(deconv2d(c, 5, 2, activation=jnp.tanh, name=f"dc{n_up}"))
        generator = sequential(*g_layers, name="generator")

        d_layers = [conv2d(latent, 5, 2, activation=lrelu, name="c1")]
        d_layers.append(conv2d(latent * 2, 5, 2, use_batch_norm=use_d_bn,
                               activation=lrelu, name="c2"))
        d_layers.append(conv2d(latent * 4, 5, 2, use_batch_norm=use_d_bn,
                               activation=lrelu, name="c3"))
        d_layers.append(flatten())
        d_layers.append(dense(1, activation=jax.nn.sigmoid if final_sigmoid else None,
                              name="fc2"))
        discriminator = sequential(*d_layers, name="discriminator")
        return {"generator": generator, "discriminator": discriminator}

    # -- forward helpers ------------------------------------------------------
    def _g_forward(self, params, mstate, z, ctx):
        g, ms = self._nets["generator"].apply(params["generator"],
                                              mstate["generator"], z, ctx)
        return g, ms

    def _pin_fake(self, g):
        """Spatial meshes: pin generated images to the canonical batch
        layout INSIDE critic-gradient closures (d_loss_fn), where the
        critic weights see real and fake inputs in one backward pass —
        unpinned, GSPMD accumulates the two differently-sharded kernel-grad
        contributions incorrectly (common.pin_batch_sharding docstring).
        Generator-gradient closures must NOT pin: there the constraint's
        backward resharding itself perturbs the generator's fc1 grads
        (measured, tests/test_models.py::TestSpatialParallel)."""
        return common.pin_batch_sharding(g, self.mesh)

    def _d_forward(self, params, mstate, x, ctx):
        d, ms = self._nets["discriminator"].apply(params["discriminator"],
                                                  mstate["discriminator"], x, ctx)
        return d.reshape(-1), ms

    def _losses(self, d_real, d_fake):
        if self.model_type == "gan":
            return L.gan_g_loss(d_fake), L.gan_d_loss(d_real, d_fake)
        return L.wgan_g_loss(d_fake), L.wgan_d_loss(d_real, d_fake)

    # -- plugin API -----------------------------------------------------------
    def init_state(self, rng, sample_batch) -> dict:
        x = np.asarray(sample_batch["image"])
        self._image_shape = x.shape[1:]
        self._nets = self._build(x.shape)
        kg, kd = jax.random.split(rng)
        latent = self.args.latent_size
        gp, gs, gout = self._nets["generator"].init(kg, (x.shape[0], latent))
        dp, ds, _ = self._nets["discriminator"].init(kd, x.shape)
        params = {"generator": gp, "discriminator": dp}
        mstate = {"generator": gs, "discriminator": ds}
        opt = {"g": self.g_optimizer.init(gp), "d": self.d_optimizer.init(dp)}
        self._compile()
        return common.new_train_state(params, mstate, opt, self.args.seed, self.mesh)

    def _compile(self):
        from hemx.parallel.mesh import spatial_axis_size
        latent = self.args.latent_size
        model_type = self.model_type
        check = self.args.check_numerics
        # Spatial meshes: XLA's SPMD partitioner produces wrong conv-kernel
        # gradients when one compiled program accumulates grad contributions
        # under conflicting spatial shardings — measured for (a) the
        # multi-substep fused critic loop and (b) any program containing the
        # GP double-backprop (see common.pin_batch_sharding). So under
        # --spatial_parallel the critic loop dispatches per substep, and the
        # IWGAN substep splits into three programs: Wasserstein grads
        # (spatial), GP grads (pinned data-parallel), combine+apply.
        # Equality vs single-device is asserted in
        # tests/test_models.py::TestSpatialParallel.
        sp_on = spatial_axis_size(self.mesh) > 1
        self._sp_split = sp_on and model_type == "iwgan"
        self._use_fused_loop = (getattr(self.args, "fused_critic_loop", True)
                                and not sp_on)

        def sample_z(rng, n):
            return jax.random.normal(rng, (n, latent))

        def fused_gan_step(ts, batch):
            """Vanilla GAN: D and G updates from one batch + one z
            (reference: models/gan.py:110-131 single sess.run)."""
            x = 2.0 * (batch["image"] - 0.5)
            rng, new_base = common.split_step_rng(ts)
            z = sample_z(rng, x.shape[0])
            ctx = lambda: Ctx(training=True, rng=rng)

            def d_loss_fn(dp):
                params = {**ts["params"], "discriminator": dp}
                g, _ = self._g_forward(params, ts["mstate"], z, ctx())
                g = self._pin_fake(g)
                d_real, ms1 = self._d_forward(params, ts["mstate"], x, ctx())
                d_fake, ms2 = self._d_forward(
                    params, {**ts["mstate"], "discriminator": ms1}, g, ctx())
                _, d_loss = self._losses(d_real, d_fake)
                return d_loss, ms2

            def g_loss_fn(gp):
                params = {**ts["params"], "generator": gp}
                g, ms_g = self._g_forward(params, ts["mstate"], z, ctx())
                d_fake, _ = self._d_forward(params, ts["mstate"], g, ctx())
                return L.gan_g_loss(d_fake), ms_g

            (d_loss, ms_d), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
                ts["params"]["discriminator"])
            (g_loss, ms_g), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(
                ts["params"]["generator"])
            new_d, new_opt_d = common.apply_updates_group(
                self.d_optimizer, d_grads, ts["opt"]["d"], ts["params"]["discriminator"])
            new_g, new_opt_g = common.apply_updates_group(
                self.g_optimizer, g_grads, ts["opt"]["g"], ts["params"]["generator"])
            metrics = {"g_loss": g_loss, "d_loss": d_loss}
            if check:
                metrics["grad_finite"] = common.grad_finite_report(
                    {"g": g_grads, "d": d_grads})
            new_ts = {**ts,
                      "params": {"generator": new_g, "discriminator": new_d},
                      "mstate": {"generator": ms_g, "discriminator": ms_d},
                      "opt": {"g": new_opt_g, "d": new_opt_d},
                      "step": ts["step"] + 1,
                      "rng": new_base}
            return new_ts, metrics

        def d_step(ts, batch):
            """One critic update on a fresh batch (WGAN/IWGAN).

            Advances the state's base RNG so each of the n_disc_train critic
            iterations (step counter unchanged) samples fresh z and GP alpha.
            """
            x = 2.0 * (batch["image"] - 0.5)
            rng, new_base = common.split_step_rng(ts)
            rng, zk, ak = jax.random.split(rng, 3)
            z = sample_z(zk, x.shape[0])

            def d_loss_fn(dp):
                params = {**ts["params"], "discriminator": dp}
                ctx_g = Ctx(training=True, rng=rng)
                g, _ = self._g_forward(params, ts["mstate"], z, ctx_g)
                g = self._pin_fake(g)
                if model_type == "iwgan":
                    # IWGAN's D has no BatchNorm (models/gan.py:274), so the
                    # real and fake scores can come from ONE 2B-batch conv
                    # pass — bigger convs than two B-batch passes
                    both, ms2 = self._d_forward(
                        params, ts["mstate"], jnp.concatenate([x, g]),
                        Ctx(training=True, rng=rng))
                    d_real, d_fake = both[:x.shape[0]], both[x.shape[0]:]
                else:
                    d_real, ms1 = self._d_forward(params, ts["mstate"], x,
                                                  Ctx(training=True, rng=rng))
                    d_fake, ms2 = self._d_forward(
                        params, {**ts["mstate"], "discriminator": ms1}, g,
                        Ctx(training=True, rng=rng))
                _, d_loss = self._losses(d_real, d_fake)
                if model_type == "iwgan":
                    alpha = jax.random.uniform(ak, (x.shape[0], 1))

                    def d_apply(imgs):
                        scores, _ = self._d_forward(params, ts["mstate"], imgs,
                                                    Ctx(training=True, rng=rng))
                        return scores

                    gp = L.gradient_penalty(
                        d_apply, x, g, alpha,
                        per_sample=getattr(self.args, "gp_per_sample", False),
                        pin=lambda t: common.pin_batch_sharding(
                            t, self.mesh, spatial=False))
                    d_loss = d_loss + 10.0 * gp
                return d_loss, ms2

            (d_loss, ms_d), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
                ts["params"]["discriminator"])
            new_d, new_opt_d = common.apply_updates_group(
                self.d_optimizer, d_grads, ts["opt"]["d"], ts["params"]["discriminator"])
            if model_type == "wgan":
                new_d = clip_params(new_d, 0.01)
            metrics = {"d_loss": d_loss}
            if check:
                metrics["grad_finite"] = common.grad_finite_report({"d": d_grads})
            new_ts = {**ts,
                      "params": {**ts["params"], "discriminator": new_d},
                      "mstate": {**ts["mstate"], "discriminator": ms_d},
                      "opt": {**ts["opt"], "d": new_opt_d},
                      "step": ts["step"],
                      "rng": new_base}
            return new_ts, metrics

        def g_step(ts, batch):
            """One generator update on a fresh batch (WGAN/IWGAN)."""
            x = 2.0 * (batch["image"] - 0.5)  # only used for d_loss reporting
            rng, new_base = common.split_step_rng(ts)
            rng, zk = jax.random.split(rng)
            z = sample_z(zk, x.shape[0])

            def g_loss_fn(gp_):
                params = {**ts["params"], "generator": gp_}
                g, ms_g = self._g_forward(params, ts["mstate"], z,
                                          Ctx(training=True, rng=rng))
                d_fake, _ = self._d_forward(params, ts["mstate"], g,
                                            Ctx(training=True, rng=rng))
                g_loss = (L.gan_g_loss(d_fake) if model_type == "gan"
                          else L.wgan_g_loss(d_fake))
                return g_loss, (ms_g, d_fake)

            (g_loss, (ms_g, d_fake)), g_grads = jax.value_and_grad(
                g_loss_fn, has_aux=True)(ts["params"]["generator"])
            d_real, _ = self._d_forward(ts["params"], ts["mstate"], x,
                                        Ctx(training=True, rng=rng))
            _, d_loss = self._losses(d_real, d_fake)
            new_g, new_opt_g = common.apply_updates_group(
                self.g_optimizer, g_grads, ts["opt"]["g"], ts["params"]["generator"])
            if model_type == "wgan":
                new_g = clip_params(new_g, 0.01)
            metrics = {"g_loss": g_loss, "d_loss": d_loss}
            if check:
                metrics["grad_finite"] = common.grad_finite_report({"g": g_grads})
            new_ts = {**ts,
                      "params": {**ts["params"], "generator": new_g},
                      "mstate": {**ts["mstate"], "generator": ms_g},
                      "opt": {**ts["opt"], "g": new_opt_g},
                      "step": ts["step"] + 1,
                      "rng": new_base}
            return new_ts, metrics

        def eval_step(ts, batch):
            x = 2.0 * (batch["image"] - 0.5)
            rng = common.step_rng(ts)
            z = sample_z(rng, x.shape[0])
            g, _ = self._g_forward(ts["params"], ts["mstate"], z,
                                   Ctx(training=True, rng=rng))
            d_real, _ = self._d_forward(ts["params"], ts["mstate"], x,
                                        Ctx(training=True, rng=rng))
            d_fake, _ = self._d_forward(ts["params"], ts["mstate"], g,
                                        Ctx(training=True, rng=rng))
            g_loss, d_loss = self._losses(d_real, d_fake)
            return {"g_loss": g_loss, "d_loss": d_loss}

        def sample(ts, rng, n):
            z = sample_z(rng, n)
            g, _ = self._g_forward(ts["params"], ts["mstate"], z,
                                   Ctx(training=True, rng=rng))
            return (g + 1.0) / 2.0

        def capture(ts, batch):
            """Per-layer activation stats (G on z, D on real x) for
            --summarize_activations; 8 rows, stats reduced on-device."""
            x = 2.0 * (batch["image"][:8] - 0.5)
            rng = common.step_rng(ts)
            z = sample_z(rng, x.shape[0])
            ctx_g = Ctx(training=True, rng=rng, capture=True)
            self._g_forward(ts["params"], ts["mstate"], z, ctx_g)
            acts = {f"generator/{k}": v
                    for k, v in ctx_g.intermediates.items()}
            ctx_d = Ctx(training=True, rng=rng, capture=True)
            self._d_forward(ts["params"], ts["mstate"], x, ctx_d)
            acts.update({f"discriminator/{k}": v
                         for k, v in ctx_d.intermediates.items()})
            return common.summarizable_stats(acts)

        def report_grads(ts, batch):
            """Per-variable D and G gradient stats (one critic + one
            generator loss evaluation, no update) for --summarize_gradients.

            The critic loss here is the FULL training loss — for IWGAN that
            includes the 10*gradient-penalty term — so the reported
            histograms describe the gradients actually applied, matching the
            reference's summaries of the real training gradients
            (reference: hem/ops/summaries.py:64-75)."""
            x = 2.0 * (batch["image"] - 0.5)
            rng = common.step_rng(ts)
            rng, zk, ak = jax.random.split(rng, 3)
            z = sample_z(zk, x.shape[0])

            def d_loss_fn(dp):
                params = {**ts["params"], "discriminator": dp}
                g, _ = self._g_forward(params, ts["mstate"], z,
                                       Ctx(training=True, rng=rng))
                g = self._pin_fake(g)
                d_real, _ = self._d_forward(params, ts["mstate"], x,
                                            Ctx(training=True, rng=rng))
                d_fake, _ = self._d_forward(params, ts["mstate"], g,
                                            Ctx(training=True, rng=rng))
                _, d_loss = self._losses(d_real, d_fake)
                if model_type == "iwgan":
                    alpha = jax.random.uniform(ak, (x.shape[0], 1))

                    def d_apply(imgs):
                        scores, _ = self._d_forward(
                            {**ts["params"], "discriminator": dp},
                            ts["mstate"], imgs, Ctx(training=True, rng=rng))
                        return scores

                    gp = L.gradient_penalty(
                        d_apply, x, g, alpha,
                        per_sample=getattr(self.args, "gp_per_sample", False),
                        pin=lambda t: common.pin_batch_sharding(
                            t, self.mesh, spatial=False))
                    d_loss = d_loss + 10.0 * gp
                return d_loss

            def g_loss_fn(gp_):
                params = {**ts["params"], "generator": gp_}
                g, _ = self._g_forward(params, ts["mstate"], z,
                                       Ctx(training=True, rng=rng))
                d_fake, _ = self._d_forward(params, ts["mstate"], g,
                                            Ctx(training=True, rng=rng))
                return (L.gan_g_loss(d_fake) if model_type == "gan"
                        else L.wgan_g_loss(d_fake))

            d_grads = jax.grad(d_loss_fn)(ts["params"]["discriminator"])
            g_grads = jax.grad(g_loss_fn)(ts["params"]["generator"])
            return common.summarizable_stats(
                {"discriminator": d_grads, "generator": g_grads})

        def _sub_rngs(ts):
            """The SAME (z-key, alpha-key, layer-rng, next-base) derivation
            as d_step, so the split spatial-mesh programs draw identical
            randomness from identical state."""
            rng, new_base = common.split_step_rng(ts)
            rng, zk, ak = jax.random.split(rng, 3)
            return rng, zk, ak, new_base

        def d_wass_grads(ts, batch):
            """Spatial-mesh IWGAN critic substep, program 1/3: Wasserstein
            loss + grads under full (data, spatial) sharding (the one-pass
            2B-batch critic conv, exact under sp — unlike a program that
            also contains the GP double-backprop)."""
            x = 2.0 * (batch["image"] - 0.5)
            rng, zk, ak, _ = _sub_rngs(ts)
            z = sample_z(zk, x.shape[0])

            def w_fn(dp):
                params = {**ts["params"], "discriminator": dp}
                g, _ = self._g_forward(params, ts["mstate"], z,
                                       Ctx(training=True, rng=rng))
                g = self._pin_fake(g)
                both, ms2 = self._d_forward(
                    params, ts["mstate"], jnp.concatenate([x, g]),
                    Ctx(training=True, rng=rng))
                d_real, d_fake = both[:x.shape[0]], both[x.shape[0]:]
                _, d_loss = self._losses(d_real, d_fake)
                return d_loss, ms2

            (d_loss, ms_d), gw = jax.value_and_grad(w_fn, has_aux=True)(
                ts["params"]["discriminator"])
            return common.pin_replicated((d_loss, ms_d, gw), self.mesh)

        def d_gp_grads(ts, batch):
            """Program 2/3: gradient-penalty value + grads, pinned to the
            proven-exact data-parallel layout, in its OWN XLA program (the
            double-backprop mis-partitions when compiled together with any
            spatially-sharded loss term)."""
            x = 2.0 * (batch["image"] - 0.5)
            rng, zk, ak, _ = _sub_rngs(ts)
            z = sample_z(zk, x.shape[0])
            alpha = jax.random.uniform(ak, (x.shape[0], 1))

            def gp_fn(dp):
                params = {**ts["params"], "discriminator": dp}
                g, _ = self._g_forward(params, ts["mstate"], z,
                                       Ctx(training=True, rng=rng))

                def d_apply(imgs):
                    scores, _ = self._d_forward(params, ts["mstate"], imgs,
                                                Ctx(training=True, rng=rng))
                    return scores

                return L.gradient_penalty(
                    d_apply, x, g, alpha,
                    per_sample=getattr(self.args, "gp_per_sample", False),
                    pin=lambda t: common.pin_batch_sharding(
                        t, self.mesh, spatial=False))

            gp_val, ggp = jax.value_and_grad(gp_fn)(
                ts["params"]["discriminator"])
            return common.pin_replicated((gp_val, ggp), self.mesh)

        def d_combine_apply(ts, d_loss_w, ms_d, gw, gp_val, ggp):
            """Program 3/3: d_grads = gw + 10*ggp (linearity of the
            gradient — identical to differentiating the summed loss), then
            the optimizer apply; same state threading as d_step."""
            d_grads = jax.tree_util.tree_map(
                lambda a, b: a + 10.0 * b, gw, ggp)
            _, new_base = common.split_step_rng(ts)
            new_d, new_opt_d = common.apply_updates_group(
                self.d_optimizer, d_grads, ts["opt"]["d"],
                ts["params"]["discriminator"])
            metrics = {"d_loss": d_loss_w + 10.0 * gp_val}
            if check:
                metrics["grad_finite"] = common.grad_finite_report(
                    {"d": d_grads})
            new_ts = {**ts,
                      "params": {**ts["params"], "discriminator": new_d},
                      "mstate": {**ts["mstate"], "discriminator": ms_d},
                      "opt": {**ts["opt"], "d": new_opt_d},
                      "step": ts["step"],
                      "rng": new_base}
            return new_ts, metrics

        def report_g_grads(ts, batch):
            """Generator grads alone (for the spatial-mesh grad report —
            exact in its own program; z derived like the training substeps)."""
            x = 2.0 * (batch["image"] - 0.5)
            rng, zk, ak, _ = _sub_rngs(ts)
            z = sample_z(zk, x.shape[0])

            def g_loss_fn(gp_):
                params = {**ts["params"], "generator": gp_}
                g, _ = self._g_forward(params, ts["mstate"], z,
                                       Ctx(training=True, rng=rng))
                d_fake, _ = self._d_forward(params, ts["mstate"], g,
                                            Ctx(training=True, rng=rng))
                return L.wgan_g_loss(d_fake)

            return jax.grad(g_loss_fn)(ts["params"]["generator"])

        def fused_loop(ts, *batches):
            """The full WGAN/IWGAN train call — n_disc_train critic updates
            then one generator update — as one XLA program. Exactly the same
            step bodies, unrolled; numerics identical to dispatching them
            separately (DP-equality tested)."""
            d_metrics, d_flags = {}, {}
            for b in batches[:-1]:
                ts, d_metrics = d_step(ts, b)
                # AND the critic finite-ness flags across substeps — a plain
                # {**d, **g} merge would let g_step's report overwrite them
                # and --check_numerics would miss critic NaNs entirely.
                for k, v in d_metrics.get("grad_finite", {}).items():
                    d_flags[k] = jnp.logical_and(d_flags[k], v) \
                        if k in d_flags else v
            ts, g_metrics = g_step(ts, batches[-1])
            metrics = {**d_metrics, **g_metrics}
            if check:
                metrics["grad_finite"] = {**d_flags,
                                          **g_metrics["grad_finite"]}
            return ts, metrics

        n_sub = self.args.n_disc_train + 1
        self._jit_fused = jit_step(fused_gan_step, self.mesh)
        self._jit_d = jit_step(d_step, self.mesh)
        self._jit_g = jit_step(g_step, self.mesh)
        self._jit_fused_loop = jit_step(
            fused_loop, self.mesh, batch_argnums=tuple(range(1, n_sub + 1)))
        if self._sp_split:
            self._jit_d_wass = jit_step(d_wass_grads, self.mesh,
                                        donate_argnums=())
            self._jit_d_gp = jit_step(d_gp_grads, self.mesh,
                                      donate_argnums=())
            self._jit_d_combine = jit_step(d_combine_apply, self.mesh,
                                           batch_argnums=())
            self._jit_report_g = jit_step(report_g_grads, self.mesh,
                                          donate_argnums=())
        self._jit_eval = jit_step(eval_step, self.mesh, donate_argnums=())
        self._sample = jax.jit(sample, static_argnums=(2,))
        self._jit_capture = jit_step(capture, self.mesh, donate_argnums=())
        self._jit_grad_report = jit_step(report_grads, self.mesh,
                                         donate_argnums=())

    def batches_per_train_call(self) -> int:
        return 1 if self.model_type == "gan" else self.args.n_disc_train + 1

    def train(self, ts, stream):
        if self.model_type == "gan":
            return self._jit_fused(ts, next(stream))
        if self._use_fused_loop:
            batches = [next(stream) for _ in range(self.args.n_disc_train + 1)]
            return self._jit_fused_loop(ts, *batches)
        d_flags = {}
        for _ in range(self.args.n_disc_train):
            ts, d_metrics = self._d_substep(ts, next(stream))
            # Keep the critic finite-ness flags (AND across substeps) so
            # --check_numerics sees critic NaNs, not only the g_step report.
            for k, v in d_metrics.get("grad_finite", {}).items():
                d_flags[k] = jnp.logical_and(d_flags[k], v) \
                    if k in d_flags else v
        ts, metrics = self._jit_g(ts, next(stream))
        if d_flags:
            metrics = {**metrics,
                       "grad_finite": {**d_flags,
                                       **metrics.get("grad_finite", {})}}
        return ts, metrics

    def _d_substep(self, ts, batch):
        """One critic update. Spatial-mesh IWGAN: three programs (see
        _compile's sp notes); everything else: the single jitted d_step."""
        if not self._sp_split:
            return self._jit_d(ts, batch)
        d_loss_w, ms_d, gw = self._jit_d_wass(ts, batch)
        gp_val, ggp = self._jit_d_gp(ts, batch)
        return self._jit_d_combine(ts, d_loss_w, ms_d, gw, gp_val, ggp)

    def eval_losses(self, ts, batch) -> dict:
        return self._jit_eval(ts, batch)

    def capture_activations(self, ts, batch):
        return self._jit_capture(ts, batch)

    def grad_report(self, ts, batch):
        if self._sp_split:
            # The combined report program would contain the GP
            # double-backprop (mis-partitioned under sp) — assemble the
            # report from the split programs instead; d_grads stay the
            # gradients actually applied (full loss incl. 10*GP).
            _, _, gw = self._jit_d_wass(ts, batch)
            _, ggp = self._jit_d_gp(ts, batch)
            d_grads = jax.tree_util.tree_map(
                lambda a, b: a + 10.0 * b, gw, ggp)
            g_grads = self._jit_report_g(ts, batch)
            return common.summarizable_stats(
                {"discriminator": d_grads, "generator": g_grads})
        return self._jit_grad_report(ts, batch)

    def write_summaries(self, writer, step, ts, batch) -> None:
        n = min(self.args.examples, batch["image"].shape[0])
        x = np.asarray(jax.device_get(batch["image"]))[:n]
        fake = np.asarray(jax.device_get(
            self._sample(ts, jax.random.fold_in(ts["rng"], step), n)))
        writer.montage("examples/inputs", np.clip(x, 0, 1), step)
        writer.montage("examples/fake", np.clip(fake, 0, 1), step)
        writer.histogram("examples/fakes_hist", fake, step)
        writer.histogram("examples/real_hist", x, step)


class WganModel(GanModel):
    name = "wgan"
    model_type = "wgan"


class IwganModel(GanModel):
    name = "iwgan"
    model_type = "iwgan"

