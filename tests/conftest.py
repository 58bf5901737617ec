"""Test config: force an 8-device CPU mesh so multi-device (DP) paths are
exercised on any machine (SURVEY.md §4 implication 3). The platform is set
through jax.config as well as XLA_FLAGS, before the first backend
initializes, so an inherited JAX_PLATFORMS cannot move the suite onto a
GPU. Tests that need the GPU carry the ``gpu`` marker and run their work
in a child process (see the ``gpu_env`` fixture).
"""

import os
import re

# The suite hard-asserts 8-device mesh shapes, so an inherited
# xla_force_host_platform_device_count with any other value must be
# REPLACED, not respected (else dozens of tests fail with baffling
# mesh-shape errors).
flags = os.environ.get("XLA_FLAGS", "")
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=8").strip()

import subprocess
import sys
import types

import jax

jax.config.update("jax_platforms", "cpu")

import pytest


def make_args(**overrides):
    """A minimal args namespace with reference defaults."""
    base = dict(
        seed=42, n_devices=0, profile=False, check_numerics=False,
        model="cnn", examples=4, epochs="1", batch_size=8, epoch_size=-1,
        dir=None, max_to_keep=0, test_epochs=[], summary_freq=0,
        dtype="float32", precision="default", optimizer="rmsprop", lr=1e-3,
        loss="l1",
        momentum=0.01, decay=0.9, centered=False, beta1=0.9, beta2=0.999,
        dataset="synthetic", shuffle=True, buffer_size=10000, cache_dir=None,
        raw_dataset_dir="/tmp", dataset_dir="datasets", n_threads=1,
        latent_size=16, n_disc_train=2, vae_parity_loss=False,
        synthetic_count=64, synthetic_shape=[32, 32, 3],
        synthetic_eval_count=0, synthetic_u8=False,
        device_data_cache=True, device_cache_mb=1024,
    )
    base.update(overrides)
    return types.SimpleNamespace(**base)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and skips without one (the same "
                   "work is a phase of chip_smoke.py)")


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process that may use the GPU (this process
    is held to the CPU); skips the test when the child would find none."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip() != "gpu":
        pytest.skip("no GPU visible to a child process")
    return env


@pytest.fixture
def args():
    return make_args()


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices()
