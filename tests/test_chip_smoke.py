"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and its
GPU-vs-reference comparison must accept two runs that agree and reject two
that do not. The phases themselves run on the card (``python
chip_smoke.py``; ``pytest -m gpu`` runs it from the test suite there)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_device_phase_fails_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = _run_smoke(env)
    assert r.returncode != 0
    assert "[device] FAILED" in r.stdout
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_env):
    r = _run_smoke(gpu_env)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"


def test_compare_calls_between_two_cpu_runs():
    """The helper that holds the GPU to the CPU reference, here between a
    1-device and a data=2 CPU run of the same tiny IWGAN train call: they
    agree, and a perturbed update is caught."""
    batches = chip_smoke.iwgan_batches(3, batch=4, image=8)
    cpu = jax.devices("cpu")
    with chip_smoke.policy("float32", "highest"):
        ref = chip_smoke.iwgan_train_call(cpu[:1], batches, latent=4)
        got = chip_smoke.iwgan_train_call(cpu[:2], batches, latent=4,
                                          init=ref.start)
    assert got.span == 2 and ref.span == 1
    d = chip_smoke.compare_calls(ref, got)
    assert d["loss"] <= chip_smoke.LOSS_RTOL
    assert d["update"] <= chip_smoke.UPDATE_TOL

    old = jax.tree_util.tree_leaves(ref.start["params"])
    i = int(np.argmax([np.abs(p - o).max() for p, o in zip(got.params, old)]))
    bad = [p.copy() for p in got.params]
    bad[i] = old[i] + 1.1 * (bad[i] - old[i])  # a 10% larger update
    with pytest.raises(AssertionError):
        chip_smoke.compare_calls(ref, chip_smoke.Call(
            got.losses, got.start, bad, got.span, got.sharded))
    with pytest.raises(AssertionError, match="losses"):
        chip_smoke.compare_calls(ref, chip_smoke.Call(
            {k: v * 1.01 for k, v in got.losses.items()}, got.start,
            got.params, got.span, got.sharded))
