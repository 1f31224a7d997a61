"""chip_smoke.py: it refuses to run without a GPU, and its comparison
helpers hold on the CPU between two of the virtual devices."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def test_refuses_cpu():
    """No GPU: a non-zero exit and no ``ok`` line, never a CPU fallback."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


@pytest.mark.parametrize("game", ["ttt", "scs"])
def test_engine_parity_between_devices(game):
    import run as cli
    from nuzero.envs import TicTacToe

    env = TicTacToe() if game == "ttt" else cli._scs_env("open_field_5.yml")
    cpu = jax.devices("cpu")
    steps = chip_smoke.engine_parity(env, 16, 12, cpu[0], cpu[1])
    assert steps > 4


def test_dp_gradient_matches_one_device():
    """One learner gradient on a 2-device dp mesh equals the 1-device one
    within the 4-card tolerance (the --four-cards comparison)."""
    import run as cli
    from nuzero.training.learner import Learner, LearnerConfig

    env = cli._scs_env("open_field_5.yml")
    mgr = cli._managers(env, "recurrent", filters=8)
    learner = Learner(mgr, LearnerConfig(train_iterations=2, prog_alpha=0.01))
    cpu = jax.devices("cpu")
    loss_err, grad_err = chip_smoke.dp_gradient_error(learner, env, 8, cpu[0], cpu[:2])
    assert loss_err <= chip_smoke.TOL_DP_GRAD
    assert grad_err <= chip_smoke.TOL_DP_GRAD


def test_hexconv_error_on_cpu_is_small():
    err = chip_smoke.hexconv_error(
        2, 10, 8, 8, jnp.float32, lambda: jax.default_matmul_precision("highest")
    )
    assert err <= chip_smoke.TOL_F32_HIGHEST


@pytest.mark.gpu
def test_hexconv_on_gpu_matches_oracle(gpu):
    """On the card: bf16 at the flagship width and f32 under "highest",
    within chip_smoke's tolerances."""
    with jax.default_device(gpu):
        bf16 = chip_smoke.hexconv_error(
            64, 5, 256, 256, jnp.bfloat16, lambda: jax.default_matmul_precision("default")
        )
        f32 = chip_smoke.hexconv_error(
            16, 10, 64, 64, jnp.float32, lambda: jax.default_matmul_precision("highest")
        )
    assert bf16 <= chip_smoke.TOL_BF16_CONV
    assert f32 <= chip_smoke.TOL_F32_HIGHEST
    assert np.isfinite([bf16, f32]).all()
