"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the CPU; sharding correctness is validated on a virtual
CPU mesh (the reference's analogue: local ``ray.init``
standing in for a cluster — ref ``Utils/Functions/ray_utils.py:6-10``).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

# Pin computations to the virtual 8-device CPU backend, also when
# JAX_PLATFORMS lists a GPU too, so tests are hermetic and mesh-capable;
# tests marked ``gpu`` place their work on the card explicitly.
jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])


def cpu_devices():
    return jax.local_devices(backend="cpu")


@pytest.fixture
def gpu():
    """The first GPU, for tests marked ``gpu``; skips where there is none
    (decided here, at run time, never at import)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu on the card")
