"""Test harness: CPU backend with 8 virtual devices, float64 enabled.

Multi-device sharding tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count``), per SURVEY §4's recommended
strategy — no accelerator needed for collective correctness tests.

Tests marked ``gpu`` need a GPU card and skip elsewhere; on the card the
main path is checked end to end by ``python chip_smoke.py``.
"""

import os

# must happen before jax import
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # JAX_PLATFORMS=cuda,cpu runs -m gpu
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_MESH_DIR = "/root/reference/mesh"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (full solves / large meshes)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a GPU card (skips without one; see chip_smoke.py)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU device (run on the card: python chip_smoke.py)")


@pytest.fixture(scope="session")
def ref_mesh_dir():
    if not os.path.isdir(REFERENCE_MESH_DIR):
        pytest.skip("reference mesh directory unavailable")
    return REFERENCE_MESH_DIR


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
