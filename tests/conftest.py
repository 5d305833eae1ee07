"""Test configuration.

By default the tests run on the CPU with 8 virtual XLA host devices, so the
sharded/multi-device paths (2-D mesh + halo exchange) are exercised without
accelerator hardware. Must run before the first ``import jax`` anywhere.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere. To run them on
the card, set ``TOPO_TEST_ON_GPU=1`` (``chip_smoke.py`` does so in its
phase (d)): the CPU is then not forced and JAX keeps its own platform.
"""

import os
import sys

# make tests/ importable (oracles.py) even under pytest's importlib mode
sys.path.insert(0, os.path.dirname(__file__))

ON_GPU = os.environ.get("TOPO_TEST_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    # parallel workers would share one persistent cache directory, whose
    # entries are written in place; the CPU suite compiles fresh instead
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on an NVIDIA GPU. Decided
    here, per test, never while modules are imported."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


# NOTE: each DEM fixture owns its rng. A shared session rng would make the
# fixture contents depend on *which tests run* (fixture creation order
# advances the stream), turning marginal tolerance tests flaky under
# subset selection (pytest tests/test_x.py vs the full suite).


@pytest.fixture(scope="session")
def dem_small():
    """A smooth synthetic DEM, float32, Alpine-like value range."""
    from scipy import ndimage

    noise = np.random.default_rng(42).standard_normal((72, 96))
    smooth = ndimage.gaussian_filter(noise, 6.0)
    dem = 1500.0 + 900.0 * smooth / np.abs(smooth).max()
    return dem.astype(np.float32)


@pytest.fixture(scope="session")
def dem_tiny():
    from scipy import ndimage

    noise = np.random.default_rng(43).standard_normal((40, 48))
    smooth = ndimage.gaussian_filter(noise, 4.0)
    dem = 1200.0 + 700.0 * smooth / np.abs(smooth).max()
    return dem.astype(np.float32)
