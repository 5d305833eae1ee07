"""Parity on the card at deployment width, one test per family.

These need an NVIDIA GPU and skip elsewhere; ``chip_smoke.py`` runs them
on the card (phase d). The grid is the reference's Basodino example tile,
900 x 1440 at 30 m. Each tolerance is the CPU suite's (tests/test_e2e.py)
for the same family: float32 device arithmetic against scipy's float64
accumulation. Sx and valley/ridge compare on full-width row bands, where
the plain oracle's host time would otherwise dominate.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracles as orc
from topo_descriptors_tpu import ops
from topo_descriptors_tpu.geo import round_up_to_odd
from topo_descriptors_tpu.io.synthetic import basodino_like_dem, synthetic_dem
from topo_descriptors_tpu.kernels.sx_geometry import (
    sx_offsets,
    sx_sweep_dedupe,
    sx_sweep_offsets,
)
from topo_descriptors_tpu.kernels.valley import rotated_extent

pytestmark = pytest.mark.gpu
sxmod = importlib.import_module("topo_descriptors_tpu.ops.sx")

RES = 30.0
ROWS = (400, 416)  # the full-width row band compared for Sx and valley


@pytest.fixture(scope="module")
def tile():
    return basodino_like_dem(projected=True).data


def _size(meters):
    return int(round_up_to_odd(meters / RES))


def test_gpu_tpi_full_tile(tile):
    out = np.asarray(jax.jit(lambda x: ops.tpi(x, _size(2000)))(tile))
    ref = orc._tpi_oracle(tile, _size(2000))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-2)


def test_gpu_std_full_tile(tile):
    out = np.asarray(jax.jit(lambda x: ops.std(x, _size(2000)))(tile))
    # the int32-truncation quirk makes float32 variance cancellation visible
    ref = orc._std_oracle(tile, _size(2000))
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=5e-1)


def test_gpu_gradient_full_tile(tile):
    sigma = _size(1000) / 4.0
    res = {"x": np.float32(RES), "y": np.full(tile.shape[0], -RES, np.float32)}
    outs = jax.jit(lambda x: ops.gradient(x, sigma, res, 1.0))(tile)
    refs = orc._gradient_oracle(tile, sigma, res)
    for out, ref in zip(outs[:3], refs[:3]):  # aspect wraps; see test_e2e
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("radius", [500.0, 2000.0])
def test_gpu_sx_band_vs_oracle(tile, radius):
    o, d, b = sx_offsets(0.0, radius, RES, RES)
    out = np.asarray(jax.jit(lambda x: ops.sx(x, o, d, b))(tile))
    ref = orc._rows_oracle(orc._sx_oracle, tile, *ROWS, b, o, d, b, 10.0)
    np.testing.assert_allclose(out[slice(*ROWS)], ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("grid, radius, n_az", [
    ((8192, 8192), 2000.0, 1),
    ((900, 1440), 500.0, 36),
])
def test_gpu_sx_kernel_matches_scan(grid, radius, n_az):
    # same float32 fmax over the same candidates: bit-identical max ratio
    dem = jnp.asarray(synthetic_dem(*grid, seed=3))
    o, d, b = sx_sweep_offsets(np.arange(n_az) * 10.0, radius, RES, RES)
    o, d = sx_sweep_dedupe(o, d)
    kernel = jax.jit(lambda x: sxmod.sx_sweep(x, o, d, b, method="pallas"))
    scan = jax.jit(lambda x: sxmod.sx_sweep(x, o, d, b, method="xla"))
    assert bool(jnp.array_equal(kernel(dem), scan(dem), equal_nan=True))


@pytest.mark.parametrize("fn", ["same", "same_batch", "valid", "same_multi"])
def test_gpu_direct_conv_full_tile(tile, fn):
    """``method='direct'`` past ``shift_acc_max_taps`` lowers to
    conv_general_dilated (cuDNN on the card): the 2 km valley kernel at
    30 degrees (95 x 95 taps, non-binary) on the standardized tile."""
    from scipy import signal

    from topo_descriptors_tpu.ops import conv as C
    from topo_descriptors_tpu.ops.valley_ridge import prepare_valley_bank

    kernels = prepare_valley_bank(_size(2000), "valley", [0, 0.15, 0.3],
                                  angles=np.array([30.0], np.float32))[0]
    assert kernels[0].size > C.CFG.shift_acc_max_taps
    field = ((tile - tile.mean()) / tile.std()).astype(np.float32)
    x = jnp.asarray(field)
    if fn == "same":
        out = C.conv2d_same(x, kernels[0], method="direct")[None]
        refs = [kernels[0]]
    elif fn == "same_batch":
        out = C.conv2d_same_batch(x, kernels, method="direct")
        refs = list(kernels)
    elif fn == "valid":
        out = C.conv2d_valid(x[None], kernels[0], method="direct")
        refs = [kernels[0]]
    else:
        out = C.conv2d_same_multi(jnp.stack([x, -x]), kernels[0], method="direct")
        refs = [kernels[0], -kernels[0]]
    mode = "valid" if fn == "valid" else "same"
    ref = np.stack([signal.convolve(field.astype(np.float64), k, mode=mode)
                    for k in refs])
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("mode", ["valley", "ridge"])
def test_gpu_valley_ridge_band_and_direction_ties(tile, mode):
    size, flats = _size(2000), [0, 0.15, 0.3]
    norm, direction = (
        np.asarray(a) for a in ops.valley_ridge(jnp.asarray(tile), size,
                                                mode, flats)
    )
    stats = (tile.mean(), tile.std())
    margin = max(rotated_extent(size)) // 2 + 1
    ref_n, ref_d, gap = orc._rows_oracle(
        orc._valley_ridge_oracle, tile, *ROWS, margin, size, mode, flats,
        stats=stats, with_gap=True,
    )
    band = slice(*ROWS)
    rtol, atol = 1e-3, 5e-3
    np.testing.assert_allclose(norm[band], ref_n, rtol=rtol, atol=atol)
    # each angle's response may be off by the norm tolerance, so a winner
    # whose margin is under twice that is a near-tie and may fall either
    # way; a clear winner may not
    mismatch = direction[band] != ref_d
    assert mismatch.mean() < 0.02
    assert not (mismatch & (gap > 2 * (atol + rtol * ref_n))).any()
