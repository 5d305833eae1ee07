"""Descriptor-op parity vs scipy oracles.

Each oracle re-states the reference's numerical recipe (topo.py) directly in
scipy/numpy on float32 inputs — the same substrate the reference executes on —
and the jit-compiled device ops must match within float32 tolerance. This is the
numerical-regression suite the reference never had (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.ma as ma
import pytest
from scipy import ndimage, signal

from topo_descriptors_tpu import kernels, ops
from oracles import (  # noqa: F401  (shared scipy oracles)
    _gradient_oracle,
    _sx_oracle,
    _std_oracle,
    _tpi_oracle,
    _valley_ridge_oracle,
)


# --------------------------------------------------------------------------
# conv engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["direct", "fft"])
@pytest.mark.parametrize("kshape", [(5, 5), (9, 9), (6, 8), (13, 7)])
def test_conv2d_same_matches_scipy(dem_small, method, kshape, rng):
    kernel = rng.standard_normal(kshape).astype(np.float32)
    ref = signal.convolve(dem_small, kernel, mode="same")
    out = np.asarray(jax.jit(
        lambda x: ops.conv2d_same(x, kernel, method=method)
    )(dem_small))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-2)


@pytest.mark.parametrize("sigma", [0.8, 1.0, 2.5, 6.0, 25.0])
def test_gaussian_filter_matches_scipy(dem_small, sigma):
    ref = ndimage.gaussian_filter(dem_small, sigma)
    out = np.asarray(jax.jit(lambda x: ops.gaussian_filter(x, sigma))(dem_small))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=5e-3)


def test_gaussian_filter_anisotropic(dem_small):
    ref = ndimage.gaussian_filter(dem_small, (2.0, 5.0))
    out = np.asarray(jax.jit(lambda x: ops.gaussian_filter(x, (2.0, 5.0)))(dem_small))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=5e-3)


def test_gaussian_filter_huge_sigma_reflect(dem_tiny):
    # pad width far beyond the array size: multiple reflections
    ref = ndimage.gaussian_filter(dem_tiny, 30.0)
    out = np.asarray(jax.jit(lambda x: ops.gaussian_filter(x, 30.0))(dem_tiny))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=5e-3)


def test_convolve_reflect_matches_ndimage(dem_small):
    k = kernels.sobel_kernel()
    ref = ndimage.convolve(dem_small, k)
    out = np.asarray(jax.jit(lambda x: ops.convolve_reflect(x, k))(dem_small))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)


def test_gradient_axis_matches_np(dem_small):
    ref_y, ref_x = np.gradient(dem_small)
    out_y = np.asarray(jax.jit(lambda x: ops.gradient_axis(x, 0))(dem_small))
    out_x = np.asarray(jax.jit(lambda x: ops.gradient_axis(x, 1))(dem_small))
    np.testing.assert_allclose(out_y, ref_y, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(out_x, ref_x, rtol=1e-6, atol=1e-4)


def test_edge_count_plane_exact(dem_small):
    kernel = kernels.circular_kernel(9)
    ref = signal.convolve(
        np.ones_like(dem_small, dtype=np.float64), kernel.astype(np.float64), "same"
    )
    # the plane is exact (integral image); the scipy oracle itself carries
    # ~1e-5 FFT noise, hence the tolerance
    plane = ops.edge_count_plane(dem_small.shape, kernel)
    np.testing.assert_allclose(plane, ref, rtol=1e-9, atol=1e-4)


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("size,sigma", [(3, None), (9, None), (17, None), (9, 1.125)])
def test_tpi_parity(dem_small, size, sigma):
    ref = _tpi_oracle(dem_small, size, sigma)
    out = np.asarray(jax.jit(
        lambda x: ops.tpi(x, size, sigma), static_argnums=()
    )(dem_small))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-2)


@pytest.mark.parametrize("size,sigma", [(5, None), (9, None), (15, None), (9, 1.125)])
def test_std_parity(dem_small, size, sigma):
    out = np.asarray(jax.jit(lambda x: ops.std(x, size, sigma))(dem_small))
    # vs the exact float64 oracle: the centred float32 formulation stays
    # within ~0.2 std-units even at near-zero-variance pixels (where the
    # quadratic moments reach ~2^24 and f32 summation loses the tail)...
    exact = _std_oracle(dem_small, size, sigma, exact=True)
    np.testing.assert_allclose(out, exact, rtol=2e-3, atol=5e-1)
    # ...while the reference's own float32 run wanders by O(1) at
    # near-zero-variance pixels (catastrophic cancellation in
    # sum_sq - sum^2/N, clipped at 0) — loose comparison only
    ref32 = _std_oracle(dem_small, size, sigma)
    np.testing.assert_allclose(out, ref32, rtol=5e-3, atol=2.0)


@pytest.mark.parametrize("sigma,sig_ratio", [(0.5, 1), (2.25, 1), (2.25, 2.0)])
def test_gradient_parity(dem_small, sigma, sig_ratio):
    ny, nx = dem_small.shape
    res = {
        "x": np.full(nx, 30.0, dtype=np.float32),
        "y": np.full(ny, -30.0, dtype=np.float32),
    }
    refs = _gradient_oracle(dem_small, sigma, res, sig_ratio)
    outs = jax.jit(lambda x: ops.gradient(x, sigma, res, sig_ratio))(dem_small)
    for ref, out, tol in zip(refs, outs, [1e-5, 1e-5, 1e-3, 2e-2]):
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-3, atol=tol)


def test_gradient_2d_resolution(dem_small):
    # geographic grids give 2-D resolution arrays (reference helpers.py:95-101)
    ny, nx = dem_small.shape
    rng = np.random.default_rng(1)
    res = {
        "x": (30.0 + rng.random((ny, nx))).astype(np.float32),
        "y": (-30.0 - rng.random((ny, nx))).astype(np.float32),
    }
    refs = _gradient_oracle(dem_small, 2.25, res, 1)
    outs = jax.jit(lambda x: ops.gradient(x, 2.25, res, 1))(dem_small)
    for ref, out in zip(refs, outs):
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-3, atol=2e-2)


@pytest.mark.parametrize("mode", ["valley", "ridge"])
def test_valley_ridge_parity(dem_tiny, mode):
    flat_list = [0, 0.2]
    refs = _valley_ridge_oracle(dem_tiny, 7, mode, flat_list, sigma=None)
    outs = jax.jit(
        lambda x: ops.valley_ridge(x, 7, mode, flat_list)
    )(dem_tiny)
    norm, direction = (np.asarray(o) for o in outs)
    np.testing.assert_allclose(norm, refs[0], rtol=1e-3, atol=2e-3)
    # direction can differ only where the norm is near-tied between angles
    mismatched = direction != refs[1]
    assert mismatched.mean() < 0.02


def test_valley_ridge_with_smoothing(dem_tiny):
    flat_list = [0, 0.15, 0.3]
    refs = _valley_ridge_oracle(dem_tiny, 9, "valley", flat_list, sigma=1.5)
    outs = jax.jit(
        lambda x: ops.valley_ridge(x, 9, "valley", flat_list, sigma=1.5)
    )(dem_tiny)
    np.testing.assert_allclose(np.asarray(outs[0]), refs[0], rtol=1e-3, atol=2e-3)


def test_valley_ridge_rejects_bad_mode(dem_tiny):
    with pytest.raises(ValueError):
        ops.valley_ridge(dem_tiny, 7, "mountain")


@pytest.mark.parametrize("radius_min", [0.0, 100.0])
def test_sx_parity(dem_tiny, radius_min):
    offsets, distances, border = kernels.sx_offsets(
        azimuth=0.0, radius=300.0, dx=30.0, dy=30.0, radius_min=radius_min
    )
    ref = _sx_oracle(dem_tiny, offsets, distances, border, height=10.0)
    out = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border, 10.0))(dem_tiny)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


def test_sx_narrow_arc(dem_tiny):
    # azimuth_arc=0 draws a single line (reference topo.py:828-829)
    offsets, distances, border = kernels.sx_offsets(
        azimuth=45.0, radius=250.0, dx=30.0, dy=30.0, azimuth_arc=0.0
    )
    ref = _sx_oracle(dem_tiny, offsets, distances, border, height=10.0)
    out = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border, 10.0))(dem_tiny)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


def test_sx_even_window_distance_zero_quirk(dem_tiny):
    # radius 250/res 30 -> float window 17.67 -> even 18-wide window: the
    # reference's distance grid is centred one pixel off the ray convergence
    # point, leaving a distance-0 ray pixel whose candidates are atan(z/0)
    # = +/-90 deg. Parity must reproduce that behaviour (see ops.sx).
    offsets, distances, border = kernels.sx_offsets(
        azimuth=225.0, radius=250.0, dx=30.0, dy=30.0
    )
    assert (distances == 0).any()  # the quirk is present in this geometry
    ref = _sx_oracle(dem_tiny, offsets, distances, border, height=10.0)
    out = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border, 10.0))(dem_tiny)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)
    assert (np.abs(ref) == 90).any()  # the +/-90 candidates actually win somewhere


def test_valley_ridge_fft_path_matches_direct(dem_tiny):
    # the in-scan FFT formulation against the partial-DFT matmul engine
    # on the same small bank
    flat_list = [0, 0.2]
    direct = jax.jit(
        lambda x: ops.valley_ridge(x, 7, "valley", flat_list, method="dftmm")
    )(dem_tiny)
    fft = jax.jit(
        lambda x: ops.valley_ridge(x, 7, "valley", flat_list, method="fft")
    )(dem_tiny)
    np.testing.assert_allclose(
        np.asarray(fft[0]), np.asarray(direct[0]), rtol=1e-4, atol=2e-3
    )
    assert (np.asarray(fft[1]) != np.asarray(direct[1])).mean() < 0.02


@pytest.mark.parametrize("size,excl", [(5, False), (9, True), (21, False), (67, True)])
def test_conv2d_same_sat_matches_scipy(dem_small, size, excl):
    # the prefix-sum (summed-area) path for {0,1} disk kernels is exact
    # modulo float32 rounding; require scipy float64 agreement
    k = kernels.circular_kernel(size, exclude_center=excl)
    ref = signal.convolve(np.asarray(dem_small, np.float64), k, mode="same")
    out = np.asarray(
        jax.jit(lambda x: ops.conv2d_same(x, k, method="sat"))(dem_small)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-2)


def test_conv2d_sat_rejects_weighted_kernels(dem_tiny):
    from topo_descriptors_tpu.ops.conv import conv2d_same_multi, conv2d_valid

    k = kernels.gaussian_kernel1d(1.0)[:, None] * kernels.gaussian_kernel1d(1.0)
    with pytest.raises(ValueError):
        ops.conv2d_same(dem_tiny, k, method="sat")
    with pytest.raises(ValueError):
        conv2d_same_multi(dem_tiny[None], k, method="sat")
    with pytest.raises(ValueError):
        conv2d_valid(dem_tiny[None], k, method="sat")


def test_conv2d_valid_sat_matches_scipy(dem_small):
    from topo_descriptors_tpu.ops.conv import conv2d_valid

    k = kernels.circular_kernel(9)
    ref = signal.convolve(np.asarray(dem_small, np.float64), k, mode="valid")
    out = np.asarray(
        jax.jit(lambda x: conv2d_valid(x, k, method="sat"))(dem_small[None])
    )[0]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-2)


def test_conv2d_same_multi_sat_matches_scipy(dem_small):
    from topo_descriptors_tpu.ops.conv import conv2d_same_multi

    k = kernels.circular_kernel(17)
    stack = jnp.stack([dem_small, dem_small - 1500.0])
    out = np.asarray(
        jax.jit(lambda x: conv2d_same_multi(x, k, method="sat"))(stack)
    )
    for i in range(2):
        ref = signal.convolve(np.asarray(stack[i], np.float64), k, mode="same")
        # the raw-elevation field (sums ~3e5) sees plain float32 prefix
        # rounding; the descriptor ops always pass mean-centred fields
        np.testing.assert_allclose(out[i], ref, rtol=1e-4, atol=5e-2)
