"""Out-of-core banded execution vs single-pass ops (CPU).

Band boundaries must be invisible: any tile size >= one halo produces the
same result as the whole-array op, including the global boundary rows.
"""

import jax
import numpy as np
import pytest

from topo_descriptors_tpu import kernels, ops
from topo_descriptors_tpu.parallel.tiles import TiledRunner


@pytest.fixture(scope="module")
def runner():
    return TiledRunner(tile_rows=16)


def test_tiled_gaussian(dem_small, runner):
    single = np.asarray(jax.jit(lambda x: ops.gaussian_filter(x, 3.0))(dem_small))
    tiled = runner.gaussian(dem_small, 3.0)
    np.testing.assert_allclose(tiled, single, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("size,sigma", [(9, None), (9, 1.5)])
def test_tiled_tpi(dem_small, runner, size, sigma):
    single = np.asarray(jax.jit(lambda x: ops.tpi(x, size, sigma))(dem_small))
    tiled = runner.tpi(dem_small, size, sigma)
    np.testing.assert_allclose(tiled, single, rtol=1e-5, atol=2e-2)


def test_tiled_std(dem_small, runner):
    single = np.asarray(jax.jit(lambda x: ops.std(x, 9))(dem_small))
    tiled = runner.std(dem_small, 9)
    np.testing.assert_allclose(tiled, single, rtol=1e-3, atol=5e-1)


@pytest.mark.parametrize("sigma,ratio", [(0.5, 1.0), (2.25, 1.0), (2.0, 1.5)])
def test_tiled_gradient(dem_small, runner, sigma, ratio):
    ny, nx = dem_small.shape
    res = {
        "x": np.full(nx, 30.0, np.float32),
        "y": np.full(ny, -30.0, np.float32),
    }
    single = jax.jit(lambda x: ops.gradient(x, sigma, res, ratio))(dem_small)
    tiled = runner.gradient(dem_small, sigma, res, ratio)
    for s, t in zip(single, tiled):
        np.testing.assert_allclose(t, np.asarray(s), rtol=1e-3, atol=2e-2)


def test_tiled_gradient_2d_resolution(dem_small, runner):
    # geographic grids: 2-D resolution planes must band along with the DEM
    ny, nx = dem_small.shape
    rng = np.random.default_rng(3)
    res = {
        "x": (30.0 + rng.random((ny, nx))).astype(np.float32),
        "y": (-30.0 - rng.random((ny, nx))).astype(np.float32),
    }
    single = jax.jit(lambda x: ops.gradient(x, 2.25, res, 1.0))(dem_small)
    tiled = runner.gradient(dem_small, 2.25, res, 1.0)
    for s, t in zip(single, tiled):
        np.testing.assert_allclose(t, np.asarray(s), rtol=1e-3, atol=2e-2)


@pytest.mark.parametrize("sigma", [None, 1.5])
def test_tiled_valley_ridge(dem_tiny, runner, sigma):
    single = jax.jit(
        lambda x: ops.valley_ridge(x, 7, "valley", (0, 0.2), sigma)
    )(dem_tiny)
    tiled = runner.valley_ridge(dem_tiny, 7, "valley", (0, 0.2), sigma)
    np.testing.assert_allclose(
        tiled[0], np.asarray(single[0]), rtol=1e-3, atol=2e-3
    )
    assert (tiled[1] != np.asarray(single[1])).mean() < 0.02


def test_tiled_valley_ridge_streamed_branch(dem_tiny, runner, monkeypatch):
    """The bank>budget tiled branch (tiles.py routes bank=None -> the
    streamed on-device-rotation path per band). Forcing a 1-byte budget
    makes size 7 take it."""
    from topo_descriptors_tpu.config import CFG

    ref = jax.jit(
        lambda x: ops.valley_ridge(x, 7, "valley", (0, 0.2))
    )(dem_tiny)
    monkeypatch.setattr(CFG, "valley_bank_max_bytes", 1)
    tiled = runner.valley_ridge(dem_tiny, 7, "valley", (0, 0.2))
    np.testing.assert_allclose(
        tiled[0], np.asarray(ref[0]), rtol=1e-3, atol=3e-3
    )
    assert (tiled[1] != np.asarray(ref[1])).mean() < 0.02


def test_tiled_sx(dem_small, runner):
    offsets, distances, border = kernels.sx_offsets(45.0, 300.0, 30.0, 30.0)
    single = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border))(dem_small)
    )
    tiled = runner.sx(dem_small, offsets, distances, border)
    np.testing.assert_allclose(tiled, single, rtol=1e-5, atol=1e-4)


def test_tiled_sx_band_smaller_than_halo(dem_small):
    # tile_rows far below the ray border: windows still stitch exactly
    offsets, distances, border = kernels.sx_offsets(0.0, 500.0, 30.0, 30.0)
    assert border > 8
    runner = TiledRunner(tile_rows=8)
    single = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border))(dem_small)
    )
    tiled = runner.sx(dem_small, offsets, distances, border)
    np.testing.assert_allclose(tiled, single, rtol=1e-5, atol=1e-4)


def test_pipeline_with_tiled_backend(tmp_path):
    from topo_descriptors_tpu import pipeline
    from topo_descriptors_tpu.io import basodino_like_dem, read_raster

    dem = basodino_like_dem(ny=48, nx=64, projected=True)
    tiled = TiledRunner(tile_rows=16)
    files = pipeline.compute_tpi(dem, [300], outdir=tmp_path, sharded=tiled)
    single = pipeline.compute_tpi(dem, [300], outdir=tmp_path / "s")
    a = read_raster(files[0]).data
    b = read_raster(single[0]).data
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-2)
    files = pipeline.compute_sx(dem, 0, 300, outdir=tmp_path, sharded=tiled)
    single = pipeline.compute_sx(dem, 0, 300, outdir=tmp_path / "s")
    np.testing.assert_allclose(
        read_raster(files[0]).data, read_raster(single[0]).data,
        rtol=1e-5, atol=1e-3,
    )


def test_tiled_sx_sweep(dem_small, runner):
    # whole fan per band: band boundaries and the azimuth batch must both be
    # invisible vs the single-pass sweep
    offsets, distances, border = kernels.sx_sweep_offsets(
        [0.0, 90.0, 225.0], 300.0, 30.0, 30.0
    )
    single = np.asarray(
        jax.jit(
            lambda x: ops.sx_sweep(x, offsets, distances, border)
        )(dem_small)
    )
    tiled = runner.sx_sweep(dem_small, offsets, distances, border)
    np.testing.assert_array_equal(tiled, single)


def test_pipelined_and_serial_drivers_identical(dem_small):
    """The 3-stage pipelined band driver must produce byte-identical
    results to the serial loop (same band boundaries, same math)."""
    from topo_descriptors_tpu.parallel.tiles import TiledRunner

    piped = TiledRunner(tile_rows=24, pipeline=True)
    serial = TiledRunner(tile_rows=24, pipeline=False)
    np.testing.assert_array_equal(
        piped.tpi(dem_small, 11), serial.tpi(dem_small, 11)
    )
    out_p = piped.disk_descriptors(dem_small, [7, 11])
    out_s = serial.disk_descriptors(dem_small, [7, 11])
    for kind in ("tpi", "std"):
        np.testing.assert_array_equal(out_p[kind], out_s[kind])


def test_pipelined_driver_propagates_errors_without_hanging(dem_small):
    """A compute error mid-pipeline must tear down the prefetch/writer
    threads and re-raise, not deadlock on a full queue."""
    from topo_descriptors_tpu.parallel.tiles import TiledRunner

    runner = TiledRunner(tile_rows=8, pipeline=True)
    calls = {"n": 0}

    def boom(window, meta):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("synthetic compute failure")
        return np.zeros((meta[1] - meta[0], dem_small.shape[1]), np.float32)

    with pytest.raises(RuntimeError, match="synthetic compute failure"):
        runner._drive(dem_small, (2, 2), boom, lambda m, r: None)


def test_pipelined_sink_error_propagates(dem_small):
    from topo_descriptors_tpu.parallel.tiles import TiledRunner

    runner = TiledRunner(tile_rows=8, pipeline=True)

    def bad_sink(start, band):
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        runner.tpi(dem_small, 7, sink=bad_sink)
