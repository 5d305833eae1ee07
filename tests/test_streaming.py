"""Out-of-core streaming: windowed ingest, banded compute, streamed output.

Parity contract: every streamed driver must produce files bit/tolerance-
comparable to the in-RAM pipeline on the same DEM, while never reading more
than one halo-extended band from disk (``DemWindowReader.max_rows_read``).
"""

import numpy as np
import pytest

from topo_descriptors_tpu import pipeline, streaming
from topo_descriptors_tpu.grid import fill_na
from topo_descriptors_tpu.io import (
    DemWindowReader,
    NetCDFWindowReader,
    RasterBandWriter,
    basodino_like_dem,
    get_dem_netcdf,
    read_raster,
    write_geotiff,
    write_raster,
)

TILE_ROWS = 16  # force several bands on the 61-row fixture


@pytest.fixture(scope="module")
def dem_raster():
    r = basodino_like_dem(ny=61, nx=74, projected=True, seed=7)
    data = r.data.copy()
    data[12:15, 20:26] = -9999.0  # low-elevation hole -> masked to NaN
    data[40, 5] = np.nan
    return r.with_data(data)


@pytest.fixture(scope="module")
def dem_path(tmp_path_factory, dem_raster):
    path = tmp_path_factory.mktemp("stream") / "dem.nc"
    write_raster(dem_raster, path)
    return path


@pytest.fixture(scope="module")
def filled(dem_path):
    dem = get_dem_netcdf(dem_path)
    return fill_na(dem)  # (ind_nans, filled Raster)


# -- readers ------------------------------------------------------------------


def test_netcdf_window_reader_matches_full(dem_path, dem_raster):
    full = read_raster(dem_path)
    with NetCDFWindowReader(dem_path) as reader:
        assert reader.shape == dem_raster.data.shape
        assert reader.name == full.name
        np.testing.assert_array_equal(
            reader.read_rows(10, 30, 5, 40), full.data[10:30, 5:40]
        )
        np.testing.assert_array_equal(reader[3:9], full.data[3:9])
        np.testing.assert_allclose(reader.grid.y, full.grid.y)
        np.testing.assert_allclose(reader.grid.x, full.grid.x)
        assert reader.grid.crs == full.grid.crs


def test_dem_window_reader_matches_ingest_plus_fill(dem_path, filled):
    ind_nans, dem = filled
    with DemWindowReader(dem_path) as reader:
        # arbitrary bands reproduce get_dem_netcdf + fill_na exactly
        for r0, r1 in [(0, 61), (10, 30), (38, 42), (60, 61)]:
            np.testing.assert_array_equal(
                reader.read_rows(r0, r1), dem.data[r0:r1]
            )
        # the pre-fill hole mask round-trips
        mask = reader.nan_rows(0, 61)
        expect = np.zeros_like(mask)
        expect[ind_nans] = True
        np.testing.assert_array_equal(mask, expect)
        # column slicing still fills on the full row first
        np.testing.assert_array_equal(
            reader[12:16, 18:30], dem.data[12:16, 18:30]
        )


def test_dem_window_reader_geotiff(tmp_path, dem_raster):
    path = tmp_path / "dem.tif"
    write_geotiff(dem_raster, path, rows_per_strip=16)
    dem = get_dem_netcdf(path)
    _, dem = fill_na(dem)
    with DemWindowReader(path) as reader:
        np.testing.assert_array_equal(reader.read_rows(9, 33), dem.data[9:33])


def test_band_writer_roundtrip(tmp_path, dem_raster):
    path = tmp_path / "banded.nc"
    with RasterBandWriter(path, dem_raster.grid, "OUT", units="m",
                          attrs={"src": "test"}) as w:
        for r0 in range(0, 61, 16):
            w.write_rows(r0, dem_raster.data[r0 : r0 + 16])
    back = read_raster(path)
    np.testing.assert_array_equal(back.data, dem_raster.data)
    assert back.name == "OUT"
    assert back.units == "m"
    assert back.attrs["src"] == "test"
    assert back.grid.crs == dem_raster.grid.crs


# -- streamed drivers vs the in-RAM pipeline -----------------------------------


def _compare(streamed_paths, pipeline_paths, **tol):
    assert len(streamed_paths) == len(pipeline_paths)
    for sp, pp in zip(streamed_paths, pipeline_paths):
        a, b = read_raster(sp), read_raster(pp)
        assert a.name == b.name
        assert a.units == b.units
        if tol:
            np.testing.assert_allclose(a.data, b.data, equal_nan=True, **tol)
        else:
            np.testing.assert_array_equal(a.data, b.data)


def test_streamed_tpi_std(tmp_path, dem_path, filled):
    ind_nans, dem = filled
    from topo_descriptors_tpu.parallel.tiles import TiledRunner

    # bit-exact vs the in-RAM *tiled* backend (identical banded code path)
    tiled = pipeline.compute_tpi(dem, [300, 500], ind_nans=ind_nans,
                                 outdir=tmp_path / "ram",
                                 sharded=TiledRunner(TILE_ROWS))
    tiled += pipeline.compute_std(dem, [300], smth_factors=[1],
                                  ind_nans=ind_nans, outdir=tmp_path / "ram",
                                  sharded=TiledRunner(TILE_ROWS))
    # tolerance vs the default single-pass pipeline (fused multi-scale
    # program, different float32 summation order)
    ram = pipeline.compute_tpi(dem, [300, 500], ind_nans=ind_nans,
                               outdir=tmp_path / "ram2")
    ram += pipeline.compute_std(dem, [300], smth_factors=[1],
                                ind_nans=ind_nans, outdir=tmp_path / "ram2")
    with DemWindowReader(dem_path) as reader:
        out = streaming.compute_tpi(reader, [300, 500],
                                    outdir=tmp_path / "st",
                                    tile_rows=TILE_ROWS)
        out += streaming.compute_std(reader, [300], smth_factors=[1],
                                     outdir=tmp_path / "st",
                                     tile_rows=TILE_ROWS)
        # ingest stayed banded: halo-extended bands only, never the full grid
        assert reader.max_rows_read < 61
    _compare(out, tiled)
    _compare(out, ram, rtol=1e-4, atol=1e-3)


def test_streamed_dem_and_gradient(tmp_path, dem_path, filled):
    ind_nans, dem = filled
    ram = pipeline.compute_dem(dem, [400], ind_nans=ind_nans,
                               outdir=tmp_path / "ram")
    ram += pipeline.compute_gradient(dem, [300], ind_nans=ind_nans,
                                     outdir=tmp_path / "ram")
    out = streaming.compute_dem(dem_path, [400], outdir=tmp_path / "st",
                                tile_rows=TILE_ROWS)
    out += streaming.compute_gradient(dem_path, [300],
                                      outdir=tmp_path / "st",
                                      tile_rows=TILE_ROWS)
    _compare(out, ram)


def test_streamed_valley_ridge(tmp_path, dem_path, filled):
    ind_nans, dem = filled
    ram = pipeline.compute_valley_ridge(
        dem, [500], mode="valley", ind_nans=ind_nans, outdir=tmp_path / "ram"
    )
    out = streaming.compute_valley_ridge(
        dem_path, [500], mode="valley", outdir=tmp_path / "st",
        tile_rows=TILE_ROWS,
    )
    # the streamed stats pass accumulates float64 band-wise (vs one-shot
    # two-pass in RAM): identical to float32 op inputs, so outputs match
    _compare(out, ram, rtol=1e-4, atol=1e-4)


def test_streamed_sx_single_and_sweep(tmp_path, dem_path, filled):
    _, dem = filled
    ram = pipeline.compute_sx(dem, 45.0, 300.0, outdir=tmp_path / "ram")
    ram += pipeline.compute_sx_sweep(dem, [0.0, 90.0], 300.0,
                                     outdir=tmp_path / "ram")
    out = streaming.compute_sx(dem_path, 45.0, 300.0, outdir=tmp_path / "st",
                               tile_rows=TILE_ROWS)
    out += streaming.compute_sx(dem_path, [0.0, 90.0], 300.0,
                                outdir=tmp_path / "st", tile_rows=TILE_ROWS)
    _compare(out, ram)


def test_streamed_skip_existing(tmp_path, dem_path):
    first = streaming.compute_tpi(dem_path, [300], outdir=tmp_path,
                                  tile_rows=TILE_ROWS)
    mtime = first[0].stat().st_mtime_ns
    again = streaming.compute_tpi(dem_path, [300], outdir=tmp_path,
                                  tile_rows=TILE_ROWS, skip_existing=True)
    assert again == first
    assert first[0].stat().st_mtime_ns == mtime


# -- windowed ingest -> multi-device mesh --------------------------------------


@pytest.fixture(scope="module")
def sops8():
    import jax

    from topo_descriptors_tpu.parallel.mesh import make_mesh
    from topo_descriptors_tpu.parallel.sharded import ShardedOps

    assert len(jax.devices()) >= 8
    return ShardedOps(make_mesh(shape=(2, 4), devices=jax.devices()[:8]))


def test_ingest_sharded_bounded_reads(dem_path, filled, sops8):
    from topo_descriptors_tpu.parallel.runtime import ingest_sharded

    _, dem = filled
    with DemWindowReader(dem_path) as reader:
        global_arr, valid = ingest_sharded(reader, sops8.mesh, fill=0.0)
        # reads stayed per-row-block: never more than ceil(61/2) = 31 rows
        assert reader.max_rows_read <= -(-61 // 2)
    assert valid == (61, 74)
    assert global_arr.shape == (62, 76)  # padded to the 2x4 mesh
    np.testing.assert_array_equal(
        np.asarray(global_arr)[:61, :74], dem.data.astype(np.float32)
    )


def test_sharded_streamed_tpi_std_parity(tmp_path, dem_path, filled, sops8):
    # windowed ingest -> mesh -> banded output == in-RAM sharded pipeline
    ind_nans, dem = filled
    ram = pipeline.compute_tpi_std(dem, [300, 500], ind_nans=ind_nans,
                                   outdir=tmp_path / "ram", sharded=sops8)
    out = streaming.compute_tpi_std_sharded(
        dem_path, [300, 500], sops8, outdir=tmp_path / "st", band_rows=16,
    )
    _compare(out, ram)


def test_sharded_streamed_dem_parity(tmp_path, dem_path, filled, sops8):
    ind_nans, dem = filled
    ram = pipeline.compute_dem(dem, [400], ind_nans=ind_nans,
                               outdir=tmp_path / "ram", sharded=sops8)
    out = streaming.compute_dem_sharded(dem_path, [400], sops8,
                                        outdir=tmp_path / "st", band_rows=16)
    _compare(out, ram)


def test_sharded_streamed_gradient_parity(tmp_path, dem_path, filled, sops8):
    ind_nans, dem = filled
    ram = pipeline.compute_gradient(dem, [300], ind_nans=ind_nans,
                                    outdir=tmp_path / "ram", sharded=sops8)
    out = streaming.compute_gradient_sharded(
        dem_path, [300], sops8, outdir=tmp_path / "st", band_rows=16
    )
    _compare(out, ram)


def test_sharded_streamed_valley_parity_both_routes(tmp_path, dem_path,
                                                    filled, sops8,
                                                    monkeypatch):
    ind_nans, dem = filled
    ram = pipeline.compute_valley_ridge(
        dem, [300], mode="valley", flat_list=(0, 0.2), ind_nans=ind_nans,
        outdir=tmp_path / "ram", sharded=sops8,
    )
    out = streaming.compute_valley_ridge_sharded(
        dem_path, [300], sops8, mode="valley", flat_list=(0, 0.2),
        outdir=tmp_path / "st", band_rows=16,
    )
    _compare(out, ram)
    # force the bank over the budget: the driver must stay on the mesh via
    # the streamed sharded formulation and still match the in-RAM op
    from topo_descriptors_tpu.config import CFG

    monkeypatch.setattr(CFG, "valley_bank_max_bytes", 1)
    out2 = streaming.compute_valley_ridge_sharded(
        dem_path, [300], sops8, mode="valley", flat_list=(0, 0.2),
        outdir=tmp_path / "st2", band_rows=16,
    )
    a = read_raster(out2[0]).data
    b = read_raster(out[0]).data
    mask = np.isfinite(a) & np.isfinite(b)
    np.testing.assert_allclose(a[mask], b[mask], rtol=1e-3, atol=3e-3)


def test_sharded_streamed_sx_parity(tmp_path, dem_path, filled, sops8):
    _, dem = filled
    ram = pipeline.compute_sx(dem, 45.0, 300.0, outdir=tmp_path / "ram",
                              sharded=sops8)
    ram += pipeline.compute_sx_sweep(dem, [0.0, 90.0], 300.0,
                                     outdir=tmp_path / "ram", sharded=sops8)
    out = streaming.compute_sx_sharded(dem_path, 45.0, 300.0, sops8,
                                       outdir=tmp_path / "st", band_rows=16)
    out += streaming.compute_sx_sharded(dem_path, [0.0, 90.0], 300.0, sops8,
                                        outdir=tmp_path / "st", band_rows=16)
    _compare(out, ram)


def test_sharded_streamed_skip_existing(tmp_path, dem_path, sops8):
    first = streaming.compute_tpi_std_sharded(dem_path, [300], sops8,
                                              outdir=tmp_path)
    again = streaming.compute_tpi_std_sharded(dem_path, [300], sops8,
                                              outdir=tmp_path,
                                              skip_existing=True)
    assert again == first


def test_streamed_fused_tpi_std_writes_both_families(tmp_path, dem_small):
    """compute_tpi_std: ONE banded pass writes every (descriptor, scale)
    output of the group (single-chip analog of the sharded fused driver)."""
    from topo_descriptors_tpu import streaming
    from topo_descriptors_tpu.grid import Raster, RasterGrid
    from topo_descriptors_tpu.io.netcdf import read_raster, write_raster

    ny, nx = dem_small.shape
    grid = RasterGrid(
        y=np.arange(ny, dtype=np.float64)[::-1] * 30.0,
        x=np.arange(nx, dtype=np.float64) * 30.0,
        crs="epsg:2056",
    )
    path = tmp_path / "DEM.nc"
    write_raster(Raster(dem_small, grid, name="dem", units="m"), path)
    files = streaming.compute_tpi_std(
        path, [300, 600], outdir=tmp_path, tile_rows=32
    )
    names = sorted(read_raster(f).name for f in files)
    assert names == ["STD_300M", "STD_600M", "TPI_300M", "TPI_600M"]
    # parity vs the unfused streamed driver (float32 tolerance: the fused
    # pass uses the larger scale's halo, so band windows differ in height
    # and the prefix-sum accumulation order shifts within f32 rounding)
    sep = streaming.compute_tpi(path, [300], outdir=tmp_path / "sep",
                                tile_rows=32)
    np.testing.assert_allclose(
        read_raster([f for f in files if "TPI_300" in str(f)][0]).data,
        read_raster(sep[0]).data, atol=2e-3,
    )
