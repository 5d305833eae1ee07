"""End-to-end pipeline + I/O tests (CPU): the reference's driver contract.

Covers the full compute_* API surface — naming, units, crop, NaN protocol,
NetCDF round-trip — mirroring the executable-README behaviour that serves as
the reference's de-facto integration test (SURVEY.md §4).
"""

import numpy as np
import pytest

from topo_descriptors_tpu import pipeline
from topo_descriptors_tpu.config import CFG, Config
from topo_descriptors_tpu.grid import Raster, RasterGrid, fill_na
from topo_descriptors_tpu.io import (
    basodino_like_dem,
    get_dem_netcdf,
    read_raster,
    synthetic_dem,
    write_raster,
)


@pytest.fixture()
def dem_raster():
    r = basodino_like_dem(ny=48, nx=64, projected=True)
    return r


def test_netcdf_roundtrip(tmp_path, dem_raster):
    path = tmp_path / "DEM.nc"
    write_raster(dem_raster, path)
    back = read_raster(path)
    np.testing.assert_allclose(back.data, dem_raster.data)
    np.testing.assert_allclose(back.grid.y, dem_raster.grid.y)
    np.testing.assert_allclose(back.grid.x, dem_raster.grid.x)
    assert back.grid.crs == dem_raster.grid.crs
    assert back.name == "DEM"
    assert back.units == "m"


def test_netcdf_is_hdf5_with_dimension_scales(tmp_path, dem_raster):
    """NetCDF-4 inputs (HDF5 with dimension scales, what the reference
    writes through xarray+netCDF4) read like the NetCDF-3 files written
    here."""
    h5py = pytest.importorskip("h5py")

    path = tmp_path / "DEM.nc"
    with h5py.File(path, "w") as f:
        for dim, vals in (("y", dem_raster.grid.y), ("x", dem_raster.grid.x)):
            f.create_dataset(dim, data=vals).make_scale(dim)
        v = f.create_dataset("DEM", data=dem_raster.data)
        v.dims[0].attach_scale(f["y"])
        v.dims[1].attach_scale(f["x"])
        v.attrs["units"] = "m"
        f.attrs["crs"] = dem_raster.grid.crs
    back = read_raster(path)
    np.testing.assert_array_equal(back.data, dem_raster.data)
    np.testing.assert_allclose(back.grid.y, dem_raster.grid.y)
    assert back.grid.crs == dem_raster.grid.crs
    assert (back.name, back.units) == ("DEM", "m")


def test_get_dem_netcdf_masks_low_elevations(tmp_path, dem_raster):
    data = dem_raster.data.copy()
    data[3:5, 7] = -400.0  # below CFG.min_elevation = -100
    path = tmp_path / "DEM.nc"
    write_raster(dem_raster.with_data(data), path)
    dem = get_dem_netcdf(path)
    assert np.isnan(dem.data[3, 7]) and np.isnan(dem.data[4, 7])
    assert dem.data.dtype == np.float32


def test_compute_tpi_contract(tmp_path, dem_raster):
    data = dem_raster.data.copy()
    data[10, 12] = np.nan
    dem = dem_raster.with_data(data)
    ind_nans, dem = fill_na(dem)
    files = pipeline.compute_tpi(
        dem, [300, 600], smth_factors=[None, 1], ind_nans=ind_nans,
        outdir=tmp_path,
    )
    names = sorted(p.name for p in files)
    assert names == ["topo_TPI_300M.nc", "topo_TPI_600M_SMTHFACT1.nc"]
    out = read_raster(files[0])
    assert out.units == "m"
    assert np.isnan(out.data[10, 12])  # NaN protocol (reference topo.py:139)
    assert out.data.shape == dem.data.shape


def test_compute_gradient_contract(tmp_path, dem_raster):
    files = pipeline.compute_gradient(dem_raster, [300], outdir=tmp_path)
    names = [p.name for p in files]
    assert names == [
        "topo_WE_DERIVATIVE_300M_SIGRATIO1.nc",
        "topo_SN_DERIVATIVE_300M_SIGRATIO1.nc",
        "topo_SLOPE_300M_SIGRATIO1.nc",
        "topo_ASPECT_300M_SIGRATIO1.nc",
    ]
    slope = read_raster(files[2])
    assert slope.units == "degree"
    assert (np.asarray(slope.data) >= 0).all()
    aspect = read_raster(files[3])
    assert (np.asarray(aspect.data) >= 0).all()
    assert (np.asarray(aspect.data) < 360).all()


def test_compute_std_and_dem_contract(tmp_path, dem_raster):
    files = pipeline.compute_std(dem_raster, 300, outdir=tmp_path)
    assert files[0].name == "topo_STD_300M.nc"
    assert (np.asarray(read_raster(files[0]).data) >= 0).all()
    files = pipeline.compute_dem(dem_raster, 300, outdir=tmp_path)
    assert files[0].name == "topo_DEM_300M.nc"


def test_compute_valley_ridge_contract(tmp_path, dem_raster):
    files = pipeline.compute_valley_ridge(
        dem_raster, [400], mode="ridge", smth_factors=0.5, outdir=tmp_path
    )
    names = [p.name for p in files]
    assert names == [
        "topo_RIDGE_NORM_400M_SMTHFACT0.5.nc",
        "topo_RIDGE_DIR_400M_SMTHFACT0.5.nc",
    ]
    direction = read_raster(files[1])
    assert direction.units == "1"
    d = np.asarray(direction.data)
    assert (d >= 0).all() and (d <= 179).all()


def test_compute_sx_contract(tmp_path, dem_raster):
    files = pipeline.compute_sx(dem_raster, 90, 300, outdir=tmp_path)
    assert files[0].name == "topo_SX_RADIUS300_AZIMUTH90.nc"
    out = read_raster(files[0])
    assert out.units == "degree"
    # border zeros (reference topo.py:939-941)
    assert (np.asarray(out.data)[0, :] == 0).all()


def test_crop_contract(tmp_path, dem_raster):
    # y is descending; slices follow the axis order (xarray .sel semantics)
    y0, y1 = dem_raster.grid.y[5], dem_raster.grid.y[20]
    x0, x1 = dem_raster.grid.x[8], dem_raster.grid.x[30]
    crop = {"y": slice(y0, y1), "x": slice(x0, x1)}
    files = pipeline.compute_tpi(dem_raster, [300], crop=crop, outdir=tmp_path)
    out = read_raster(files[0])
    assert out.data.shape == (16, 23)
    assert out.grid.y[0] == y0 and out.grid.x[-1] == x1


def test_config_from_file(tmp_path):
    conf = tmp_path / "topo.conf"
    conf.write_text("# comment\nmin_elevation: -50\nscale_std: 2\n")
    cfg = Config.from_file(conf)
    assert cfg.min_elevation == -50.0
    assert cfg.scale_std == 2.0
    assert cfg.std_int32_parity is True  # untouched defaults survive


def test_terrain_suite_forward():
    import jax

    from topo_descriptors_tpu.models.suite import SuiteConfig, TerrainSuite

    shape = (64, 64)
    suite = TerrainSuite(
        shape,
        SuiteConfig(
            tpi_scales_pxl=(7,),
            std_scales_pxl=(7,),
            gradient_sigmas=(2.0,),
            sig_ratios=(1.0,),
            valley_size_pxl=7,
            sx_azimuth=0.0,
            sx_radius_m=200.0,
        ),
    )
    dem = synthetic_dem(*shape, seed=5)
    out = jax.jit(suite.forward)(dem)
    assert set(out) == {
        "tpi_7px", "std_7px", "dx_s2", "dy_s2", "slope_s2", "aspect_s2",
        "valley_norm", "valley_dir", "sx",
    }
    for name, arr in out.items():
        assert arr.shape == shape, name


def test_pipeline_with_sharded_backend(tmp_path):
    import jax

    from topo_descriptors_tpu.parallel import ShardedOps, make_mesh
    from topo_descriptors_tpu.io import read_raster

    dem = basodino_like_dem(ny=64, nx=64, projected=True)
    sops = ShardedOps(make_mesh(shape=(2, 4), devices=jax.devices()[:8]))
    files = pipeline.compute_std(dem, [300], outdir=tmp_path, sharded=sops)
    single = pipeline.compute_std(dem, [300], outdir=tmp_path / "s")
    np.testing.assert_allclose(
        read_raster(files[0]).data, read_raster(single[0]).data,
        rtol=1e-3, atol=5e-2,
    )
    files = pipeline.compute_gradient(dem, [300], outdir=tmp_path, sharded=sops)
    single = pipeline.compute_gradient(dem, [300], outdir=tmp_path / "s")
    np.testing.assert_allclose(
        read_raster(files[2]).data, read_raster(single[2]).data,
        rtol=1e-3, atol=1e-2,
    )


def test_throughput_report():
    from topo_descriptors_tpu.utils.timing import Timings, timer
    from topo_descriptors_tpu.utils.profiling import roofline_for, throughput_report

    Timings.clear()
    with timer("demo op"):
        pass
    report = throughput_report(pixels=1_000_000)
    assert "demo op" in report and report["demo op"] > 0
    rl = roofline_for("NVIDIA H100 80GB HBM3")
    assert rl.sx_light_speed_ms(1_300_000, 240) > 0
    # 1 GB at the SXM part's 3.35 TB/s data-sheet bandwidth
    assert abs(rl.hbm_light_speed_ms(10**9) - 1e3 / 3350.0) < 1e-9


def test_compute_tpi_fused_multiscale_matches_per_scale(tmp_path, dem_raster):
    # >1 scale with no smoothing routes through the fused disk_descriptors
    # batch; outputs must match single-scale runs within the fused-path
    # tolerance (see test_multiscale) and keep the per-file contract
    import jax

    from topo_descriptors_tpu import geo, ops

    files = pipeline.compute_tpi(dem_raster, [300, 600, 900], outdir=tmp_path)
    assert [p.name for p in files] == [
        "topo_TPI_300M.nc", "topo_TPI_600M.nc", "topo_TPI_900M.nc",
    ]
    scales_pxl, _ = geo.scale_to_pixel([300, 600, 900], dem_raster)
    for path, size in zip(files, scales_pxl):
        ref = np.asarray(
            jax.jit(lambda x, s=int(size): ops.tpi(x, s))(dem_raster.data)
        )
        out = read_raster(path)
        np.testing.assert_allclose(out.data, ref, rtol=1e-4, atol=2e-2)


def test_compute_tpi_std_fused(tmp_path, dem_raster):
    import jax

    from topo_descriptors_tpu import geo, ops

    files = pipeline.compute_tpi_std(dem_raster, [300, 600], outdir=tmp_path)
    assert sorted(p.name for p in files) == [
        "topo_STD_300M.nc", "topo_STD_600M.nc",
        "topo_TPI_300M.nc", "topo_TPI_600M.nc",
    ]
    scales_pxl, _ = geo.scale_to_pixel([300, 600], dem_raster)
    std_ref = np.asarray(
        jax.jit(lambda x: ops.std(x, int(scales_pxl[0])))(dem_raster.data)
    )
    out = read_raster(tmp_path / "topo_STD_300M.nc")
    np.testing.assert_allclose(out.data, std_ref, rtol=2e-2, atol=5e-1)


def test_compute_tpi_fused_skip_existing(tmp_path, dem_raster):
    first = pipeline.compute_tpi(dem_raster, [300], outdir=tmp_path)
    mtime = first[0].stat().st_mtime_ns
    files = pipeline.compute_tpi(
        dem_raster, [300, 600], outdir=tmp_path, skip_existing=True
    )
    assert files[0].stat().st_mtime_ns == mtime  # untouched
    assert files[1].name == "topo_TPI_600M.nc" and files[1].exists()


def test_compute_tpi_smth_factors_fused_groups(tmp_path, dem_raster):
    # same smth_factor but different scales -> different sigmas -> no fused
    # group; parity with the per-scale op must hold exactly as before
    import jax

    from topo_descriptors_tpu import geo, ops

    files = pipeline.compute_tpi(
        dem_raster, [300, 600], smth_factors=[1, 1], outdir=tmp_path
    )
    scales_pxl, _ = geo.scale_to_pixel([300, 600], dem_raster)
    sigmas = geo.get_sigmas([1, 1], scales_pxl)
    ref = np.asarray(
        jax.jit(
            lambda x: ops.tpi(x, int(scales_pxl[1]), sigmas[1])
        )(dem_raster.data)
    )
    out = read_raster(tmp_path / "topo_TPI_600M_SMTHFACT1.nc")
    np.testing.assert_allclose(out.data, ref, rtol=1e-4, atol=2e-2)
