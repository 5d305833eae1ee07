"""I/O contract tests: atomic band-writer completion, the NetCDF-3 file
layout, attribute types, and NetCDF-4/HDF5 inputs."""

import sys

import numpy as np
import pytest


def test_band_writer_atomic_completion(tmp_path):
    """A crashed band write must not leave a final-named file that
    --skip-existing would trust (checkpoint/resume soundness)."""
    from topo_descriptors_tpu.grid import RasterGrid
    from topo_descriptors_tpu.io.netcdf import RasterBandWriter, read_raster

    grid = RasterGrid(y=np.arange(8.0)[::-1], x=np.arange(6.0),
                      crs="epsg:2056")
    path = tmp_path / "topo_X.nc"
    w = RasterBandWriter(path, grid, "X")
    w.write_rows(0, np.ones((4, 6), np.float32))
    assert not path.exists()  # mid-write: only the .partial file exists
    # simulated crash: the partial is discarded, final name never appears
    w.abort()
    assert not path.exists()
    assert not (tmp_path / "topo_X.nc.partial").exists()
    # a successful close renames onto the final path
    with RasterBandWriter(path, grid, "X") as w2:
        w2.write_rows(0, np.zeros((8, 6), np.float32))
    assert path.exists()
    assert read_raster(path).data.shape == (8, 6)


def _grid():
    from topo_descriptors_tpu.grid import RasterGrid

    return RasterGrid(y=np.arange(8.0)[::-1] * 30.0, x=np.arange(6.0) * 30.0,
                      crs="epsg:2056")


def test_written_file_is_netcdf3_readable_by_scipy(tmp_path):
    """The NetCDF-3 64-bit-offset layout xarray writes without netCDF4:
    y/x coordinate variables, the data variable on (y, x)."""
    from scipy.io import netcdf_file

    from topo_descriptors_tpu.grid import Raster
    from topo_descriptors_tpu.io.netcdf import write_raster

    data = np.arange(48, dtype=np.float32).reshape(8, 6)
    path = tmp_path / "topo_X.nc"
    write_raster(Raster(data=data, grid=_grid(), name="X", units="m"), path)
    assert path.read_bytes()[:4] == b"CDF\x02"
    with netcdf_file(path, "r", mmap=False) as f:
        v = f.variables["X"]
        assert v.dimensions == ("y", "x")
        np.testing.assert_array_equal(v.data, data)
        np.testing.assert_array_equal(f.variables["x"].data, _grid().x)
        assert v.units == b"m" and f.crs == b"epsg:2056"


def test_attrs_roundtrip_by_type(tmp_path):
    from topo_descriptors_tpu.grid import Raster
    from topo_descriptors_tpu.io.netcdf import read_raster, write_raster

    attrs = {"source": "srtm", "n": 3, "scale": 2.5, "ids": np.arange(3),
             "flag": True, "obj": {"a": 1}}
    raster = Raster(data=np.zeros((8, 6), np.float32), grid=_grid(), name="X",
                    attrs=attrs)
    write_raster(raster, tmp_path / "a.nc")
    back = read_raster(tmp_path / "a.nc").attrs
    assert back["source"] == "srtm" and back["crs"] == "epsg:2056"
    assert back["n"] == 3 and back["scale"] == 2.5 and back["flag"] == 1
    np.testing.assert_array_equal(back["ids"], [0, 1, 2])
    assert back["obj"] == "{'a': 1}"  # anything else is stored as text


def test_hdf5_input_without_h5py_names_it(tmp_path, monkeypatch):
    from topo_descriptors_tpu.io.netcdf import NetCDFWindowReader

    path = tmp_path / "dem4.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        NetCDFWindowReader(path)


def test_reader_rejects_non_netcdf(tmp_path):
    from topo_descriptors_tpu.io.netcdf import read_raster

    path = tmp_path / "x.nc"
    path.write_bytes(b"GARBAGE!")
    with pytest.raises(ValueError, match="neither NetCDF-3 nor NetCDF-4"):
        read_raster(path)
