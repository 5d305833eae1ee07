"""NetCDF raster I/O.

Files are written in the NetCDF-3 64-bit-offset format — what xarray's
``to_netcdf`` writes when netCDF4 is absent — with ``y``/``x`` coordinate
variables, mirroring the reference's output contract (helpers.py:34-65):
uppercase variable name, coords and attrs copied from the DEM, optional
crop, per-variable ``units`` attr, file name ``topo_<NAME>.nc``. The data
variable is laid out last and contiguous, so row bands are written straight
into a memory map of the file and host memory stays at one band.

Reads go through one windowed reader: NetCDF-3 files via
``scipy.io.netcdf_file`` (memory-mapped, so a window touches only its
rows), NetCDF-4/HDF5 files — what the reference writes through
xarray+netCDF4 — via h5py, which is then required.
"""

from __future__ import annotations

import logging
import os
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from topo_descriptors_tpu.config import CFG
from topo_descriptors_tpu.grid import Raster, RasterGrid

logger = logging.getLogger(__name__)

_RESERVED_ATTRS = ("DIMENSION_LIST", "CLASS", "NAME", "REFERENCE_LIST", "_Netcdf4Dimid")

# NetCDF-3 header tags and type codes (NetCDF classic format specification)
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
_NC_CHAR, _NC_INT, _NC_FLOAT, _NC_DOUBLE = 2, 4, 5, 6
_NC_TYPE = {np.dtype(np.float32): _NC_FLOAT, np.dtype(np.float64): _NC_DOUBLE}


def _pad4(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 4)


def _nc_name(name: str) -> bytes:
    raw = name.encode()
    return struct.pack(">i", len(raw)) + _pad4(raw)


def _nc_attrs(attrs: Dict) -> bytes:
    if not attrs:
        return b"\0" * 8  # ABSENT
    out = struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))
    for key, val in attrs.items():
        arr = np.ravel(np.asarray(val)) if not isinstance(val, str) else None
        if arr is not None and arr.size and arr.dtype.kind in "biu" \
                and np.all(np.abs(arr.astype(np.int64)) < 2**31):
            nc_type, n, data = _NC_INT, arr.size, arr.astype(">i4").tobytes()
        elif arr is not None and arr.size and arr.dtype.kind == "f":
            nc_type, n, data = _NC_DOUBLE, arr.size, arr.astype(">f8").tobytes()
        else:
            data = str(val).encode()
            nc_type, n = _NC_CHAR, len(data)
        out += _nc_name(key) + struct.pack(">ii", nc_type, n) + _pad4(data)
    return out


def _nc_header(grid: RasterGrid, name: str, units, attrs: Dict, dtype):
    """NetCDF-3 64-bit-offset header for coords y(y), x(x) and one 2-D data
    variable stored last. Returns (header bytes, data offset)."""
    ny, nx = grid.shape
    itemsize = np.dtype(dtype).itemsize
    data_size = ny * nx * itemsize
    vsizes = [ny * 8, nx * 8, min(data_size + (-data_size % 4), 2**32 - 1)]
    var_attrs = [{}, {}, {} if units is None else {"units": units}]
    dims = [(0,), (1,), (0, 1)]
    types = [_NC_DOUBLE, _NC_DOUBLE, _NC_TYPE[np.dtype(dtype)]]

    def build(begins):
        out = b"CDF\x02" + struct.pack(">i", 0)  # no record dimension
        out += struct.pack(">ii", _NC_DIMENSION, 2)
        out += _nc_name("y") + struct.pack(">i", ny)
        out += _nc_name("x") + struct.pack(">i", nx)
        out += _nc_attrs(attrs)
        out += struct.pack(">ii", _NC_VARIABLE, 3)
        for vname, d, va, t, vs, b in zip(("y", "x", name), dims, var_attrs,
                                          types, vsizes, begins):
            out += _nc_name(vname) + struct.pack(">i", len(d))
            out += b"".join(struct.pack(">i", i) for i in d)
            out += _nc_attrs(va) + struct.pack(">iiq", t, vs, b)
        return out

    size = len(build([0, 0, 0]))
    begins = [size, size + vsizes[0], size + vsizes[0] + vsizes[1]]
    return build(begins), begins[2]


class RasterBandWriter:
    """Streamed NetCDF writer: create the file up front, write row bands.

    The output half of the out-of-core story — descriptor outputs for
    continental grids are written band-by-band as the
    :class:`~topo_descriptors_tpu.parallel.tiles.TiledRunner` produces
    them, into a memory map of the data variable, so peak host memory stays
    at one band regardless of grid size. :func:`write_raster` is the
    one-band case.
    """

    def __init__(
        self,
        path,
        grid: RasterGrid,
        name: str,
        units: Optional[str] = None,
        attrs: Optional[Dict] = None,
        dtype=np.float32,
    ):
        self.path = Path(path)
        # atomic-completion contract (checkpoint/resume soundness): bands
        # stream into a .partial file that is renamed onto the final path
        # only on successful close(). A crash mid-write therefore never
        # leaves a final-named file, so the drivers' --skip-existing can
        # trust existence.
        self._tmp_path = self.path.with_name(self.path.name + ".partial")
        gattrs = {"crs": grid.crs}
        gattrs.update({k: v for k, v in (attrs or {}).items() if k != "crs"})
        header, offset = _nc_header(grid, name, units, gattrs, dtype)
        ny, nx = grid.shape
        with open(self._tmp_path, "wb") as f:
            f.write(header)
            f.write(np.asarray(grid.y, ">f8").tobytes())
            f.write(np.asarray(grid.x, ">f8").tobytes())
            f.truncate(offset + ny * nx * np.dtype(dtype).itemsize)
        self._mm = np.memmap(
            self._tmp_path, dtype=np.dtype(dtype).newbyteorder(">"),
            mode="r+", offset=offset, shape=(ny, nx),
        )

    def write_rows(self, r0: int, block: np.ndarray) -> None:
        self._mm[r0 : r0 + block.shape[0]] = block

    def close(self):
        if self._mm is not None:
            self._mm.flush()
            self._mm = None
            os.replace(self._tmp_path, self.path)

    def abort(self):
        """Close and discard the partial file (error paths)."""
        if self._mm is not None:
            self._mm = None
            self._tmp_path.unlink(missing_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            self.abort()
        else:
            self.close()


def write_raster(raster: Raster, path) -> None:
    """Write one named 2-D variable with y/x coordinate variables."""
    data = np.asarray(raster.data)
    with RasterBandWriter(path, raster.grid, raster.name, units=raster.units,
                          attrs=raster.attrs, dtype=data.dtype) as w:
        w.write_rows(0, data)


def _text(val):
    return val.decode() if isinstance(val, bytes) else val


class NetCDFWindowReader:
    """Windowed reads of a 2-D NetCDF raster.

    The streaming counterpart of :func:`read_raster` for grids larger than
    RAM: coordinates and attrs are loaded eagerly (they are 1-D and small),
    the data variable stays on disk and is read per row/column window
    (SURVEY.md §7 step 7 — the ingest half of out-of-core; the reference's
    dask path, topo.py:177-178, still opens the whole array through
    xarray). Protocol-compatible with
    :class:`~topo_descriptors_tpu.io.geotiff.GeoTiffWindowReader`:
    ``shape``/``dtype``/``grid``, ``read_rows``, slicing, context manager.
    """

    def __init__(self, path, name: Optional[str] = None):
        self._f = None
        path = Path(path)
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:3] == b"CDF":
            self._open_netcdf3(path, name)
        elif magic == b"\x89HDF":
            self._open_hdf5(path, name)
        else:
            raise ValueError(f"{path} is neither NetCDF-3 nor NetCDF-4/HDF5")
        self.height, self.width = self._v.shape
        crs = str(self.attrs.get("crs", "")) or "epsg:unknown"
        self.grid = RasterGrid(y=self._y, x=self._x, crs=crs)

    def _open_netcdf3(self, path, name):
        from scipy.io import netcdf_file

        self._f = netcdf_file(path, "r", mmap=True)
        variables = self._f.variables
        var_name = name if name in variables else None
        if var_name is None:
            var_name = next(
                (n for n, v in variables.items() if len(v.dimensions) >= 2),
                None,
            )
        if var_name is None:
            raise ValueError(f"no 2-D data variable found in {path}")
        v = variables[var_name]
        if len(v.dimensions) != 2:
            raise ValueError(
                f"windowed reads need a 2-D variable, {var_name} is "
                f"{len(v.dimensions)}-D"
            )
        self.name = var_name
        self.units = _text(v._attributes.get("units"))
        self._v = v.data
        self.dtype = v.data.dtype.newbyteorder("=")
        self.attrs = {k: _text(a) for k, a in self._f._attributes.items()}

        def coord(dim):
            if dim in variables:
                return np.array(variables[dim].data, dtype=np.float64)
            return np.arange(self._f.dimensions[dim], dtype=np.float64)

        self._y, self._x = (coord(d) for d in v.dimensions)

    def _open_hdf5(self, path, name):
        try:
            import h5py
        except ImportError as exc:
            raise ImportError(
                f"{path} is a NetCDF-4/HDF5 file; reading it needs h5py "
                "(pip install h5py), or convert it to NetCDF-3"
            ) from exc

        self._f = h5py.File(path, "r")
        var_name = None
        for nm, ds in self._f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                continue
            if name is not None and nm == name:
                var_name = nm
                break
            if name is None and ds.ndim >= 2:
                var_name = nm
        if var_name is None:
            raise ValueError(f"no 2-D data variable found in {path}")
        self._v = self._f[var_name]
        if self._v.ndim != 2:
            raise ValueError(
                f"windowed reads need a 2-D variable, {var_name} is "
                f"{self._v.ndim}-D"
            )
        self.name = var_name
        self.units = _text(self._v.attrs.get("units"))
        self.dtype = self._v.dtype

        def coord_for(dim_idx, fallback):
            scales = self._v.dims[dim_idx]
            if len(scales):
                return np.asarray(scales[0])
            if fallback in self._f:
                return np.asarray(self._f[fallback])
            return np.arange(self._v.shape[dim_idx], dtype=np.float64)

        self.attrs = {
            k: _text(a) for k, a in self._f.attrs.items()
            if k not in _RESERVED_ATTRS
        }
        self._y, self._x = coord_for(0, "y"), coord_for(1, "x")

    @property
    def shape(self):
        return (self.height, self.width)

    def close(self):
        if self._f is not None:
            self._v = None  # drop the memory map before closing its file
            self._f.close()
            self._f = None

    __del__ = close  # readers the drivers open from a path close on release

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, key) -> np.ndarray:
        rows, cols = key if isinstance(key, tuple) else (key, slice(None))
        r0, r1, step = rows.indices(self.height)
        c0, c1, cstep = cols.indices(self.width)
        if step != 1 or cstep != 1:
            raise ValueError("windowed reads support contiguous slices only")
        return self.read_rows(r0, r1, c0, c1)

    def read_rows(
        self, r0: int, r1: int, c0: int = 0, c1: Optional[int] = None
    ) -> np.ndarray:
        if c1 is None:
            c1 = self.width
        if not (0 <= r0 <= r1 <= self.height and 0 <= c0 <= c1 <= self.width):
            raise ValueError(f"window [{r0}:{r1}, {c0}:{c1}] out of bounds")
        return np.array(self._v[r0:r1, c0:c1], dtype=self.dtype)

    def to_raster(self) -> Raster:
        return Raster(
            data=self.read_rows(0, self.height),
            grid=self.grid,
            name=self.name,
            units=self.units,
            attrs=dict(self.attrs),
        )


def read_raster(path) -> Raster:
    """Read a single-variable NetCDF raster written by this module or by any
    NetCDF-3 / NetCDF-4 writer following the same conventions."""
    with NetCDFWindowReader(path) as reader:
        return reader.to_raster()


def get_dem_netcdf(path_dem) -> Raster:
    """Load a DEM and mask low elevations.

    Reference semantics (helpers.py:17-31): cast float32, squeeze, and set
    elevations <= CFG.min_elevation to NaN. GeoTIFF files (.tif/.tiff) are
    dispatched to the built-in GeoTIFF reader.
    """
    suffix = str(path_dem).lower()
    if suffix.endswith((".tif", ".tiff")):
        from topo_descriptors_tpu.io.geotiff import read_geotiff

        raster = read_geotiff(path_dem)
    else:
        raster = read_raster(path_dem)
    data = raster.data.astype(np.float32)
    data = np.where(data > CFG.min_elevation, data, np.nan)
    return raster.with_data(data)


def to_netcdf(
    array,
    dem: Raster,
    name: str,
    crop: Optional[Dict[str, slice]] = None,
    outdir=".",
    units: Optional[str] = None,
) -> Path:
    """Save one descriptor array next to the DEM's coords/attrs.

    Reference semantics (helpers.py:34-65): uppercase name, optional crop via
    label-based selection, ``units`` variable attr, file ``topo_<NAME>.nc``.
    Returns the written path.
    """
    name = str.upper(name)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = Raster(
        data=np.asarray(array),
        grid=dem.grid,
        name=name,
        units=units,
        attrs=dict(dem.attrs) | {"crs": dem.grid.crs},
    ).crop(crop)
    filename = outdir / f"topo_{name}.nc"
    write_raster(out, filename)
    logger.info(f"saved: {filename}")
    return filename
