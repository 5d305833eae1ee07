"""Geo I/O: NetCDF read/write, GeoTIFF read/write and synthetic DEMs.

The reference does I/O through xarray + netCDF4 (helpers.py:17-65). Neither
library is needed here: NetCDF-3 files are written directly and read through
scipy, and NetCDF-4/HDF5 inputs are read through h5py when it is installed.
"""

from topo_descriptors_tpu.io.netcdf import (
    NetCDFWindowReader,
    RasterBandWriter,
    get_dem_netcdf,
    read_raster,
    to_netcdf,
    write_raster,
)
from topo_descriptors_tpu.io.synthetic import synthetic_dem, basodino_like_dem
from topo_descriptors_tpu.io.geotiff import (
    GeoTiffWindowReader,
    read_geotiff,
    write_geotiff,
)
from topo_descriptors_tpu.io.windowed import DemWindowReader, open_dem_window

__all__ = [
    "get_dem_netcdf",
    "read_raster",
    "to_netcdf",
    "write_raster",
    "synthetic_dem",
    "basodino_like_dem",
    "read_geotiff",
    "write_geotiff",
    "GeoTiffWindowReader",
    "NetCDFWindowReader",
    "RasterBandWriter",
    "DemWindowReader",
    "open_dem_window",
]
