"""Executable walkthrough: the full descriptor battery, with timings.

The runnable counterpart of the reference's README.ipynb (reference
README.md:24-190): build a Basodino-like ~30 m DEM, run every descriptor
family through the public API, and print the same style of per-op timing
log the reference renders in its README:

    python examples/walkthrough.py

Everything here runs on whatever jax.devices() offers — the GPU when one
is attached, CPU otherwise. See examples/compute_topo_descriptors.py for the
batch-production variant with --sharded / --tiled / --stream backends.
"""

import logging
import tempfile
from pathlib import Path

import numpy as np


def main() -> None:
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s:%(name)s: %(message)s"
    )

    import jax

    from topo_descriptors_tpu import pipeline
    from topo_descriptors_tpu.grid import fill_na
    from topo_descriptors_tpu.io import (
        basodino_like_dem,
        get_dem_netcdf,
        read_raster,
        write_raster,
    )

    outdir = Path(tempfile.mkdtemp(prefix="topo_walkthrough_"))
    print(f"device: {jax.devices()[0].device_kind}")
    print(f"outputs: {outdir}")

    # --- ingest (reference README.md:33-60) --------------------------------
    raster = basodino_like_dem(projected=True)  # ~900x1440 at 30 m
    data = raster.data.copy()
    data[380:384, 500:520] = -9999.0  # a low-elevation hole, masked at ingest
    dem_path = outdir / "Basodino-30m-DEM.nc"
    write_raster(raster.with_data(data), dem_path)

    dem_ds = get_dem_netcdf(dem_path)
    print(f"ingested {dem_ds.name}: shape {dem_ds.data.shape}, "
          f"NaNs {int(np.isnan(dem_ds.data).sum())}")
    ind_nans, dem_ds = fill_na(dem_ds)

    # --- TPI at 500 m (reference README.md:77-95) --------------------------
    pipeline.compute_tpi(dem_ds, [500], ind_nans=ind_nans, outdir=outdir)

    # --- Sx, radius 500 m, azimuth 0 (reference README.md:99-123) ----------
    pipeline.compute_sx(dem_ds, 0.0, 500.0, outdir=outdir)

    # --- the multi-scale battery (reference README.md:143-190) -------------
    scales = [200, 2000]
    pipeline.compute_gradient(dem_ds, scales, ind_nans=ind_nans, outdir=outdir)
    # TPI + rolling STD for all scales in ONE fused device program
    pipeline.compute_tpi_std(dem_ds, scales, ind_nans=ind_nans, outdir=outdir)
    pipeline.compute_valley_ridge(
        dem_ds, [2000], mode="valley", ind_nans=ind_nans, outdir=outdir
    )
    # a 36-azimuth Sx sweep as one device program (the reference loops
    # compute_sx per azimuth from the host)
    pipeline.compute_sx_sweep(
        dem_ds, list(range(0, 360, 10)), 500.0, outdir=outdir
    )

    print("\nwritten files:")
    for path in sorted(outdir.glob("topo_*.nc")):
        out = read_raster(path)
        print(f"  {path.name:42s} {out.name:28s} "
              f"min {np.nanmin(out.data):9.3f}  max {np.nanmax(out.data):9.3f}")


if __name__ == "__main__":
    main()
