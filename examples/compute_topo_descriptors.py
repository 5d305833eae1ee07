"""
Example batch pipeline: every descriptor family over a list of scales.

The counterpart of the reference example
(reference scripts/compute_topo_descriptors.py:12-91) — same flow
(ingest -> NaN fill -> per-family compute_* loops -> cropped NetCDF
outputs), same scale list, plus the backends the reference lacks:
pass ``--sharded`` to run over every visible GPU or ``--tiled`` to
stream out-of-core.

Run with a DEM file:    python examples/compute_topo_descriptors.py DEM.nc
Or self-contained demo: python examples/compute_topo_descriptors.py --demo
"""

import logging
import sys

from topo_descriptors_tpu import pipeline
from topo_descriptors_tpu.grid import fill_na
from topo_descriptors_tpu.io import basodino_like_dem, get_dem_netcdf

logger = logging.getLogger(__name__)

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    logging.captureWarnings(True)

    args = sys.argv[1:]
    if not args or args[0] == "--demo":
        dem_ds = basodino_like_dem(projected=True)  # synthetic Basodino-size
        domain = None
    else:
        dem_ds = get_dem_netcdf(args[0])
        # reference's Swiss LV03 target domain (scripts line 22)
        domain = {"x": slice(255000, 965000), "y": slice(480000, -160000)}

    ind_nans, dem_ds = fill_na(dem_ds)

    backend = None
    if "--sharded" in args:
        from topo_descriptors_tpu.parallel import ShardedOps, make_mesh

        backend = ShardedOps(make_mesh())
    elif "--tiled" in args:
        from topo_descriptors_tpu.parallel import TiledRunner

        backend = TiledRunner(tile_rows=4096)

    # the reference's full scale list (scripts/compute_topo_descriptors.py:25-38)
    scales_meters = [
        100, 300, 500, 1000, 2000, 4000, 6000, 10000, 20000, 30000, 60000,
        100000,
    ]
    common = dict(ind_nans=ind_nans, crop=domain, sharded=backend,
                  skip_existing=True)

    pipeline.compute_dem(dem_ds, scales_meters, **common)
    pipeline.compute_tpi(dem_ds, scales_meters, smth_factors=None, **common)
    pipeline.compute_tpi(dem_ds, scales_meters, smth_factors=1, **common)
    pipeline.compute_gradient(dem_ds, scales_meters, sig_ratios=1, **common)
    pipeline.compute_std(dem_ds, scales_meters, **common)
    pipeline.compute_valley_ridge(
        dem_ds, scales_meters[3:], mode="valley", flat_list=[0, 0.2, 0.4],
        smth_factors=0.5, **common,
    )
    pipeline.compute_valley_ridge(
        dem_ds, scales_meters[3:], mode="ridge", flat_list=[0, 0.15, 0.3],
        smth_factors=0.5, **common,
    )
    pipeline.compute_sx(dem_ds, 0, 1000, crop=domain, sharded=backend)
