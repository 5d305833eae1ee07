"""Command-line batch driver.

The GPU equivalent of the reference's example script
(scripts/compute_topo_descriptors.py:12-91): ingest a DEM, fill NaNs, and
run a battery of descriptors over a list of scales, writing one NetCDF per
(descriptor, scale). Adds what the reference's script lacks: descriptor
selection, ``--skip-existing`` restartability, multi-device sharding, and
structured throughput logging.

Usage::

    python -m topo_descriptors_tpu --dem DEM.nc --outdir out \
        --descriptors tpi std gradient --scales 500 2000 \
        --crop-x 255000 965000 --crop-y -160000 480000

    python -m topo_descriptors_tpu --synthetic 900x1440 \
        --descriptors sx --sx-azimuths 0 90 180 270 --sx-radius 500 \
        --sharded
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

ALL_DESCRIPTORS = ("dem", "tpi", "std", "gradient", "valley", "ridge", "sx")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="topo_descriptors_tpu",
        description="Multi-scale terrain descriptors on the GPU (JAX)",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dem", type=Path, help="input DEM NetCDF file")
    src.add_argument(
        "--synthetic",
        metavar="NYxNX",
        help="use a synthetic fractal DEM of the given shape (benchmarks)",
    )
    p.add_argument("--outdir", type=Path, default=Path("."))
    p.add_argument(
        "--descriptors",
        nargs="+",
        choices=ALL_DESCRIPTORS,
        default=["tpi", "std", "gradient"],
    )
    p.add_argument(
        "--scales",
        nargs="+",
        type=float,
        default=[100, 300, 500, 1000, 2000, 4000, 6000, 10000],
        help="scales in meters (reference script defaults, truncated)",
    )
    p.add_argument("--smth-factors", nargs="+", type=float, default=None)
    p.add_argument("--sig-ratios", nargs="+", type=float, default=[1.0])
    p.add_argument("--flat-list", nargs="+", type=float, default=[0, 0.15, 0.3])
    p.add_argument("--sx-azimuths", nargs="+", type=float, default=[0.0])
    p.add_argument("--sx-radius", type=float, default=500.0)
    p.add_argument("--sx-height", type=float, default=10.0)
    p.add_argument("--crop-x", nargs=2, type=float, default=None)
    p.add_argument("--crop-y", nargs=2, type=float, default=None)
    p.add_argument(
        "--skip-existing",
        action="store_true",
        help="skip (descriptor, scale) outputs already present in --outdir",
    )
    p.add_argument(
        "--sharded",
        action="store_true",
        help="run over all visible devices on a 2-D spatial mesh",
    )
    p.add_argument(
        "--tiled",
        type=int,
        metavar="ROWS",
        help="stream the DEM out-of-core in row bands of this height",
    )
    p.add_argument(
        "--stream",
        type=int,
        metavar="ROWS",
        help="fully out-of-core: windowed ingest straight from --dem "
        "(GeoTIFF strips/tiles or NetCDF hyperslabs), banded compute, and "
        "band-streamed NetCDF output — host RAM stays at one band "
        "regardless of grid size (requires --dem; --crop unsupported)",
    )
    p.add_argument("--mesh", nargs=2, type=int, default=None, metavar=("GY", "GX"))
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _main_streamed(args) -> int:
    """Fully out-of-core battery: disk -> banded device compute -> disk.

    With ``--sharded``, windowed ingest goes straight onto the device mesh
    (each process reads only its devices' blocks), every descriptor runs as
    shard_map programs, and outputs stream back in row bands — the
    full-Alps multi-host shape (BASELINE.md configs[4])."""
    from topo_descriptors_tpu import streaming

    if args.dem is None:
        raise SystemExit("--stream requires --dem (a file to read windowed)")
    if args.tiled:
        raise SystemExit("--stream already implies banded execution; drop "
                         "--tiled")
    if args.crop_x or args.crop_y:
        raise SystemExit("--crop is not supported with --stream (crop the "
                         "streamed outputs afterwards)")

    args.scales = [int(s) if float(s).is_integer() else s for s in args.scales]
    args.outdir.mkdir(parents=True, exist_ok=True)
    common = dict(outdir=args.outdir, skip_existing=args.skip_existing)
    sig_ratios = args.sig_ratios * len(args.scales) \
        if len(args.sig_ratios) == 1 else args.sig_ratios

    sops = None
    if args.sharded:
        from topo_descriptors_tpu.parallel.mesh import make_mesh
        from topo_descriptors_tpu.parallel.sharded import ShardedOps

        mesh = make_mesh(shape=tuple(args.mesh) if args.mesh else None)
        logger.info(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")
        sops = ShardedOps(mesh)
    else:
        common["tile_rows"] = args.stream

    with streaming.open_dem(args.dem) as dem:
        logger.info(f"streaming DEM {dem.shape}, crs {dem.grid.crs}, "
                    + (f"mesh ingest" if sops else
                       f"bands of {args.stream} rows"))
        written = []
        for name in args.descriptors:
            if name == "dem":
                if sops:
                    written += streaming.compute_dem_sharded(
                        dem, args.scales, sops, **common)
                else:
                    written += streaming.compute_dem(
                        dem, args.scales, **common)
            elif name in ("tpi", "std"):
                both = "tpi" in args.descriptors and "std" in args.descriptors
                if both and name != "tpi":
                    continue  # handled by the fused pass below
                if sops:
                    kinds = ("tpi", "std") if both else (name,)
                    written += streaming.compute_tpi_std_sharded(
                        dem, args.scales, sops, kinds=kinds,
                        smth_factors=args.smth_factors, **common
                    )
                elif both:
                    # one banded pass ships each halo window once for all
                    # (descriptor, scale) outputs of the group
                    written += streaming.compute_tpi_std(
                        dem, args.scales, smth_factors=args.smth_factors,
                        **common
                    )
                else:
                    fn = (streaming.compute_tpi if name == "tpi"
                          else streaming.compute_std)
                    written += fn(
                        dem, args.scales, smth_factors=args.smth_factors,
                        **common
                    )
            elif name == "gradient":
                if sops:
                    written += streaming.compute_gradient_sharded(
                        dem, args.scales, sops, sig_ratios=sig_ratios,
                        **common
                    )
                else:
                    written += streaming.compute_gradient(
                        dem, args.scales, sig_ratios=sig_ratios, **common
                    )
            elif name in ("valley", "ridge"):
                if sops:
                    written += streaming.compute_valley_ridge_sharded(
                        dem, args.scales, sops, mode=name,
                        flat_list=args.flat_list,
                        smth_factors=args.smth_factors, **common
                    )
                else:
                    written += streaming.compute_valley_ridge(
                        dem, args.scales, mode=name,
                        flat_list=args.flat_list,
                        smth_factors=args.smth_factors, **common
                    )
            elif name == "sx":
                if sops:
                    written += streaming.compute_sx_sharded(
                        dem, args.sx_azimuths, args.sx_radius, sops,
                        height=args.sx_height, **common
                    )
                else:
                    written += streaming.compute_sx(
                        dem, args.sx_azimuths, args.sx_radius,
                        height=args.sx_height, **common
                    )
    logger.info(f"wrote {len(written)} files to {args.outdir}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s:%(name)s: %(message)s",
    )

    import jax

    from topo_descriptors_tpu.config import ensure_compilation_cache

    ensure_compilation_cache()
    dev = jax.devices()[0]
    logger.info(
        f"platform {dev.platform}: {len(jax.devices())} x {dev.device_kind}"
    )

    from topo_descriptors_tpu import pipeline
    from topo_descriptors_tpu.grid import fill_na
    from topo_descriptors_tpu.io import basodino_like_dem, get_dem_netcdf

    if args.stream:
        return _main_streamed(args)

    if args.synthetic:
        ny, nx = (int(v) for v in args.synthetic.lower().split("x"))
        dem_ds = basodino_like_dem(ny=ny, nx=nx, projected=True)
    else:
        dem_ds = get_dem_netcdf(args.dem)
    ind_nans, dem_ds = fill_na(dem_ds)
    logger.info(
        f"DEM {dem_ds.data.shape}, crs {dem_ds.grid.crs}, "
        f"{len(ind_nans[0])} NaNs filled"
    )

    # whole-number scales print as ints in output names (reference style)
    args.scales = [int(s) if float(s).is_integer() else s for s in args.scales]

    crop = None
    if args.crop_x or args.crop_y:
        crop = {}
        if args.crop_x:
            crop["x"] = slice(*args.crop_x)
        if args.crop_y:
            crop["y"] = slice(*args.crop_y)

    sharded = None
    if args.sharded and args.tiled:
        raise SystemExit("--sharded and --tiled are mutually exclusive")
    if args.sharded:
        from topo_descriptors_tpu.parallel.mesh import make_mesh
        from topo_descriptors_tpu.parallel.sharded import ShardedOps

        mesh = make_mesh(shape=tuple(args.mesh) if args.mesh else None)
        logger.info(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")
        sharded = ShardedOps(mesh)
    elif args.tiled:
        from topo_descriptors_tpu.parallel.tiles import TiledRunner

        sharded = TiledRunner(tile_rows=args.tiled)

    args.outdir.mkdir(parents=True, exist_ok=True)
    common = dict(
        ind_nans=ind_nans, crop=crop, outdir=args.outdir,
        sharded=sharded, skip_existing=args.skip_existing,
    )
    sig_ratios = args.sig_ratios * len(args.scales) if len(args.sig_ratios) == 1 \
        else args.sig_ratios

    # TPI and STD share their moment fields: when both are requested they run
    # as ONE fused multi-scale program (ops/multiscale.py) instead of two
    # independent batteries
    descriptors = list(args.descriptors)
    fuse_tpi_std = "tpi" in descriptors and "std" in descriptors
    if fuse_tpi_std:
        descriptors[descriptors.index("tpi")] = "tpi+std"
        descriptors.remove("std")

    written = []
    for name in descriptors:
        if name == "dem":
            written += pipeline.compute_dem(dem_ds, args.scales, **common)
        elif name == "tpi+std":
            written += pipeline.compute_tpi_std(
                dem_ds, args.scales, smth_factors=args.smth_factors, **common
            )
        elif name == "tpi":
            written += pipeline.compute_tpi(
                dem_ds, args.scales, smth_factors=args.smth_factors, **common
            )
        elif name == "std":
            written += pipeline.compute_std(
                dem_ds, args.scales, smth_factors=args.smth_factors, **common
            )
        elif name == "gradient":
            written += pipeline.compute_gradient(
                dem_ds, args.scales, sig_ratios=sig_ratios, **common
            )
        elif name in ("valley", "ridge"):
            written += pipeline.compute_valley_ridge(
                dem_ds,
                args.scales,
                mode=name,
                flat_list=args.flat_list,
                smth_factors=args.smth_factors,
                **common,
            )
        elif name == "sx":
            if len(args.sx_azimuths) > 1:
                # whole fan in one device program on every backend (the
                # sharded mesh exchanges the ray halo once for all azimuths;
                # the tiled runner ships each band's halo window once)
                written += pipeline.compute_sx_sweep(
                    dem_ds,
                    args.sx_azimuths,
                    args.sx_radius,
                    height=args.sx_height,
                    crop=crop,
                    outdir=args.outdir,
                    sharded=sharded,
                    skip_existing=args.skip_existing,
                )
            else:
                for azimuth in args.sx_azimuths:
                    written += pipeline.compute_sx(
                        dem_ds,
                        azimuth,
                        args.sx_radius,
                        height=args.sx_height,
                        crop=crop,
                        outdir=args.outdir,
                        sharded=sharded,
                        skip_existing=args.skip_existing,
                    )
    logger.info(f"wrote {len(written)} files to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
