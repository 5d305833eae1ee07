"""Out-of-core batch drivers: disk -> device -> disk, one band at a time.

The streaming counterparts of the :mod:`~topo_descriptors_tpu.pipeline`
drivers for grids larger than host RAM (SURVEY.md §7 step 7; the reference's
only out-of-core gesture is the dask ``map_overlap`` branch inside tpi,
topo.py:177-178, which still ingests the whole array through xarray). Every
driver here composes three bounded-memory pieces:

* :class:`~topo_descriptors_tpu.io.windowed.DemWindowReader` — windowed
  ingest (GeoTIFF strips/tiles or NetCDF row windows) with the reference's
  float32 / min-elevation-mask / nearest-in-x-fill semantics applied per
  window;
* :class:`~topo_descriptors_tpu.parallel.tiles.TiledRunner` — banded
  halo-overlapped device execution;
* :class:`~topo_descriptors_tpu.io.netcdf.RasterBandWriter` — NetCDF
  output written band by band.

Peak host memory is one halo-extended band (plus coordinate vectors),
independent of grid height. Outputs keep the reference's per-
(descriptor, scale) file contract (helpers.py:34-65) including the NaN
re-assignment at the original holes (topo.py:57,139,267) — recomputed per
band from the reader, which is exact because the holes are row-local.

``crop`` is not supported here: label-cropping is a host-side array
operation at odds with streamed output; crop after the fact or use the
in-RAM pipeline.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Union

import numpy as np

from topo_descriptors_tpu import geo
from topo_descriptors_tpu.config import CFG, ensure_compilation_cache
from topo_descriptors_tpu.grid import check_dem
from topo_descriptors_tpu.io.netcdf import RasterBandWriter
from topo_descriptors_tpu.io.windowed import DemWindowReader
from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets, sx_sweep_offsets
from topo_descriptors_tpu.parallel.tiles import TiledRunner
from topo_descriptors_tpu.pipeline import (
    _as_list,
    _dem_name,
    _existing,
    _gradient_names,
    _sx_name,
    _std_name,
    _tpi_name,
    _valley_ridge_names,
)
from topo_descriptors_tpu.utils.timing import timer

logger = logging.getLogger(__name__)


def open_dem(dem: Union[str, Path, DemWindowReader], fill: bool = True):
    """Coerce a path into a :class:`DemWindowReader` (passthrough if lazy).
    Every driver opens its DEM here before it compiles, so this is where
    the compile cache is placed."""
    ensure_compilation_cache()
    if isinstance(dem, DemWindowReader):
        return dem
    return DemWindowReader(dem, fill=fill)


class _Sink:
    """Band sink: NaN re-assignment at the original holes + streamed write."""

    def __init__(self, writer: RasterBandWriter, dem: DemWindowReader,
                 reassign_nans: bool):
        self.writer = writer
        self.dem = dem
        self.reassign = reassign_nans

    def __call__(self, start: int, band: np.ndarray) -> None:
        if self.reassign:
            mask = self.dem.nan_rows(start, start + band.shape[-2])
            if mask.any():
                band = np.array(band)
                band[..., mask] = np.nan
        self.writer.write_rows(start, band)


def _open_writer(dem, name, outdir, units) -> tuple:
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    name = str.upper(name)
    path = outdir / f"topo_{name}.nc"
    writer = RasterBandWriter(
        path, dem.grid, name, units=units, attrs=dict(dem.attrs),
    )
    return path, writer


def _skip(name, outdir, skip_existing) -> Optional[Path]:
    if skip_existing and (path := _existing(name, outdir)):
        logger.info(f"skipping existing {path}")
        return path
    return None


def compute_dem(dem, scales, outdir=".", tile_rows: int = 4096,
                reassign_nans: bool = True, skip_existing: bool = False):
    """Streamed smoothed-DEM driver (reference compute_dem, topo.py:16-59)."""
    dem = open_dem(dem)
    check_dem(dem)
    logger.info(f"***Streaming dem computation for scales {scales} meters***")
    scales = _as_list(scales)
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std
    runner = TiledRunner(tile_rows)

    written = []
    for idx, sigma in enumerate(sigmas):
        name = _dem_name(scales[idx])
        if path := _skip(name, outdir, skip_existing):
            written.append(path)
            continue
        with timer(f"dem scale {scales[idx]}m streamed"):
            path, writer = _open_writer(dem, name, outdir, "m")
            with writer:
                runner.gaussian(dem, float(sigma),
                                sink=_Sink(writer, dem, reassign_nans))
        logger.info(f"saved: {path}")
        written.append(path)
    return written


def _compute_disk_family(dem, scales, smth_factors, kinds, outdir, tile_rows,
                         reassign_nans, skip_existing):
    """Streamed TPI/STD. Scales sharing a pre-smooth sigma run FUSED: one
    banded pass ships each halo window once and writes every
    (descriptor, scale) output of the group from the shared moment fields
    (TiledRunner.disk_descriptors) — the per-scale loop re-ingests the grid
    once per output."""
    dem = open_dem(dem)
    check_dem(dem)
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    namers = {"tpi": _tpi_name, "std": _std_name}
    runner = TiledRunner(tile_rows)

    written = {}
    pending = []
    for idx in range(len(scales)):
        done = True
        for kind in kinds:
            name = namers[kind](scales[idx], smth_factors[idx])
            if path := _skip(name, outdir, skip_existing):
                written[(kind, idx)] = path
            else:
                done = False
        if not done:
            pending.append(idx)

    groups = {}
    for idx in pending:
        groups.setdefault(sigmas[idx], []).append(idx)

    for sigma, idxs in groups.items():
        sizes = [int(scales_pxl[i]) for i in idxs]
        if len(idxs) == 1 and len(kinds) == 1:
            kind = kinds[0]
            idx = idxs[0]
            name = namers[kind](scales[idx], smth_factors[idx])
            op = runner.tpi if kind == "tpi" else runner.std
            with timer(f"{kind} scale {scales[idx]}m streamed"):
                path, writer = _open_writer(dem, name, outdir, "m")
                with writer:
                    op(dem, sizes[0], sigma,
                       sink=_Sink(writer, dem, reassign_nans))
            logger.info(f"saved: {path}")
            written[(kind, idx)] = path
            continue
        opened = {
            kind: [
                _open_writer(
                    dem, namers[kind](scales[i], smth_factors[i]), outdir, "m"
                )
                for i in idxs
            ]
            for kind in kinds
        }
        with timer(
            f"{'+'.join(kinds)} fused x{len(idxs)} scales streamed"
        ):
            try:
                runner.disk_descriptors(
                    dem, sizes, sigma,
                    compute_tpi="tpi" in kinds,
                    compute_std="std" in kinds,
                    sinks={
                        kind: [
                            _Sink(w, dem, reassign_nans)
                            for _, w in opened[kind]
                        ]
                        for kind in kinds
                    },
                )
            finally:
                for kind in kinds:
                    for _, w in opened[kind]:
                        w.close()
        for kind in kinds:
            for j, i in enumerate(idxs):
                path = opened[kind][j][0]
                logger.info(f"saved: {path}")
                written[(kind, i)] = path
    return [written[(k, i)] for k in kinds for i in range(len(scales))]


def compute_tpi(dem, scales, smth_factors=None, outdir=".",
                tile_rows: int = 4096, reassign_nans: bool = True,
                skip_existing: bool = False):
    """Streamed TPI driver (reference compute_tpi, topo.py:88-141)."""
    logger.info(f"***Streaming TPI computation for scales {scales} meters***")
    return _compute_disk_family(dem, scales, smth_factors, ("tpi",), outdir,
                                tile_rows, reassign_nans, skip_existing)


def compute_std(dem, scales, smth_factors=None, outdir=".",
                tile_rows: int = 4096, reassign_nans: bool = True,
                skip_existing: bool = False):
    """Streamed rolling-STD driver (reference compute_std, topo.py:216-269)."""
    logger.info(f"***Streaming STD computation for scales {scales} meters***")
    return _compute_disk_family(dem, scales, smth_factors, ("std",), outdir,
                                tile_rows, reassign_nans, skip_existing)


def compute_tpi_std(dem, scales, smth_factors=None, outdir=".",
                    tile_rows: int = 4096, reassign_nans: bool = True,
                    skip_existing: bool = False):
    """Streamed FUSED TPI+STD: one banded pass ships each halo window to
    the device once and writes every (descriptor, scale) output of the
    group from the shared centred moment fields — half the ingest and
    transfer traffic of running the two family drivers separately (the
    single-chip analog of :func:`compute_tpi_std_sharded`; the reference
    computes the two families in independent full passes,
    topo.py:88-141, 216-269)."""
    logger.info(
        f"***Streaming fused TPI+STD computation for scales {scales} "
        f"meters***"
    )
    return _compute_disk_family(dem, scales, smth_factors, ("tpi", "std"),
                                outdir, tile_rows, reassign_nans,
                                skip_existing)


def compute_gradient(dem, scales, sig_ratios=1, outdir=".",
                     tile_rows: int = 4096, reassign_nans: bool = True,
                     skip_existing: bool = False):
    """Streamed gradient/slope/aspect driver (reference compute_gradient,
    topo.py:534-594). All four outputs of a band come from one device call
    and fan out to four band writers."""
    dem = open_dem(dem)
    check_dem(dem)
    logger.info(
        f"***Streaming gradients computation for scales {scales} meters***"
    )
    scales = _as_list(scales)
    sig_ratios = _as_list(sig_ratios, len(scales))
    scales_pxl, res_meters = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std
    all_units = ["1", "1", "degree", "degree"]
    runner = TiledRunner(tile_rows)

    written = []
    for idx, sigma in enumerate(sigmas):
        names = _gradient_names(scales[idx], sig_ratios[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        with timer(f"gradient scale {scales[idx]}m streamed"):
            opened = [
                _open_writer(dem, n, outdir, u)
                for n, u in zip(names, all_units)
            ]
            try:
                runner.gradient(
                    dem, float(sigma), res_meters, sig_ratios[idx],
                    sinks=[_Sink(w, dem, reassign_nans) for _, w in opened],
                )
            finally:
                for _, w in opened:
                    w.close()
        for path, _ in opened:
            logger.info(f"saved: {path}")
            written.append(path)
    return written


def compute_valley_ridge(dem, scales, mode: str, flat_list=(0, 0.15, 0.3),
                         smth_factors=None, outdir=".",
                         tile_rows: int = 4096, reassign_nans: bool = True,
                         skip_existing: bool = False):
    """Streamed valley/ridge driver (reference compute_valley_ridge,
    topo.py:317-386). The global standardization stats come from a streamed
    band-wise float64 pass over the (optionally smoothed) field."""
    dem = open_dem(dem)
    check_dem(dem)
    logger.info(
        f"***Streaming {mode} index computation for scales {scales} meters***"
    )
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    runner = TiledRunner(tile_rows)

    written = []
    for idx, scale_pxl in enumerate(scales_pxl):
        names = _valley_ridge_names(scales[idx], mode, smth_factors[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        with timer(f"{mode} scale {scales[idx]}m streamed"):
            opened = [_open_writer(dem, n, outdir, "1") for n in names]
            try:
                runner.valley_ridge(
                    dem, int(scale_pxl), mode, list(flat_list), sigmas[idx],
                    sinks=[_Sink(w, dem, reassign_nans) for _, w in opened],
                )
            finally:
                for _, w in opened:
                    w.close()
        for path, _ in opened:
            logger.info(f"saved: {path}")
            written.append(path)
    return written


# --- windowed ingest -> multi-device mesh -----------------------------------


def _fetch_banded(arr, valid_shape, sink, band_rows: int = 2048):
    """Stream a sharded (H, W) device array to a sink in row bands, cropping
    the ragged pad; no full-grid host materialization."""
    vh, vw = valid_shape
    for r0 in range(0, vh, band_rows):
        r1 = min(r0 + band_rows, vh)
        sink(r0, np.asarray(arr[r0:r1, :vw]))


def compute_tpi_std_sharded(
    dem,
    scales,
    sops,
    kinds=("tpi", "std"),
    smth_factors=None,
    outdir=".",
    reassign_nans: bool = True,
    skip_existing: bool = False,
    band_rows: int = 2048,
):
    """Windowed ingest -> multi-device mesh -> banded NetCDF output.

    Each process
    reads only its devices' blocks from disk
    (:func:`~topo_descriptors_tpu.parallel.runtime.ingest_sharded` — peak
    host memory one block), the whole scale battery runs as fused
    shard_map programs on the mesh, and outputs stream back to NetCDF in
    row bands. This is the full-Alps sharded shape (BASELINE.md); one
    process drives all the cards of a host, and XLA moves the halos over
    NVLink.
    """
    from topo_descriptors_tpu.parallel.runtime import ingest_sharded

    dem = open_dem(dem)
    check_dem(dem)
    logger.info(
        f"***Sharded-streaming {'+'.join(kinds)} for scales {scales} meters***"
    )
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    namers = {"tpi": _tpi_name, "std": _std_name}

    written = {}
    pending = []
    for idx in range(len(scales)):
        names = [namers[k](scales[idx], smth_factors[idx]) for k in kinds]
        paths = [_skip(n, outdir, skip_existing) for n in names]
        if all(paths):
            for k, p in zip(kinds, paths):
                written[(k, idx)] = p
        else:
            pending.append(idx)

    if pending:
        dem_s, valid_shape = ingest_sharded(dem, sops.mesh, fill=0.0)
        padded = dem_s.shape != valid_shape
        vs = valid_shape if padded else None
        groups = {}
        for idx in pending:
            groups.setdefault(sigmas[idx], []).append(idx)
        for sigma, idxs in groups.items():
            sizes = [int(scales_pxl[i]) for i in idxs]
            with timer(
                f"{'+'.join(kinds)} sharded-streamed x{len(idxs)} scales"
            ):
                batch = sops.disk_descriptors(
                    dem_s, sizes, sigma,
                    compute_tpi="tpi" in kinds,
                    compute_std="std" in kinds,
                    valid_shape=vs,
                )
                for kind in kinds:
                    for j, idx in enumerate(idxs):
                        name = namers[kind](scales[idx], smth_factors[idx])
                        path, writer = _open_writer(dem, name, outdir, "m")
                        with writer:
                            _fetch_banded(
                                batch[kind][j], valid_shape,
                                _Sink(writer, dem, reassign_nans), band_rows,
                            )
                        logger.info(f"saved: {path}")
                        written[(kind, idx)] = path
    return [written[(k, i)] for k in kinds for i in range(len(scales))]


def compute_dem_sharded(dem, scales, sops, outdir=".", reassign_nans=True,
                        skip_existing=False, band_rows: int = 2048):
    """Windowed-ingest sharded smoothed-DEM driver (see
    :func:`compute_tpi_std_sharded`)."""
    from topo_descriptors_tpu.parallel.runtime import ingest_sharded

    dem = open_dem(dem)
    check_dem(dem)
    scales = _as_list(scales)
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std
    written = []
    dem_s = None
    for idx, sigma in enumerate(sigmas):
        name = _dem_name(scales[idx])
        if path := _skip(name, outdir, skip_existing):
            written.append(path)
            continue
        if dem_s is None:
            dem_s, valid_shape = ingest_sharded(dem, sops.mesh, fill=0.0)
            vs = valid_shape if dem_s.shape != valid_shape else None
        with timer(f"dem scale {scales[idx]}m sharded-streamed"):
            out = sops.gaussian(dem_s, float(sigma), valid_shape=vs)
            path, writer = _open_writer(dem, name, outdir, "m")
            with writer:
                _fetch_banded(out, valid_shape,
                              _Sink(writer, dem, reassign_nans), band_rows)
        logger.info(f"saved: {path}")
        written.append(path)
    return written


def compute_gradient_sharded(
    dem,
    scales,
    sops,
    sig_ratios=1,
    outdir=".",
    reassign_nans: bool = True,
    skip_existing: bool = False,
    band_rows: int = 2048,
):
    """Windowed-ingest sharded gradient/slope/aspect driver (reference
    compute_gradient, topo.py:534-594; composition per
    :func:`compute_tpi_std_sharded`). All four outputs of a scale come from
    one shard_map program and stream back in row bands."""
    from topo_descriptors_tpu.parallel.runtime import ingest_sharded

    dem = open_dem(dem)
    check_dem(dem)
    logger.info(
        f"***Sharded-streaming gradients for scales {scales} meters***"
    )
    scales = _as_list(scales)
    sig_ratios = _as_list(sig_ratios, len(scales))
    scales_pxl, res_meters = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std
    all_units = ["1", "1", "degree", "degree"]

    written = []
    dem_s = None
    for idx, sigma in enumerate(sigmas):
        names = _gradient_names(scales[idx], sig_ratios[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        if dem_s is None:
            dem_s, valid_shape = ingest_sharded(dem, sops.mesh, fill=0.0)
            vs = valid_shape if dem_s.shape != valid_shape else None
        with timer(f"gradient scale {scales[idx]}m sharded-streamed"):
            arrays = sops.gradient(
                dem_s, float(sigma), res_meters, sig_ratios[idx],
                valid_shape=vs,
            )
            for arr, name, units in zip(arrays, names, all_units):
                path, writer = _open_writer(dem, name, outdir, units)
                with writer:
                    _fetch_banded(arr, valid_shape,
                                  _Sink(writer, dem, reassign_nans),
                                  band_rows)
                logger.info(f"saved: {path}")
                written.append(path)
    return written


def compute_valley_ridge_sharded(
    dem,
    scales,
    sops,
    mode: str,
    flat_list=(0, 0.15, 0.3),
    smth_factors=None,
    outdir=".",
    reassign_nans: bool = True,
    skip_existing: bool = False,
    band_rows: int = 2048,
):
    """Windowed-ingest sharded valley/ridge driver (reference
    compute_valley_ridge, topo.py:317-386). Scales whose rotated bank fits
    ``CFG.valley_bank_max_bytes`` run the precomputed-bank shard_map
    program; larger scales stay ON the mesh via
    :meth:`ShardedOps.valley_ridge_streamed` (on-device rotation,
    halo-extended VALID matmul-DFT convolutions, psum standardization)."""
    from topo_descriptors_tpu.ops.valley_ridge import bank_nbytes
    from topo_descriptors_tpu.parallel.runtime import ingest_sharded

    dem = open_dem(dem)
    check_dem(dem)
    logger.info(
        f"***Sharded-streaming {mode} index for scales {scales} meters***"
    )
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)

    written = []
    dem_s = None
    for idx, scale_pxl in enumerate(scales_pxl):
        names = _valley_ridge_names(scales[idx], mode, smth_factors[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        if dem_s is None:
            dem_s, valid_shape = ingest_sharded(dem, sops.mesh, fill=0.0)
            vs = valid_shape if dem_s.shape != valid_shape else None
        size = int(scale_pxl)
        fits = bank_nbytes(size, len(flat_list)) <= CFG.valley_bank_max_bytes
        with timer(f"{mode} scale {scales[idx]}m sharded-streamed"):
            op = sops.valley_ridge if fits else sops.valley_ridge_streamed
            arrays = op(
                dem_s, size, mode, list(flat_list), sigmas[idx],
                valid_shape=vs,
            )
            for arr, name in zip(arrays, names):
                path, writer = _open_writer(dem, name, outdir, "1")
                with writer:
                    _fetch_banded(arr, valid_shape,
                                  _Sink(writer, dem, reassign_nans),
                                  band_rows)
                logger.info(f"saved: {path}")
                written.append(path)
    return written


def compute_sx_sharded(
    dem,
    azimuths,
    radius: float,
    sops,
    height: float = 10.0,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
    outdir=".",
    reassign_nans: bool = False,
    skip_existing: bool = False,
    band_rows: int = 2048,
):
    """Windowed-ingest sharded Sx driver (reference compute_sx,
    topo.py:715-772). A fan runs as ONE shard_map program — the full-ray
    halo (multi-hop when rays span blocks) is exchanged once for every
    azimuth. Ragged grids are NaN-padded (fmax ignores the pads exactly
    like beyond-edge halo fill). ``reassign_nans`` defaults off like the
    reference's sx wrapper (topo.py:760-772)."""
    from topo_descriptors_tpu.parallel.runtime import ingest_sharded

    dem = open_dem(dem)
    check_dem(dem)
    azimuths = _as_list(azimuths)
    names = [_sx_name(radius, a) for a in azimuths]
    if skip_existing and all(_existing(n, outdir) for n in names):
        return [_existing(n, outdir) for n in names]
    logger.info(
        f"***Sharded-streaming Sx for azimuths {azimuths}, radius {radius}***"
    )
    _, res_meters = geo.scale_to_pixel(radius, dem)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())
    dem_s, valid_shape = ingest_sharded(dem, sops.mesh, fill=np.nan)
    vs = valid_shape if dem_s.shape != valid_shape else None

    written = []
    with timer(f"sx sharded-streamed {len(azimuths)} az r {radius}m"):
        if len(azimuths) == 1:
            offsets, distances, border = sx_offsets(
                azimuths[0], radius, dx, dy, azimuth_arc, azimuth_steps,
                radius_min,
            )
            out = sops.sx(dem_s, offsets, distances, border, height,
                          valid_shape=vs)
            stack = [out]
        else:
            offsets, distances, border = sx_sweep_offsets(
                azimuths, radius, dx, dy, azimuth_arc, azimuth_steps,
                radius_min,
            )
            out = sops.sx_sweep(dem_s, offsets, distances, border, height,
                                valid_shape=vs)
            stack = [out[a] for a in range(len(azimuths))]
        for arr, name in zip(stack, names):
            path, writer = _open_writer(dem, name, outdir, "degree")
            with writer:
                _fetch_banded(arr, valid_shape,
                              _Sink(writer, dem, reassign_nans), band_rows)
            logger.info(f"saved: {path}")
            written.append(path)
    return written


class _StackSink:
    """Fan an (A, rows, W) band out to one writer per azimuth."""

    def __init__(self, sinks):
        self.sinks = sinks

    def __call__(self, start: int, band: np.ndarray) -> None:
        for a, sink in enumerate(self.sinks):
            sink(start, band[a])


def compute_sx(dem, azimuths, radius: float, height: float = 10.0,
               azimuth_arc: float = 10.0, azimuth_steps: int = 15,
               radius_min: float = 0.0, outdir=".", tile_rows: int = 4096,
               reassign_nans: bool = False, skip_existing: bool = False):
    """Streamed Sx driver (reference compute_sx, topo.py:715-772).

    A single azimuth streams the plain banded kernel; a fan streams the
    whole-sweep program, shipping each band's halo window once for all
    azimuths. ``reassign_nans`` defaults off like the reference (its sx
    wrapper never re-assigns, topo.py:760-772).
    """
    dem = open_dem(dem)
    check_dem(dem)
    azimuths = _as_list(azimuths)
    names = [_sx_name(radius, a) for a in azimuths]
    if skip_existing and all(_existing(n, outdir) for n in names):
        return [_existing(n, outdir) for n in names]
    logger.info(
        f"***Streaming Sx for azimuths {azimuths} and radius {radius}***"
    )
    _, res_meters = geo.scale_to_pixel(radius, dem)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())
    runner = TiledRunner(tile_rows)

    with timer(f"sx {len(azimuths)} azimuths r {radius}m streamed"):
        opened = [_open_writer(dem, n, outdir, "degree") for n in names]
        try:
            if len(azimuths) == 1:
                offsets, distances, border = sx_offsets(
                    azimuths[0], radius, dx, dy, azimuth_arc, azimuth_steps,
                    radius_min,
                )
                runner.sx(dem, offsets, distances, border, height,
                          sink=_Sink(opened[0][1], dem, reassign_nans))
            else:
                offsets, distances, border = sx_sweep_offsets(
                    azimuths, radius, dx, dy, azimuth_arc, azimuth_steps,
                    radius_min,
                )
                runner.sx_sweep(
                    dem, offsets, distances, border, height,
                    sink=_StackSink(
                        [_Sink(w, dem, reassign_nans) for _, w in opened]
                    ),
                )
        finally:
            for _, w in opened:
                w.close()
    for path, _ in opened:
        logger.info(f"saved: {path}")
    return [path for path, _ in opened]
