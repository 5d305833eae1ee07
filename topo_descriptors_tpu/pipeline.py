"""Batch drivers: the reference's ``compute_*`` API surface.

Each driver mirrors its reference wrapper (topo.py:16,88,216,317,534,715):
validate the DEM, convert scales to odd pixel counts, loop over scales,
reassign the original NaNs, optionally crop, and write one NetCDF per
descriptor with the reference's exact naming scheme. The numerical core runs
as a jit-compiled op (ops/) or, when a :class:`ShardedOps` is supplied,
as a multi-device shard_map program.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import jax.numpy as jnp
import numpy as np

from topo_descriptors_tpu import geo, ops
from topo_descriptors_tpu.config import CFG, ensure_compilation_cache
from topo_descriptors_tpu.grid import Raster, check_dem
from topo_descriptors_tpu.io.netcdf import to_netcdf
from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets
from topo_descriptors_tpu.utils.timing import timer

logger = logging.getLogger(__name__)


def _as_list(value, length=None):
    """A scalar or a one-element list broadcasts to ``length`` entries."""
    value = list(value) if hasattr(value, "__iter__") else [value]
    if length is not None and len(value) == 1:
        value = value * length
    return value


def _apply_nans(array: np.ndarray, ind_nans) -> np.ndarray:
    # np.asarray of a jax.Array is a read-only view; copy before writing
    array = np.array(array)
    if ind_nans is not None and len(ind_nans) and len(ind_nans[0]):
        array[ind_nans] = np.nan
    return array


def _existing(name: str, outdir) -> Optional[Path]:
    """Idempotent-restart support: per-(descriptor, scale) outputs are
    independent files (reference topo.py:140), so a rerun can skip the ones
    already on disk (SURVEY.md §5 checkpoint/resume)."""
    path = Path(outdir) / f"topo_{str.upper(name)}.nc"
    return path if path.exists() else None


def _compute_backend(dem_val, backend, ragged_fill=None):
    """Return (array for the backend, to_host, valid_shape) triple.

    ``backend`` may be None (single-chip jit), a
    :class:`~topo_descriptors_tpu.parallel.sharded.ShardedOps` (multi-device
    mesh), or a :class:`~topo_descriptors_tpu.parallel.tiles.TiledRunner`
    (out-of-core banding) — the three share method signatures.

    ``valid_shape`` is the original grid shape; it differs from the device
    array's shape only on the sharded path with a grid that doesn't divide
    the mesh evenly, in which case the array is padded bottom/right with
    ``ragged_fill`` (``pad_to_mesh``) and ``to_host`` crops back. A driver
    whose op can't run exactly on a padded grid passes ``ragged_fill=None``
    and gets an actionable error instead. Every driver comes through here
    before it compiles, so this is where the compile cache is placed.
    """
    ensure_compilation_cache()
    dem_val = np.asarray(dem_val, dtype=CFG.compute_dtype)
    shape = dem_val.shape
    if backend is None:
        return jnp.asarray(dem_val), np.asarray, shape
    if hasattr(backend, "put"):  # ShardedOps: place blocks on the mesh
        h, w = shape
        if h % backend.gy or w % backend.gx:
            if ragged_fill is None:
                raise ValueError(
                    f"grid {shape} does not divide the "
                    f"({backend.gy}, {backend.gx}) mesh and this descriptor "
                    "has no exact padded formulation; choose a mesh shape "
                    "that divides the grid or use the tiled runner"
                )
            from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

            padded, _ = pad_to_mesh(dem_val, backend.mesh, fill=ragged_fill)

            def crop(a):
                return np.asarray(a)[: shape[0], : shape[1]]

            return backend.put(padded), crop, shape
        return backend.put(dem_val), np.asarray, shape
    return dem_val, np.asarray, shape  # TiledRunner consumes host arrays


# --- naming (reference topo.py:83-85, 184-188, 310-314, 456-463, 647-655,
#     956-960) ---------------------------------------------------------------


def _dem_name(scale):
    return f"DEM_{scale}M"


def _smth_suffix(smth_factor):
    return f"_SMTHFACT{smth_factor:.3g}" if smth_factor else ""


def _tpi_name(scale, smth_factor):
    return f"TPI_{scale}M{_smth_suffix(smth_factor)}"


def _std_name(scale, smth_factor):
    return f"STD_{scale}M{_smth_suffix(smth_factor)}"


def _valley_ridge_names(scale, mode, smth_factor):
    add = _smth_suffix(smth_factor)
    return [f"{mode}_NORM_{scale}M{add}", f"{mode}_DIR_{scale}M{add}"]


def _gradient_names(scale, sig_ratio):
    return [
        f"WE_DERIVATIVE_{scale}M_SIGRATIO{sig_ratio:.3g}",
        f"SN_DERIVATIVE_{scale}M_SIGRATIO{sig_ratio:.3g}",
        f"SLOPE_{scale}M_SIGRATIO{sig_ratio:.3g}",
        f"ASPECT_{scale}M_SIGRATIO{sig_ratio:.3g}",
    ]


def _sx_name(radius, azimuth):
    return f"SX_RADIUS{int(radius)}_AZIMUTH{int(azimuth)}"


# --- drivers -----------------------------------------------------------------


def compute_dem(
    dem_ds: Raster,
    scales,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """Smoothed DEM at each scale (reference compute_dem, topo.py:16-59)."""
    check_dem(dem_ds)
    logger.info(f"***Starting dem computation for scales {scales} meters***")
    scales = _as_list(scales)
    scales_pxl, _ = geo.scale_to_pixel(scales, dem_ds)
    sigmas = scales_pxl / CFG.scale_std
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, 0.0)
    padded = getattr(dem_dev, "shape", valid_shape) != valid_shape

    written = []
    for idx, sigma in enumerate(sigmas):
        name = _dem_name(scales[idx])
        if skip_existing and (path := _existing(name, outdir)):
            logger.info(f"skipping existing {path}")
            written.append(path)
            continue
        logger.info(f"Computing scale {scales[idx]} meters")
        with timer(f"dem scale {scales[idx]}m"):
            if sharded is None:
                array = to_host(ops.dem(dem_dev, float(sigma)))
            else:
                array = to_host(
                    sharded.gaussian(
                        dem_dev, float(sigma),
                        valid_shape=valid_shape if padded else None,
                    )
                )
        array = _apply_nans(array, ind_nans)
        written.append(to_netcdf(array, dem_ds, name, crop, outdir, "m"))
    return written


def _compute_disk_family(
    dem_ds: Raster,
    scales,
    smth_factors,
    kinds: Sequence[str],
    ind_nans,
    crop,
    outdir,
    sharded,
    skip_existing,
):
    """Shared driver for the disk-kernel descriptors (TPI, rolling STD).

    On the single-chip path, scales that share one pre-smooth sigma are
    batched through :func:`ops.disk_descriptors` — the fused multi-scale
    program that builds the moment fields once and runs one prefix-sum disk
    conv per scale (the reference's 12-scale batch use-case,
    scripts/compute_topo_descriptors.py:44-62, recomputes everything per
    (descriptor, scale)). When both kinds are requested together, TPI rides
    STD's intermediates for free. Output files keep the reference's exact
    per-(descriptor, scale) contract. Sharded/tiled backends keep the
    per-scale loop (their halo exchange is sized per kernel).
    """
    check_dem(dem_ds)
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem_ds)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    namers = {"tpi": _tpi_name, "std": _std_name}

    written: Dict[tuple, Path] = {}
    pending: Dict[int, List[str]] = {}
    for idx in range(len(scales)):
        for kind in kinds:
            name = namers[kind](scales[idx], smth_factors[idx])
            if skip_existing and (path := _existing(name, outdir)):
                logger.info(f"skipping existing {path}")
                written[(kind, idx)] = path
            else:
                pending.setdefault(idx, []).append(kind)

    # ragged sharded grids: zero bottom/right padding plus the valid-aware
    # formulations (true-edge reflect pre-smooth, masked centring, true-grid
    # tap counts) keep padded results bit-comparable to the unpadded ops
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, 0.0)
    padded = getattr(dem_dev, "shape", valid_shape) != valid_shape
    vs = valid_shape if padded else None

    def write(kind, idx, array):
        array = _apply_nans(array, ind_nans)
        name = namers[kind](scales[idx], smth_factors[idx])
        written[(kind, idx)] = to_netcdf(array, dem_ds, name, crop, outdir, "m")

    def to_host_stack(stack):
        return np.asarray(stack)[:, : valid_shape[0], : valid_shape[1]]

    # group by (sigma, kind set): members of a group share one fused program
    groups: Dict[tuple, List[int]] = {}
    for idx, kk in pending.items():
        groups.setdefault((sigmas[idx], tuple(kk)), []).append(idx)

    is_sharded = sharded is not None and hasattr(sharded, "put")
    is_tiled = sharded is not None and not is_sharded
    for (sigma, kk), idxs in groups.items():
        fused = len(idxs) > 1 or len(kk) > 1
        if fused:
            sizes = tuple(int(scales_pxl[i]) for i in idxs)
            logger.info(
                f"Computing scales {[scales[i] for i in idxs]} meters fused "
                f"({'+'.join(kk)}, sigma {sigma}) ..."
            )
            with timer(f"{'+'.join(kk)} fused x{len(idxs)} scales"):
                kwargs = dict(
                    compute_tpi="tpi" in kk, compute_std="std" in kk
                )
                if is_sharded:
                    batch = sharded.disk_descriptors(
                        dem_dev, sizes, sigma, valid_shape=vs, **kwargs
                    )
                    batch = {k: to_host_stack(v) for k, v in batch.items()}
                elif is_tiled:
                    batch = sharded.disk_descriptors(
                        dem_dev, sizes, sigma, **kwargs
                    )
                else:
                    batch = ops.disk_descriptors(dem_dev, sizes, sigma, **kwargs)
                    batch = {k: to_host(v) for k, v in batch.items()}
            for j, idx in enumerate(idxs):
                for kind in kk:
                    write(kind, idx, batch[kind][j])
            continue
        for idx in idxs:
            logger.info(
                f"Computing scale {scales[idx]} meters with smoothing factor"
                f" {smth_factors[idx]} ..."
            )
            for kind in kk:
                op = ops.tpi if kind == "tpi" else ops.std
                with timer(f"{kind} scale {scales[idx]}m"):
                    if sharded is None:
                        array = to_host(
                            op(dem_dev, int(scales_pxl[idx]), sigmas[idx])
                        )
                    elif is_sharded:
                        bop = sharded.tpi if kind == "tpi" else sharded.std
                        array = to_host(
                            bop(dem_dev, int(scales_pxl[idx]), sigmas[idx],
                                valid_shape=vs)
                        )
                    else:
                        bop = sharded.tpi if kind == "tpi" else sharded.std
                        array = to_host(
                            bop(dem_dev, int(scales_pxl[idx]), sigmas[idx])
                        )
                write(kind, idx, array)

    return [
        written[(kind, idx)] for kind in kinds for idx in range(len(scales))
    ]


def compute_tpi(
    dem_ds: Raster,
    scales,
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """TPI at each scale (reference compute_tpi, topo.py:88-141)."""
    logger.info(f"***Starting TPI computation for scales {scales} meters***")
    return _compute_disk_family(
        dem_ds, scales, smth_factors, ("tpi",), ind_nans, crop, outdir,
        sharded, skip_existing,
    )


def compute_std(
    dem_ds: Raster,
    scales,
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """Rolling STD at each scale (reference compute_std, topo.py:216-269)."""
    logger.info(f"***Starting STD computation for scales {scales} meters***")
    return _compute_disk_family(
        dem_ds, scales, smth_factors, ("std",), ind_nans, crop, outdir,
        sharded, skip_existing,
    )


def compute_tpi_std(
    dem_ds: Raster,
    scales,
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """TPI *and* rolling STD for every scale in one fused device program.

    Batch counterpart of calling :func:`compute_tpi` then :func:`compute_std`
    (same files, same contract): the moment fields are built once and shared
    by every (descriptor, scale) pair — TPI is an elementwise epilogue on
    STD's intermediates (see ops/multiscale.py).
    """
    logger.info(
        f"***Starting fused TPI+STD computation for scales {scales} meters***"
    )
    return _compute_disk_family(
        dem_ds, scales, smth_factors, ("tpi", "std"), ind_nans, crop, outdir,
        sharded, skip_existing,
    )


def compute_valley_ridge(
    dem_ds: Raster,
    scales,
    mode: str,
    flat_list=(0, 0.15, 0.3),
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """Valley/ridge index at each scale (reference compute_valley_ridge,
    topo.py:317-386)."""
    check_dem(dem_ds)
    logger.info(f"***Starting {mode} index computation for scales {scales} meters***")
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem_ds)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, 0.0)
    padded = getattr(dem_dev, "shape", valid_shape) != valid_shape

    written = []
    for idx, scale_pxl in enumerate(scales_pxl):
        names = _valley_ridge_names(scales[idx], mode, smth_factors[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        logger.info(
            f"Computing scale {scales[idx]} meters with smoothing factor"
            f" {smth_factors[idx]} ..."
        )
        from topo_descriptors_tpu.ops.valley_ridge import bank_nbytes

        bank_fits = (
            bank_nbytes(int(scale_pxl), len(flat_list))
            <= CFG.valley_bank_max_bytes
        )
        with timer(f"{mode} scale {scales[idx]}m"):
            if sharded is None:
                arrays = ops.valley_ridge(
                    dem_dev, int(scale_pxl), mode, list(flat_list), sigmas[idx]
                )
            elif not bank_fits and hasattr(sharded, "valley_ridge_streamed"):
                # bank sizes past the budget (the reference's 20-100 km
                # example scales) stay ON the mesh via the streamed sharded
                # formulation: on-device rotation, halo-extended VALID
                # matmul-DFT convs, psum standardization
                arrays = sharded.valley_ridge_streamed(
                    dem_dev, int(scale_pxl), mode, list(flat_list),
                    sigmas[idx], valid_shape=valid_shape if padded else None,
                )
            elif not bank_fits:  # TiledRunner routes internally by budget
                arrays = sharded.valley_ridge(
                    dem_dev, int(scale_pxl), mode, list(flat_list),
                    sigmas[idx],
                )
            elif hasattr(sharded, "put"):  # ShardedOps
                arrays = sharded.valley_ridge(
                    dem_dev, int(scale_pxl), mode, list(flat_list), sigmas[idx],
                    valid_shape=valid_shape if padded else None,
                )
            else:  # TiledRunner takes host arrays, no ragged-pad protocol
                arrays = sharded.valley_ridge(
                    dem_dev, int(scale_pxl), mode, list(flat_list), sigmas[idx]
                )
            arrays = [to_host(a) for a in arrays]
        for array, name in zip(arrays, names):
            array = _apply_nans(array, ind_nans)
            written.append(to_netcdf(array, dem_ds, name, crop, outdir, "1"))
    return written


def compute_gradient(
    dem_ds: Raster,
    scales,
    sig_ratios=1,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """Gradients/slope/aspect at each scale (reference compute_gradient,
    topo.py:534-594)."""
    check_dem(dem_ds)
    logger.info(f"***Starting gradients computation for scales {scales} meters***")
    scales = _as_list(scales)
    sig_ratios = _as_list(sig_ratios, len(scales))
    scales_pxl, res_meters = geo.scale_to_pixel(scales, dem_ds)
    sigmas = scales_pxl / CFG.scale_std
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, 0.0)
    padded = getattr(dem_dev, "shape", valid_shape) != valid_shape
    all_units = ["1", "1", "degree", "degree"]

    written = []
    for idx, sigma in enumerate(sigmas):
        names = _gradient_names(scales[idx], sig_ratios[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        logger.info(
            f"Computing scale {scales[idx]} meters with sigma ratio "
            f"{sig_ratios[idx]} ..."
        )
        with timer(f"gradient scale {scales[idx]}m"):
            if sharded is None:
                arrays = ops.gradient(
                    dem_dev, float(sigma), res_meters, sig_ratios[idx]
                )
            else:
                arrays = sharded.gradient(
                    dem_dev, float(sigma), res_meters, sig_ratios[idx],
                    valid_shape=valid_shape if padded else None,
                )
            arrays = [to_host(a) for a in arrays]
        for array, name, units in zip(arrays, names, all_units):
            array = _apply_nans(array, ind_nans)
            written.append(to_netcdf(array, dem_ds, name, crop, outdir, units))
    return written


def sx(
    dem_ds: Raster,
    azimuth: float,
    radius: float,
    height: float = 10.0,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
    sharded=None,
):
    """Sx horizon scan for one azimuth (reference sx, topo.py:776-858).

    Takes the full Raster — the geometry needs the grid's metric resolution
    (mean of the per-pixel x/y resolutions, reference topo.py:837-839).
    """
    if not isinstance(dem_ds, Raster):
        raise TypeError("Argument 'dem_ds' must be a Raster.")
    ensure_compilation_cache()  # the one-device route skips _compute_backend
    _, res_meters = geo.scale_to_pixel(radius, dem_ds)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())
    offsets, distances, border = sx_offsets(
        azimuth, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min
    )
    with timer(f"sx az {azimuth} r {radius}m"):
        if sharded is None:
            return np.asarray(
                ops.sx(jnp.asarray(dem_ds.data), offsets, distances, border, height)
            )
        dem_dev, to_host, valid_shape = _compute_backend(
            dem_ds.data, sharded, ragged_fill=np.nan
        )
        padded = getattr(dem_dev, "shape", valid_shape) != valid_shape
        kwargs = {"valid_shape": valid_shape} if padded else {}
        return to_host(
            sharded.sx(dem_dev, offsets, distances, border, height, **kwargs)
        )


def compute_sx_sweep(
    dem_ds: Raster,
    azimuths,
    radius: float,
    height: float = 10.0,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """Sx for a fan of azimuths in ONE device program.

    Functionally equals looping compute_sx over azimuths (reference usage:
    an 0-350 deg sweep is 36 separate runs), but the DEM stays device-
    resident and the fan runs as a single jit — the batch path for the
    azimuth-sweep benchmark config. ``sharded`` routes the whole fan through
    a :class:`ShardedOps` mesh (one shard_map program, ray halo exchanged
    once for all azimuths) or a :class:`TiledRunner` (each band's halo
    window shipped once per fan).
    """
    from topo_descriptors_tpu.kernels.sx_geometry import sx_sweep_offsets

    check_dem(dem_ds)
    ensure_compilation_cache()  # the one-device route skips _compute_backend
    azimuths = _as_list(azimuths)
    names = [_sx_name(radius, a) for a in azimuths]
    if skip_existing and all(_existing(n, outdir) for n in names):
        return [_existing(n, outdir) for n in names]
    logger.info(
        f"***Starting Sx sweep for azimuths {azimuths} and radius {radius}***"
    )
    _, res_meters = geo.scale_to_pixel(radius, dem_ds)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())
    offsets, distances, border = sx_sweep_offsets(
        azimuths, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min
    )
    with timer(f"sx sweep {len(azimuths)} azimuths r {radius}m"):
        if sharded is None:
            stack = np.asarray(
                ops.sx_sweep(jnp.asarray(dem_ds.data), offsets, distances,
                             border, height)
            )
        elif hasattr(sharded, "put"):  # ShardedOps
            dem_dev, _, valid_shape = _compute_backend(
                dem_ds.data, sharded, ragged_fill=np.nan
            )
            padded = getattr(dem_dev, "shape", valid_shape) != valid_shape
            stack = np.asarray(
                sharded.sx_sweep(
                    dem_dev, offsets, distances, border, height,
                    valid_shape=valid_shape if padded else None,
                )
            )[:, : valid_shape[0], : valid_shape[1]]
        else:  # TiledRunner
            stack = sharded.sx_sweep(
                np.asarray(dem_ds.data, dtype=CFG.compute_dtype),
                offsets, distances, border, height,
            )
    written = []
    for array, name in zip(stack, names):
        written.append(to_netcdf(array, dem_ds, name, crop, outdir, "degree"))
    return written


def compute_sx(
    dem_ds: Raster,
    azimuth: float,
    radius: float,
    height: float = 10.0,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
):
    """Sx driver (reference compute_sx, topo.py:715-772)."""
    check_dem(dem_ds)
    name = _sx_name(radius, azimuth)
    if skip_existing and (path := _existing(name, outdir)):
        logger.info(f"skipping existing {path}")
        return [path]
    logger.info(
        f"***Starting Sx computation for azimuth {azimuth} and radius {radius}***"
    )
    array = sx(
        dem_ds,
        azimuth,
        radius,
        height=height,
        azimuth_arc=azimuth_arc,
        azimuth_steps=azimuth_steps,
        radius_min=radius_min,
        sharded=sharded,
    )
    return [to_netcdf(array, dem_ds, name, crop, outdir, "degree")]
