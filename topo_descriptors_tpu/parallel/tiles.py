"""Out-of-core tiled execution: stream grids larger than device memory
through one chip in halo-overlapped row bands.

This is the replacement for the reference's dask ``map_overlap``
path (topo.py:177-178, its only out-of-core story, reachable only from tpi
and only with a dask-backed array). Here every descriptor op runs banded:

* the host array is cut into row bands of ``tile_rows``;
* each band is shipped to the device with a halo of the op's influence
  radius (kernel 'same' anchor, Gaussian tap radius + 1 for np.gradient,
  Sx ray border, rotated-kernel half-extent);
* the op runs on the (band + halo) window with its normal boundary
  handling — the window's synthetic edges only pollute outputs inside the
  halo, which are cropped, while true global edges coincide with window
  edges and keep exact single-pass semantics;
* global statistics (TPI/STD centring, valley/ridge standardization) are
  computed host-side in float64 over the full array first, so every band
  sees identical constants.

Results are bit-comparable to the single-pass ops (same device math, same
boundary data) for any tile size >= 1 halo.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from topo_descriptors_tpu import ops
from topo_descriptors_tpu.config import CFG
from topo_descriptors_tpu.kernels.gaussian import gaussian_radius
from topo_descriptors_tpu.ops.valley_ridge import prepare_valley_bank
from topo_descriptors_tpu.utils.transfer import chunked_device_put, chunked_fetch

logger = logging.getLogger(__name__)


class _Cancelled(Exception):
    """Internal pipeline-teardown signal (never escapes _drive)."""


def _malloc_trim():
    """Return freed band buffers to the OS after a banded run.

    Each band cycles hundreds of MB of short-lived numpy buffers (host
    window, fetched outputs); glibc retains those arenas, so successive
    descriptor families each added ~4 GiB of peak RSS on the Gpix run
    (6.1 -> 10.4 -> 14.3 GiB measured) even though nothing was live
    between them. A trim per banded run keeps process RSS at one
    family's working set. Best-effort: a no-op off glibc."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:
        pass


class TiledRunner:
    """Banded out-of-core execution of descriptor ops on one device.

    ``dem`` may be a host ndarray or any *window reader* (an object with
    ``.shape`` and contiguous row slicing — e.g.
    :class:`~topo_descriptors_tpu.io.windowed.DemWindowReader`), in which
    case only one halo-extended band is ever resident. Every op takes an
    optional ``sink(start_row, band)`` callback; when given, bands are
    handed over as they finish (e.g. to a
    :class:`~topo_descriptors_tpu.io.netcdf.RasterBandWriter`) instead of
    being stitched into a full in-RAM output, bounding host memory at one
    band for arbitrarily large grids.
    """

    def __init__(self, tile_rows: int = 4096, pipeline: bool = True):
        self.tile_rows = int(tile_rows)
        # overlap disk reads + H2D of the next band and disk writes of the
        # previous band with the current band's compute + D2H (see _drive)
        self.pipeline = bool(pipeline)

    # -- banding machinery -------------------------------------------------
    def _bands(self, n_rows: int, halo_lo: int, halo_hi: int):
        """Yield (band_start, band_stop, win_start, win_stop) row ranges."""
        for start in range(0, n_rows, self.tile_rows):
            stop = min(start + self.tile_rows, n_rows)
            win_lo = max(0, start - halo_lo)
            win_hi = min(n_rows, stop + halo_hi)
            yield start, stop, win_lo, win_hi

    def _drive(self, dem, halo: Tuple[int, int], compute_fetch, emit):
        """Banded execution driver — the one pipeline every op loop uses.

        ``compute_fetch(window_dev, meta) -> host_result`` runs on the main
        thread (device dispatch + bounded-slice D2H fetch); ``emit(meta,
        host_result)`` delivers results in band order (NetCDF band write or
        stitch). With ``self.pipeline`` (default), band k+1's host read +
        chunked H2D runs on a prefetch thread and band k-1's emit on a
        writer thread while band k computes and fetches, so disk I/O and
        host<->device transfers overlap the compute. Queues are bounded at
        ONE band each, so peak host memory gains at most two extra bands.
        The band writers' memory-map stores and JAX device_put/execute are
        safe from the prefetch/writer threads.
        """
        metas = list(self._bands(dem.shape[0], *halo))
        if not self.pipeline or len(metas) <= 1:
            for meta in metas:
                window = chunked_device_put(
                    np.asarray(dem[meta[2] : meta[3]])
                )
                emit(meta, compute_fetch(window, meta))
            _malloc_trim()
            return

        stop_ev = threading.Event()
        errors: list = []

        def _put(q, item):
            while True:
                try:
                    q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    if stop_ev.is_set():
                        raise _Cancelled()

        def _get(q):
            while True:
                try:
                    return q.get(timeout=0.2)
                except queue.Empty:
                    if stop_ev.is_set():
                        raise _Cancelled()

        in_q: queue.Queue = queue.Queue(maxsize=1)
        out_q: queue.Queue = queue.Queue(maxsize=1)

        def producer():
            try:
                for meta in metas:
                    window = chunked_device_put(
                        np.asarray(dem[meta[2] : meta[3]])
                    )
                    _put(in_q, (meta, window))
                _put(in_q, None)
            except _Cancelled:
                pass
            except BaseException as exc:  # propagate to the main thread
                errors.append(exc)
                stop_ev.set()

        def writer():
            try:
                while True:
                    item = _get(out_q)
                    if item is None:
                        return
                    emit(*item)
            except _Cancelled:
                pass
            except BaseException as exc:
                errors.append(exc)
                stop_ev.set()

        tp = threading.Thread(
            target=producer, daemon=True, name="tiles-prefetch"
        )
        tw = threading.Thread(target=writer, daemon=True, name="tiles-write")
        tp.start()
        tw.start()
        try:
            while True:
                item = _get(in_q)
                if item is None:
                    break
                meta, window = item
                _put(out_q, (meta, compute_fetch(window, meta)))
            _put(out_q, None)
        except _Cancelled:
            pass
        except BaseException as exc:
            errors.append(exc)
            stop_ev.set()
        tp.join()
        tw.join()
        _malloc_trim()
        if errors:
            raise errors[0]

    def _run(self, dem, halo: Tuple[int, int], fn, sink=None):
        """Apply ``fn(window, rows_slice)`` per band; stitch or sink.

        ``fn`` receives the halo-extended window and the slice selecting the
        band's rows within the window; it returns the band's output rows.
        """
        n_rows = dem.shape[0]
        state = {}

        def compute_fetch(window, meta):
            start, stop, win_lo, win_hi = meta
            return chunked_fetch(fn(window, slice(start - win_lo,
                                                  stop - win_lo)))

        def emit(meta, band_out):
            start, stop = meta[0], meta[1]
            if sink is not None:
                sink(start, band_out)
                return
            if "out" not in state:
                state["out"] = np.empty(
                    (n_rows,) + band_out.shape[1:], dtype=band_out.dtype
                )
            state["out"][start:stop] = band_out

        self._drive(dem, halo, compute_fetch, emit)
        return state.get("out")

    # -- streaming global statistics ----------------------------------------
    def _center(self, dem) -> float:
        """round(nanmean) of the full field (TPI/STD centring constant).

        ndarrays use the one-shot float64 nanmean; window readers stream
        band-wise float64 partial sums (same result up to float64
        summation-order rounding, far below the centring granularity of 1).
        """
        if isinstance(dem, np.ndarray):
            return float(np.round(np.nanmean(dem, dtype=np.float64)))
        total, count = 0.0, 0
        n_rows = dem.shape[0]
        for start in range(0, n_rows, self.tile_rows):
            block = np.asarray(dem[start : min(start + self.tile_rows, n_rows)])
            total += float(np.nansum(block, dtype=np.float64))
            count += int(np.count_nonzero(~np.isnan(block)))
        return float(np.round(total / count))

    def _field_stats(self, dem, sigma) -> Tuple[float, float]:
        """float64 (mean, std) of the optionally-smoothed field.

        The reference standardizes the *smoothed* DEM globally
        (topo.py:427-429). For window readers the smoothing runs banded with
        a halo of the Gaussian tap radius, so interior rows match the
        full-field filter bit-exactly; sums are shifted by the first pixel
        value to keep the one-pass variance well-conditioned.
        """
        from scipy import ndimage  # host-side stats pass only

        if isinstance(dem, np.ndarray):
            field = dem
            if sigma:
                field = ndimage.gaussian_filter(dem.astype(np.float32), sigma)
            mean = float(np.mean(field, dtype=np.float64))
            var = float(np.mean((field.astype(np.float64) - mean) ** 2))
            return mean, float(np.sqrt(var))
        r = gaussian_radius(sigma) if sigma else 0
        s = s2 = 0.0
        n = 0
        shift = None
        for start, stop, win_lo, win_hi in self._bands(dem.shape[0], r, r):
            window = np.asarray(dem[win_lo:win_hi]).astype(np.float32)
            if sigma:
                window = ndimage.gaussian_filter(window, sigma)
            rows = window[start - win_lo : stop - win_lo].astype(np.float64)
            if shift is None:
                shift = float(rows.flat[0])
            rows -= shift
            s += float(rows.sum())
            s2 += float((rows * rows).sum())
            n += rows.size
        mean_c = s / n
        var = max(s2 / n - mean_c * mean_c, 0.0)
        return mean_c + shift, float(np.sqrt(var))

    # -- descriptors -------------------------------------------------------
    def gaussian(self, dem, sigma, truncate: float = 4.0, sink=None):
        """Banded scipy-parity Gaussian (reference dem op, topo.py:62-80)."""
        sig_y = sigma if np.isscalar(sigma) else sigma[0]
        r = gaussian_radius(sig_y, truncate) if sig_y else 0

        def fn(window, rows):
            return ops.gaussian_filter(window, sigma, truncate)[rows]

        return self._run(dem, (r, r), fn, sink)

    def tpi(self, dem, size: int, sigma: Optional[float] = None, sink=None):
        """Banded TPI (reference topo.py:145-181)."""
        r_smooth = gaussian_radius(sigma) if sigma else 0
        halo = size // 2 + r_smooth
        center = self._center(dem)

        def fn(window, rows):
            return ops.tpi(window, size, sigma, center=center)[rows]

        return self._run(dem, (halo, halo), fn, sink)

    def std(self, dem, size: int, sigma: Optional[float] = None, sink=None):
        """Banded rolling STD (reference topo.py:272-307)."""
        r_smooth = gaussian_radius(sigma) if sigma else 0
        halo = size // 2 + r_smooth
        center = self._center(dem)

        def fn(window, rows):
            return ops.std(window, size, sigma, center=center)[rows]

        return self._run(dem, (halo, halo), fn, sink)

    def disk_descriptors(
        self,
        dem,
        sizes: Sequence[int],
        sigma: Optional[float] = None,
        compute_tpi: bool = True,
        compute_std: bool = True,
        sinks: Optional[Dict[str, List]] = None,
    ) -> Optional[Dict[str, np.ndarray]]:
        """Banded fused multi-scale TPI/STD — the out-of-core counterpart of
        :func:`topo_descriptors_tpu.ops.disk_descriptors`.

        Each band's halo window (sized by the *largest* scale) is shipped to
        the device ONCE; all (descriptor, scale) outputs of the band come
        from the shared centred moment fields. The per-scale methods ship
        the window and rebuild the fields once per scale — at the
        reference's 12-scale batch that is 12x the ingest traffic.

        ``sinks``, when given, maps kind -> one ``sink(start, band)`` per
        scale. Without sinks, returns ``{"tpi": (S, H, W), "std": ...}``.
        """
        sizes = [int(s) for s in sizes]
        r_smooth = gaussian_radius(sigma) if sigma else 0
        halo = max(sizes) // 2 + r_smooth
        center = self._center(dem)
        n_rows = dem.shape[0]
        kinds = [k for k, on in (("tpi", compute_tpi), ("std", compute_std))
                 if on]

        state: Dict[str, np.ndarray] = {}

        def compute_fetch(window, meta):
            start, stop, win_lo, win_hi = meta
            rows = slice(start - win_lo, stop - win_lo)
            batch = ops.disk_descriptors(
                window, sizes, sigma, compute_tpi=compute_tpi,
                compute_std=compute_std, center=center,
            )
            return {k: chunked_fetch(batch[k][:, rows]) for k in kinds}

        def emit(meta, res):
            start, stop = meta[0], meta[1]
            for kind in kinds:
                band = res[kind]
                if sinks is not None:
                    for s_idx, sink in enumerate(sinks[kind]):
                        sink(start, band[s_idx])
                    continue
                if kind not in state:
                    state[kind] = np.empty(
                        (len(sizes), n_rows) + band.shape[2:], band.dtype
                    )
                state[kind][:, start:stop] = band

        self._drive(dem, (halo, halo), compute_fetch, emit)
        return state if (sinks is None and state) else None

    def gradient(
        self,
        dem,
        sigma: float,
        res_meters: Dict[str, np.ndarray],
        sig_ratio: float = 1.0,
        sinks=None,
    ) -> Optional[List[np.ndarray]]:
        """Banded gradient/slope/aspect (reference topo.py:597-644).

        With ``sinks`` (4 callbacks: dx, dy, slope, aspect) all four outputs
        of a band are computed in one device call and fanned out, so the
        window is shipped once per band instead of once per output.
        """
        if sigma <= 1:
            halo = 1
        else:
            halo = gaussian_radius(max(sigma, sigma * sig_ratio)) + 1

        x_res = np.asarray(res_meters["x"])
        y_res = np.asarray(res_meters["y"])

        def res_for(win_lo, win_hi):
            return {
                "x": x_res if x_res.ndim == 1 else x_res[win_lo:win_hi],
                "y": y_res[win_lo:win_hi],
            }

        if sinks is not None:
            def compute_fetch(window, meta):
                start, stop, win_lo, win_hi = meta
                rows = slice(start - win_lo, stop - win_lo)
                outs = ops.gradient(
                    window, sigma, res_for(win_lo, win_hi), sig_ratio
                )
                return [chunked_fetch(band[rows]) for band in outs]

            def emit(meta, res):
                for sink, band in zip(sinks, res):
                    sink(meta[0], band)

            self._drive(dem, (halo, halo), compute_fetch, emit)
            return None

        def fn_for(idx):
            def fn(window, rows, win_lo, win_hi):
                res_w = res_for(win_lo, win_hi)
                return ops.gradient(window, sigma, res_w, sig_ratio)[idx][rows]

            return fn

        outs = []
        for idx in range(4):
            outs.append(self._run_windowed(dem, (halo, halo), fn_for(idx)))
        return outs

    def _run_windowed(self, dem, halo, fn):
        """Like _run but fn also receives the window's global row range."""
        n_rows = dem.shape[0]
        state = {}

        def compute_fetch(window, meta):
            start, stop, win_lo, win_hi = meta
            rows = slice(start - win_lo, stop - win_lo)
            return chunked_fetch(fn(window, rows, win_lo, win_hi))

        def emit(meta, band_out):
            start, stop = meta[0], meta[1]
            if "out" not in state:
                state["out"] = np.empty(
                    (n_rows,) + band_out.shape[1:], band_out.dtype
                )
            state["out"][start:stop] = band_out

        self._drive(dem, halo, compute_fetch, emit)
        return state.get("out")

    def valley_ridge(
        self,
        dem,
        size: int,
        mode: str,
        flat_list: Sequence[float] = (0, 0.15, 0.3),
        sigma: Optional[float] = None,
        sinks=None,
    ) -> Optional[List[np.ndarray]]:
        """Banded valley/ridge (reference topo.py:389-453). Global
        standardization stats come from a host-side float64 pass (streamed
        band-wise for window readers); note the reference standardizes the
        *smoothed* field (topo.py:427-429), so with sigma the stats pass
        smooths first. With ``sinks`` (norm, dir) both outputs of a band
        come from one device call.

        At scales where the full rotated bank exceeds
        ``CFG.valley_bank_max_bytes`` the bank is not materialized at all;
        each band runs the streamed on-device-rotation path
        (:func:`~topo_descriptors_tpu.ops.valley_ridge.valley_ridge_streamed`)
        with shared global stats. The rotation happens on device (round 3+),
        so the per-band repeat costs only the ~46 quadrant gathers per
        band's window shape — still prefer few, tall bands for huge scales
        (each distinct window height compiles its own scan program)."""
        from topo_descriptors_tpu.kernels.valley import rotated_extent
        from topo_descriptors_tpu.ops.valley_ridge import bank_nbytes

        ky, _ = rotated_extent(size)
        if bank_nbytes(size, len(flat_list)) <= CFG.valley_bank_max_bytes:
            bank = prepare_valley_bank(size, mode, tuple(flat_list))
        else:
            bank = None  # ops.valley_ridge streams angle chunks per band
        r_smooth = gaussian_radius(sigma) if sigma else 0
        halo = ky // 2 + 1 + r_smooth
        stats = self._field_stats(dem, sigma)

        def both(window):
            return ops.valley_ridge(
                window, size, mode, list(flat_list), sigma, bank=bank,
                stats=stats,
            )

        if sinks is not None:
            def compute_fetch(window, meta):
                start, stop, win_lo, win_hi = meta
                rows = slice(start - win_lo, stop - win_lo)
                norm, direction = both(window)
                return (chunked_fetch(norm[rows]),
                        chunked_fetch(direction[rows]))

            def emit(meta, res):
                sinks[0](meta[0], res[0])
                sinks[1](meta[0], res[1])

            self._drive(dem, (halo, halo), compute_fetch, emit)
            return None

        def fn_norm(window, rows):
            return both(window)[0][rows]

        def fn_dir(window, rows):
            return both(window)[1][rows]

        return [
            self._run(dem, (halo, halo), fn_norm),
            self._run(dem, (halo, halo), fn_dir),
        ]

    @staticmethod
    def _zero_global_border(band, start, n_rows, b):
        """Apply the global-frame zero border (reference loop bounds
        topo.py:940-941) to one band in place: rows by their global index,
        the left/right columns always."""
        h = band.shape[-2]
        lo = min(max(b - start, 0), h)
        band[..., :lo, :] = 0.0
        hi = min(max(start + h - (n_rows - b), 0), h)
        if hi:
            band[..., h - hi :, :] = 0.0
        band[..., :, :b] = 0.0
        band[..., :, band.shape[-1] - b :] = 0.0
        return band

    def sx(
        self,
        dem,
        offsets: np.ndarray,
        distances: np.ndarray,
        border: int,
        height: float = 10.0,
        sink=None,
    ) -> Optional[np.ndarray]:
        """Banded Sx (reference topo.py:928-953). The zero border belongs to
        the *global* frame, so the per-window border mask is disabled and
        re-applied per band at global coordinates."""
        b = int(border)
        n_rows = dem.shape[0]

        def fn(window, rows):
            return ops.sx(
                window, offsets, distances, border, height, zero_border=False
            )[rows]

        def zeroing_sink(start, band):
            # np.asarray of a jax.Array is read-only; copy before zeroing
            sink(start, self._zero_global_border(np.array(band), start,
                                                 n_rows, b))

        if sink is not None:
            self._run(dem, (b, b), fn, zeroing_sink)
            return None
        out = self._run(dem, (b, b), fn)
        return self._zero_global_border(out, 0, n_rows, b)

    def sx_sweep(
        self,
        dem,
        offsets: np.ndarray,
        distances: np.ndarray,
        border: int,
        height: float = 10.0,
        sink=None,
    ) -> Optional[np.ndarray]:
        """Banded Sx azimuth sweep -> (A, H, W): each band's halo window is
        shipped to the device once and every azimuth of the fan reduces over
        it (the per-azimuth analog re-ships the window A times). The zero
        border belongs to the *global* frame, applied per band at global
        coordinates. ``sink(start, band)`` receives (A, rows, W) bands."""
        b = int(border)
        n_rows, w = dem.shape
        state = {}

        def compute_fetch(window, meta):
            start, stop, win_lo, win_hi = meta
            rows = slice(start - win_lo, stop - win_lo)
            band = chunked_fetch(
                ops.sx_sweep(window, offsets, distances, border, height,
                             zero_border=False)[:, rows]
            )
            return self._zero_global_border(band, start, n_rows, b)

        def emit(meta, band):
            start, stop = meta[0], meta[1]
            if sink is not None:
                sink(start, band)
                return
            if "out" not in state:
                state["out"] = np.empty(
                    (band.shape[0], n_rows, w), band.dtype
                )
            state["out"][:, start:stop] = band

        self._drive(dem, (b, b), compute_fetch, emit)
        return state.get("out")
