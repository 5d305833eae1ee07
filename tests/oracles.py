"""scipy/numpy oracles shared by the op-parity and E2E suites.

Each oracle is a direct transcription of the reference recipe it names
(file:line cites inline), kept in a plain helper module so both
tests/test_ops.py and tests/test_e2e.py can import it regardless of
pytest's import mode (ADVICE r2: a bare ``import test_ops`` relied on
rootdir sys.path insertion).
"""

import numpy as np
from scipy import ndimage, signal

from topo_descriptors_tpu import kernels


def _tpi_oracle(dem, size, sigma=None):
    kernel = kernels.circular_kernel(size)
    kernel[int(size / 2), int(size / 2)] = 0
    if sigma:
        dem = ndimage.gaussian_filter(dem, sigma)
    conv = signal.convolve(dem, kernel, mode="same")
    return dem - conv / np.sum(kernel)


def _std_oracle(dem, size, sigma=None, exact=False):
    kernel = kernels.circular_kernel(size)
    ksum = np.sum(kernel)
    if sigma:
        dem = ndimage.gaussian_filter(dem, sigma)
    if exact:
        # same semantics, float64 accumulation: the ground truth the
        # reference's own float32 pipeline approximates
        dem = dem.astype(np.float64)
        kernel = kernel.astype(np.float64)
    sq = dem.astype("int32") ** 2
    s1 = signal.convolve(dem, kernel, mode="same")
    s2 = signal.convolve(sq, kernel, mode="same")
    var = (s2 - s1**2 / ksum) / (ksum - 1)
    return np.sqrt(np.clip(var, 0, None))


def _gradient_oracle(dem, sigma, res_meters, sig_ratio=1):
    if sigma <= 1:
        k = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype=np.float32) / 8
        dx = ndimage.convolve(dem, k)
        dy = ndimage.convolve(dem, k.T)
    elif sig_ratio == 1:
        dy, dx = np.gradient(ndimage.gaussian_filter(dem, sigma))
    else:
        sp = sigma * sig_ratio
        dx = np.gradient(ndimage.gaussian_filter(dem, (sp, sigma)), axis=1)
        dy = np.gradient(ndimage.gaussian_filter(dem, (sigma, sp)), axis=0)
    y_res = res_meters["y"]
    if y_res.ndim == 1:
        y_res = y_res[:, np.newaxis]
    dx = dx / res_meters["x"]
    dy = dy / y_res
    slope = np.arctan(np.sqrt(dx**2 + dy**2)) * (180 / np.pi)
    aspect = (180 + np.degrees(np.arctan2(dx, dy))) % 360
    return [dx, dy, slope, aspect]


def _valley_ridge_oracle(dem, size, mode, flat_list, sigma=None, stats=None,
                         with_gap=False):
    """``stats`` = (mean, std) standardizes a row band with the statistics
    of the full (smoothed) field; ``with_gap`` also returns the margin of
    the winning angle over the runner-up (near-ties are where a direction
    may legitimately differ)."""
    if sigma:
        dem = ndimage.gaussian_filter(dem, sigma)
    mean, std = stats if stats is not None else (dem.mean(), dem.std())
    dem = (dem - mean) / std
    n_y, n_x = dem.shape
    dem_b = np.broadcast_to(dem, (len(flat_list), n_y, n_x))
    index_norm = np.zeros((n_y, n_x), dtype=np.float32) - np.inf
    second = np.zeros((n_y, n_x), dtype=np.float32) - np.inf
    index_dir = np.zeros((n_y, n_x), dtype=np.float32)
    base = kernels.ridge_kernels(size, flat_list) if mode == "ridge" else (
        kernels.valley_kernels(size, flat_list)
    )
    for angle in np.arange(0, 180, dtype=np.float32):
        krot = kernels.rotate_kernels(base, angle)
        conv = signal.convolve(dem_b, krot, mode="same")
        conv = np.max(conv, axis=0)
        greater = conv > index_norm
        second = np.where(greater, index_norm, np.maximum(second, conv))
        index_norm[greater] = conv[greater]
        index_dir[greater] = angle
    out = [np.clip(index_norm, 0, None), index_dir]
    return out + [index_norm - second] if with_gap else out


def _rows_oracle(fn, dem, r0, r1, margin, *args, **kwargs):
    """Rows [r0, r1) of ``fn(dem, ...)`` computed on a row band extended by
    ``margin`` rows each side: exact for stencils narrower than the margin
    (the band's own edges sit outside the rows kept)."""
    lo, hi = max(0, r0 - margin), min(dem.shape[0], r1 + margin)
    out = fn(dem[lo:hi], *args, **kwargs)
    if isinstance(out, list):
        return [o[r0 - lo:r1 - lo] for o in out]
    return out[r0 - lo:r1 - lo]


def _sx_oracle(dem, offsets, distances, border, height):
    """Reference _sx_rolling semantics (topo.py:928-953) as a plain loop."""
    ny, nx = dem.shape
    out = np.zeros_like(dem)
    with np.errstate(invalid="ignore"):
        for j in range(border, ny - border):
            for i in range(border, nx - border):
                dem_line = dem[j + offsets[:, 0], i + offsets[:, 1]]
                z = dem_line - (dem[j, i] + height)
                elev = np.rad2deg(np.arctan(z / distances))
                out[j, i] = np.nanmax(elev)
    return out
