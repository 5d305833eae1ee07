"""Stencil/convolution engine (single-chip XLA core).

This layer replaces the reference's scipy substrate with jit-compiled XLA:

* ``scipy.signal.convolve(mode='same')`` (reference topo.py:175,301-302,443)
  -> :func:`conv2d_same`, with a direct path for small kernels, a
  prefix-sum path for {0,1} disks and an FFT path for large ones (mirroring
  scipy's method='auto' switch).
* ``scipy.ndimage.gaussian_filter`` (reference topo.py:80,173,298,427,631)
  -> :func:`gaussian_filter`, separable taps with 'reflect' boundary and
  truncate=4.0 parity.
* ``scipy.ndimage.convolve`` (reference topo.py:682-683)
  -> :func:`convolve_reflect`.
* ``np.gradient`` central/one-sided differences (reference topo.py:631-635)
  -> :func:`gradient_axis`.

Everything here is shape-static and jit-safe; boundary handling is explicit
so the sharded wrappers (parallel/) can substitute halo data for padding.
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from topo_descriptors_tpu.config import CFG
from topo_descriptors_tpu.kernels.gaussian import gaussian_kernel1d

Array = jax.Array


def _fft_shape(n: int) -> int:
    """Next 5-smooth length >= n (scipy.fft.next_fast_len equivalent),
    so the XLA FFT factors into small radices."""
    if n <= 6:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()  # pow2 upper bound
    p5 = 1
    while p5 <= best:
        p35 = p5
        while p35 <= best:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


def conv2d_same(
    x: Array,
    kernel: np.ndarray,
    method: str = "auto",
) -> Array:
    """2-D convolution, ``mode='same'`` with zero boundary.

    Parity target: ``scipy.signal.convolve(x, kernel, mode='same')``
    (true convolution — kernel flipped — with the 'same' crop anchored at
    ``(k-1)//2``). Accepts even kernel dims (the rotated valley/ridge kernels
    have them).
    """
    kernel = np.asarray(kernel)
    if method in ("auto", "sat"):
        runs = _binary_kernel_runs(kernel[::-1, ::-1])
        if method == "sat" and runs is None:
            raise ValueError("method='sat' requires a {0,1}-valued kernel")
        if runs is not None and (
            method == "sat" or kernel.size >= CFG.sat_conv_min_taps
        ):
            pads = (_same_pads(kernel.shape[0]), _same_pads(kernel.shape[1]))
            return _conv2d_sat(x[None], kernel.shape, runs, pads)[0]
    if method == "auto":
        method = "fft" if kernel.size >= CFG.fft_conv_min_taps else "direct"
    if method == "fft":
        return _conv2d_same_fft(x, jnp.asarray(kernel, dtype=x.dtype))
    return _conv2d_same_direct(x, kernel)


def _same_pads(k: int) -> Tuple[int, int]:
    """(lo, hi) zero-padding for scipy 'same' anchoring: crop starts at
    s=(k-1)//2 of the full convolution, i.e. pad lo = k-1-s, hi = s."""
    s = (k - 1) // 2
    return k - 1 - s, s


def _binary_kernel_runs(kernel: np.ndarray):
    """Decompose a {0,1}-valued kernel into per-row runs of ones.

    Returns ``[(row, first_col, last_col), ...]`` (inclusive bounds) or None
    if the kernel has non-binary weights. Disk kernels (reference
    topo.py:191-213) decompose into one run per row — two for the
    centre-zeroed TPI row — which is what makes the prefix-sum convolution
    below exact and cheap.
    """
    k = np.asarray(kernel)
    if not np.isin(k, (0.0, 1.0)).all():
        return None
    runs = []
    for r in range(k.shape[0]):
        row = (k[r] != 0).astype(np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate(([0], row, [0]))))
        for s, e in zip(edges[::2], edges[1::2]):
            runs.append((r, int(s), int(e - 1)))
    return runs


def _conv2d_sat(xs: Array, kshape, runs, pads) -> Array:
    """Correlation of (B, H, W) with a {0,1} kernel given as row-runs, via a
    row prefix sum (summed-area rows).

    Every run ``[a, b]`` of ones in kernel row ``r`` contributes
    ``P[y+r, x+b+1] - P[y+r, x+a]`` with ``P`` the cumulative sum along x of
    the zero-padded input (one sentinel zero column on the left). Rows that
    share the same ``(a, b)`` are summed *before* the two column slices, so a
    ``size``-diameter disk costs ~``size`` row adds + 2 x (distinct widths)
    slice adds per pixel — versus ``size^2/4·pi`` multiply-adds for a direct
    conv or two full FFTs. The caller flips the kernel first (true
    convolution) and supplies the 'same'/'valid' paddings.
    """
    kh, kw = kshape
    (ly, hy), (lx, hx) = pads
    b, h, w = xs.shape
    h_out = h + ly + hy - kh + 1
    w_out = w + lx + hx - kw + 1
    # sentinel zero column on the left so P[..., x+a] with a=0 reads 0
    xp = jnp.pad(xs, ((0, 0), (ly, hy), (lx + 1, hx)))
    p = jnp.cumsum(xp, axis=2)
    by_cols: dict = {}
    for r, a, bcol in runs:
        by_cols.setdefault((a, bcol), []).append(r)
    acc = None
    for (a, bcol), rows in by_cols.items():
        rs = None
        for r in rows:
            sl = jax.lax.slice(p, (0, r, 0), (b, r + h_out, p.shape[2]))
            rs = sl if rs is None else rs + sl
        term = jax.lax.slice(
            rs, (0, 0, bcol + 1), (b, h_out, bcol + 1 + w_out)
        ) - jax.lax.slice(rs, (0, 0, a), (b, h_out, a + w_out))
        acc = term if acc is None else acc + term
    if acc is None:
        acc = jnp.zeros((b, h_out, w_out), xs.dtype)
    return acc


def _shift_acc_conv(xs: Array, kernel: np.ndarray, pads_y, pads_x) -> Array:
    """Direct convolution as unrolled shifted fused multiply-adds.

    A spatial conv with C_in=1 is a 1-deep contraction; K shifted FMAs
    fuse into one elementwise pass for small kernels. Zero taps (disk
    corners) are skipped. ``xs`` is (B, H, W); true convolution (kernel flipped).
    """
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    flipped = kernel[::-1, ::-1]
    (ly, hy), (lx, hx) = pads_y, pads_x
    xp = jnp.pad(xs, ((0, 0), (ly, hy), (lx, hx)))
    h_out = xs.shape[1] + ly + hy - kh + 1
    w_out = xs.shape[2] + lx + hx - kw + 1
    acc = None
    for r in range(kh):
        for c in range(kw):
            wgt = float(flipped[r, c])
            if wgt == 0.0:
                continue
            term = jax.lax.slice(
                xp, (0, r, c), (xs.shape[0], r + h_out, c + w_out)
            ) * jnp.asarray(wgt, dtype=xs.dtype)
            acc = term if acc is None else acc + term
    if acc is None:
        acc = jnp.zeros((xs.shape[0], h_out, w_out), xs.dtype)
    return acc


def _conv2d_same_direct(x: Array, kernel: np.ndarray) -> Array:
    kernel = np.asarray(kernel)  # host-side weights, never traced
    kh, kw = kernel.shape
    pads = (_same_pads(kh), _same_pads(kw))
    if kh * kw <= CFG.shift_acc_max_taps:
        return _shift_acc_conv(x[None], kernel, *pads)[0]
    # convolution = correlation with the flipped kernel
    flipped = jnp.asarray(kernel, dtype=x.dtype)[::-1, ::-1]
    out = jax.lax.conv_general_dilated(
        x[None, None, :, :],
        flipped[None, None, :, :],
        window_strides=(1, 1),
        padding=pads,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=x.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0, 0]


def _conv2d_same_fft(x: Array, kernel: Array) -> Array:
    h, w = x.shape
    kh, kw = kernel.shape
    fh = _fft_shape(h + kh - 1)
    fw = _fft_shape(w + kw - 1)
    fx = jnp.fft.rfft2(x, s=(fh, fw))
    fk = jnp.fft.rfft2(kernel, s=(fh, fw))
    full = jnp.fft.irfft2(fx * fk, s=(fh, fw))
    sh = (kh - 1) // 2
    sw = (kw - 1) // 2
    return jax.lax.slice(full, (sh, sw), (sh + h, sw + w)).astype(x.dtype)


def conv2d_same_batch(x: Array, kernels: Array, method: str = "auto") -> Array:
    """Convolve one 2-D field with a bank of kernels -> (n_kernels, H, W).

    The batched form of :func:`conv2d_same` used by valley/ridge: one
    convolution with the bank as output channels, or one batched FFT with
    the field transform computed a single time.
    """
    kernels = jnp.asarray(kernels, dtype=x.dtype)
    n, kh, kw = kernels.shape
    if method == "auto":
        method = "fft" if kh * kw >= CFG.fft_conv_min_taps else "direct"
    if method == "fft":
        h, w = x.shape
        fh = _fft_shape(h + kh - 1)
        fw = _fft_shape(w + kw - 1)
        fx = jnp.fft.rfft2(x, s=(fh, fw))
        fk = jnp.fft.rfft2(kernels, s=(fh, fw))
        full = jnp.fft.irfft2(fx[None] * fk, s=(fh, fw))
        sh = (kh - 1) // 2
        sw = (kw - 1) // 2
        return jax.lax.slice(full, (0, sh, sw), (n, sh + h, sw + w)).astype(x.dtype)
    pads = (_same_pads(kh), _same_pads(kw))
    flipped = kernels[:, ::-1, ::-1]
    out = jax.lax.conv_general_dilated(
        x[None, None, :, :],
        flipped[:, None, :, :],
        window_strides=(1, 1),
        padding=pads,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=x.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0]


def conv2d_valid(xs: Array, kernel: np.ndarray, method: str = "auto") -> Array:
    """VALID-mode true convolution of a (B, H, W) stack with one kernel.

    ``out[i] = sum_j x[i+j] * flip(kernel)[j]`` — the form the sharded path
    uses on halo-extended blocks: with halos of ``(k-1-s, s)`` rows/cols
    (s = (k-1)//2), the VALID output over the extended block equals the
    interior of the global 'same' convolution exactly.
    """
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    if method in ("auto", "sat"):
        runs = _binary_kernel_runs(kernel[::-1, ::-1])
        if method == "sat" and runs is None:
            raise ValueError("method='sat' requires a {0,1}-valued kernel")
        if runs is not None and (
            method == "sat" or kernel.size >= CFG.sat_conv_min_taps
        ):
            return _conv2d_sat(xs, kernel.shape, runs, ((0, 0), (0, 0)))
    if method == "auto":
        method = "fft" if kernel.size >= CFG.fft_conv_min_taps else "direct"
    b, h, w = xs.shape
    if method == "fft":
        fh = _fft_shape(h)
        fw = _fft_shape(w)
        fx = jnp.fft.rfft2(xs, s=(fh, fw))
        fk = jnp.fft.rfft2(jnp.asarray(kernel, dtype=xs.dtype), s=(fh, fw))
        full = jnp.fft.irfft2(fx * fk[None], s=(fh, fw))
        return jax.lax.slice(
            full, (0, kh - 1, kw - 1), (b, h, w)
        ).astype(xs.dtype)
    if kh * kw <= CFG.shift_acc_max_taps:
        return _shift_acc_conv(xs, kernel, (0, 0), (0, 0))
    flipped = jnp.asarray(kernel, dtype=xs.dtype)[::-1, ::-1]
    out = jax.lax.conv_general_dilated(
        xs[:, None, :, :],
        flipped[None, None, :, :],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=xs.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0]


def conv2d_same_multi(xs: Array, kernel: np.ndarray, method: str = "auto") -> Array:
    """Convolve a stack of 2-D fields (B, H, W) with one kernel -> (B, H, W).

    The multi-field form of :func:`conv2d_same`; the kernel transform (FFT
    path) or filter constant (direct path) is shared across the stack. Used
    by the rolling-STD op, which needs three moment fields convolved with the
    same disk.
    """
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    if method in ("auto", "sat"):
        runs = _binary_kernel_runs(kernel[::-1, ::-1])
        if method == "sat" and runs is None:
            raise ValueError("method='sat' requires a {0,1}-valued kernel")
        if runs is not None and (
            method == "sat" or kernel.size >= CFG.sat_conv_min_taps
        ):
            pads = (_same_pads(kh), _same_pads(kw))
            return _conv2d_sat(xs, kernel.shape, runs, pads)
    if method == "auto":
        method = "fft" if kernel.size >= CFG.fft_conv_min_taps else "direct"
    if method == "fft":
        b, h, w = xs.shape
        fh = _fft_shape(h + kh - 1)
        fw = _fft_shape(w + kw - 1)
        fx = jnp.fft.rfft2(xs, s=(fh, fw))
        fk = jnp.fft.rfft2(jnp.asarray(kernel, dtype=xs.dtype), s=(fh, fw))
        full = jnp.fft.irfft2(fx * fk[None], s=(fh, fw))
        sh = (kh - 1) // 2
        sw = (kw - 1) // 2
        return jax.lax.slice(full, (0, sh, sw), (b, sh + h, sw + w)).astype(xs.dtype)
    pads = (_same_pads(kh), _same_pads(kw))
    if kh * kw <= CFG.shift_acc_max_taps:
        return _shift_acc_conv(xs, kernel, *pads)
    flipped = jnp.asarray(kernel, dtype=xs.dtype)[::-1, ::-1]
    out = jax.lax.conv_general_dilated(
        xs[:, None, :, :],
        flipped[None, None, :, :],
        window_strides=(1, 1),
        padding=pads,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=xs.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0]


# --- reflect padding & separable Gaussian -----------------------------------


def reflect_pad_1d(x: Array, axis: int, lo: int, hi: int) -> Array:
    """Symmetric ('reflect' in scipy.ndimage terms: d c b a | a b c d) padding
    along one axis, supporting pad widths larger than the axis length by
    repeated reflection (scipy does the same for tiny inputs / huge sigmas)."""
    n = x.shape[axis]
    while lo > 0 or hi > 0:
        take_lo = min(lo, n)
        take_hi = min(hi, n)
        parts = []
        if take_lo:
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(0, take_lo)
            parts.append(jnp.flip(x[tuple(sl)], axis=axis))
        parts.append(x)
        if take_hi:
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(n - take_hi, n)
            parts.append(jnp.flip(x[tuple(sl)], axis=axis))
        x = jnp.concatenate(parts, axis=axis)
        n = x.shape[axis]
        lo -= take_lo
        hi -= take_hi
    return x


def _correlate1d_valid(x: Array, taps: np.ndarray, axis: int) -> Array:
    """1-D VALID correlation along ``axis`` with host-side (numpy) taps.

    Small tap counts unroll into shifted FMAs; large ones (big Gaussian
    sigmas) go through batched per-axis FFTs — both avoid
    conv_general_dilated's 1-deep C_in=1 contraction.
    """
    taps_np = np.asarray(taps)
    t = int(taps_np.shape[0])
    n = x.shape[axis]
    n_out = n - t + 1
    if t > CFG.fft_correlate1d_min_taps:
        fn = _fft_shape(n)
        fx = jnp.fft.rfft(x, n=fn, axis=axis)
        ft = jnp.fft.rfft(jnp.asarray(taps_np[::-1].copy(), dtype=x.dtype), n=fn)
        shape = [1, 1]
        shape[axis] = ft.shape[0]
        full = jnp.fft.irfft(fx * ft.reshape(shape), n=fn, axis=axis)
        start = [0, 0]
        start[axis] = t - 1
        limit = list(full.shape)
        limit[axis] = t - 1 + n_out
        return jax.lax.slice(full, start, limit).astype(x.dtype)
    acc = None
    for i in range(t):
        sl = [slice(None), slice(None)]
        sl[axis] = slice(i, i + n_out)
        term = x[tuple(sl)] * jnp.asarray(float(taps_np[i]), dtype=x.dtype)
        acc = term if acc is None else acc + term
    return acc


def gaussian_filter(
    x: Array,
    sigma: Union[float, Tuple[float, float]],
    truncate: float = 4.0,
    pad: bool = True,
) -> Array:
    """Separable Gaussian smoothing with scipy.ndimage parity.

    Matches ``scipy.ndimage.gaussian_filter(x, sigma)`` — truncated sampled
    taps (radius int(truncate*sigma+0.5)), 'reflect' boundary, sequential
    per-axis passes (reference call sites: topo.py:80,173,298,427,631,634-635).
    ``sigma`` may be a scalar or per-axis ``(sigma_y, sigma_x)``.
    ``pad=False`` skips boundary padding and returns the VALID interior —
    the sharded path uses this after halo exchange.
    """
    if np.isscalar(sigma):
        sigmas = (float(sigma), float(sigma))
    else:
        sigmas = (float(sigma[0]), float(sigma[1]))
    for axis, s in enumerate(sigmas):
        if s <= 0:
            continue
        taps = gaussian_kernel1d(s, truncate).astype(np.float32)
        r = (taps.shape[0] - 1) // 2
        if pad:
            x = reflect_pad_1d(x, axis, r, r)
        x = _correlate1d_valid(x, taps, axis)
    return x


def convolve_reflect(x: Array, kernel: np.ndarray) -> Array:
    """True 2-D convolution with 'reflect' boundary.

    Parity target: ``scipy.ndimage.convolve(x, kernel)`` with the default
    mode='reflect' and origin 0 (used by the Sobel path, reference
    topo.py:682-683). Odd kernel dims only.
    """
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    rh, rw = kh // 2, kw // 2
    xp = reflect_pad_1d(x, 0, rh, rh)
    xp = reflect_pad_1d(xp, 1, rw, rw)
    return conv2d_valid(xp[None], kernel)[0]


def gradient_axis(x: Array, axis: int, edge_order: str = "one_sided") -> Array:
    """``np.gradient`` along one axis: central differences in the interior,
    one-sided differences at the two edges (reference topo.py:631-635).

    ``edge_order='none'`` keeps central differences everywhere using the
    available neighbours only — the sharded path uses it on halo-extended
    blocks where the true edge lives on another device.
    """
    upper = jnp.roll(x, -1, axis=axis)
    lower = jnp.roll(x, 1, axis=axis)
    grad = (upper - lower) * jnp.asarray(0.5, dtype=x.dtype)
    if edge_order == "none":
        return grad
    n = x.shape[axis]

    def tk(i):
        sl = [slice(None)] * x.ndim
        sl[axis] = i
        return x[tuple(sl)]

    first = tk(1) - tk(0)
    last = tk(n - 1) - tk(n - 2)
    idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, axis)
    grad = jnp.where(idx == 0, jnp.expand_dims(first, axis), grad)
    grad = jnp.where(idx == n - 1, jnp.expand_dims(last, axis), grad)
    return grad


# --- exact boundary count plane ---------------------------------------------


def _edge_count_plane_rank1(
    shape: Tuple[int, int], kernel: np.ndarray, runs
) -> Array:
    """``conv2d_same(ones(shape), kernel)`` for {0,1} kernels, gather-free.

    Each group of kernel rows sharing a run ``[a, b]`` contributes a rank-1
    term: (number of in-bounds source rows at output row y) x (in-bounds
    length of the column segment at output x). Both factors are 1-D clip
    expressions on iotas, so the plane assembles as ~`distinct widths`
    broadcast FMAs that XLA fuses into the consumer — no (H, W) gather.
    """
    h, w = shape
    kh, kw = np.asarray(kernel).shape
    sy, sx_ = (kh - 1) // 2, (kw - 1) // 2
    ly, lx = kh - 1 - sy, kw - 1 - sx_

    y = jnp.arange(h, dtype=jnp.float32)
    x = jnp.arange(w, dtype=jnp.float32)
    by_cols: dict = {}
    for r, a, bcol in runs:
        by_cols.setdefault((a, bcol), []).append(r)
    acc = None
    for (a, bcol), rows in by_cols.items():
        rvec = None
        for r in rows:
            # source rows live at padded rows [ly, ly+h); run row = y + r
            ind = ((y + r >= ly) & (y + r < ly + h)).astype(jnp.float32)
            rvec = ind if rvec is None else rvec + ind
        # run cols x+a..x+bcol (padded, sentinel-shifted: +1); sources at
        # padded cols [lx+1, lx+1+w)
        hi = jnp.minimum(x + bcol + 1, float(lx + w))
        lo = jnp.maximum(x + a + 1, float(lx + 1))
        cvec = jnp.maximum(hi - lo + 1.0, 0.0)
        term = rvec[:, None] * cvec[None, :]
        acc = term if acc is None else acc + term
    if acc is None:
        acc = jnp.zeros((h, w), jnp.float32)
    return acc


def edge_count_plane_device(shape: Tuple[int, int], kernel: np.ndarray) -> Array:
    """Device-side :func:`edge_count_plane`: assembled inside the jit from the
    kernel's tiny integral image instead of baked as an (H, W) constant —
    a 268 MB constant at 8192^2 overflows compile RPC payloads and bloats
    every executable, while the integral table is a few KB.

    {0,1} kernels (disks) skip the integral-image gather entirely and use
    the rank-1 run decomposition."""
    runs = _binary_kernel_runs(np.asarray(kernel)[::-1, ::-1])
    if runs is not None:
        return _edge_count_plane_rank1(shape, kernel, runs)
    h, w = shape
    kernel = np.asarray(kernel, dtype=np.float64)
    kh, kw = kernel.shape
    sh, sw = (kh - 1) // 2, (kw - 1) // 2
    integral = np.zeros((kh + 1, kw + 1), dtype=np.float32)
    integral[1:, 1:] = kernel.cumsum(0).cumsum(1)
    table = jnp.asarray(integral)

    y = jnp.arange(h)
    x = jnp.arange(w)
    m0 = jnp.clip(y + sh - (h - 1), 0, kh)
    m1 = jnp.clip(y + sh + 1, 0, kh)
    n0 = jnp.clip(x + sw - (w - 1), 0, kw)
    n1 = jnp.clip(x + sw + 1, 0, kw)
    rows_hi = jnp.take(table, m1, axis=0)  # (H, kw+1)
    rows_lo = jnp.take(table, m0, axis=0)
    return (
        jnp.take(rows_hi, n1, axis=1)
        - jnp.take(rows_lo, n1, axis=1)
        - jnp.take(rows_hi, n0, axis=1)
        + jnp.take(rows_lo, n0, axis=1)
    )


def edge_count_plane(shape: Tuple[int, int], kernel: np.ndarray) -> np.ndarray:
    """Exact ``conv2d_same(ones(shape), kernel)`` computed host-side in float64.

    Near the zero-padded boundary a 'same' convolution sums fewer kernel taps;
    this plane gives the exact per-pixel sum of in-bounds taps via the
    kernel's integral image (O(N), no convolution). Used by the centered
    (precision-preserving) TPI/STD formulations so float32 device math matches
    scipy's float64-accumulated results near the borders.
    """
    h, w = shape
    kernel = np.asarray(kernel, dtype=np.float64)
    kh, kw = kernel.shape
    sh, sw = (kh - 1) // 2, (kw - 1) // 2
    integral = np.zeros((kh + 1, kw + 1))
    integral[1:, 1:] = kernel.cumsum(0).cumsum(1)

    y = np.arange(h)
    x = np.arange(w)
    # kernel row-index window for output row y: m in [y+sh-(h-1), y+sh] clipped
    m0 = np.clip(y + sh - (h - 1), 0, kh)
    m1 = np.clip(y + sh + 1, 0, kh)
    n0 = np.clip(x + sw - (w - 1), 0, kw)
    n1 = np.clip(x + sw + 1, 0, kw)
    return (
        integral[np.ix_(m1, n1)]
        - integral[np.ix_(m0, n1)]
        - integral[np.ix_(m1, n0)]
        + integral[np.ix_(m0, n0)]
    )
