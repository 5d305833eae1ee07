"""Dependency-free order-2 spline rotation, on device.

The reference rotates the valley/ridge kernel stack host-side with
``scipy.ndimage.rotate(order=2, reshape=True, mode='constant', cval=-9999)``
inside its 180-iteration angle loop (topo.py:441-443, 521-531). At its own
example scales (20-100 km at 30 m resolution) each rotated stack is hundreds
of MB, so a device pipeline that rotates host-side either bakes a 17-48 GB bank
into the program or ships ~48 GB of kernels over the wire per descriptor.
This module moves the rotation itself onto the device: the *base* kernel is
spline-prefiltered once, and each angle is a cheap gather-interpolation that
lives inside the same ``lax.scan`` as the convolution.

scipy parity (calibrated empirically, see tests/test_spline_rotate.py):

* **prefilter** — order-2 spline filter, single pole ``z = sqrt(8) - 3``,
  gain ``(1-z)(1-1/z)``, MIRROR boundary init (what scipy's
  ``spline_filter(mode='constant')`` resolves to). Because ``|z| ~ 0.17``,
  the causal/anticausal IIR recursions truncate to ``K``-tap FIRs with error
  ``|z|^K < 2e-11`` at K=14 — far below float32 eps — so the device runs
  pure shifted FMAs over the mirror-extended line, no sequential scan.
* **interpolation** — quadratic B-spline: footprint start
  ``floor(x + 0.5) - 1``, fraction ``t = x - start - 1``, weights
  ``(0.5 (0.5-t)^2, 0.75 - t^2, 0.5 (0.5+t)^2)``; footprint indices
  MIRROR-extended; the output is ``cval`` exactly where the *point*
  coordinate leaves ``[0, n-1]`` on either axis (rule reproduces
  ``scipy.ndimage.map_coordinates(mode='constant')`` to 2e-16 in float64).
* **reshape/anchor** — output shape ``int((|cos|+|sin|) * size + 0.5)`` per
  axis and center-to-center offset exactly as scipy's ``rotate``; the result
  is written straight into the common (ky_max, kx_max) canvas at the
  'same'-anchor offset used by
  :func:`~topo_descriptors_tpu.ops.valley_ridge.prepare_valley_bank`.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from topo_descriptors_tpu.ops.dft_conv import dot_precision

_POLE = float(np.sqrt(8.0) - 3.0)
_GAIN = float((1.0 - _POLE) * (1.0 - 1.0 / _POLE))
_K_TAPS = 14  # |pole|^14 ~ 2e-11, below f32 eps


def exact_deg_trig(angle: float) -> Tuple[float, float]:
    """(cos, sin) of an angle in degrees, exact at multiples of 90.

    Mirrors scipy.special.cosdg/sindg at the points that decide rotated
    output shapes and anchors (the ``int(extent + 0.5)`` reshape rule is
    sensitive to exactness at 0/90/180/270)."""
    a = float(angle) % 360.0
    exact = {0.0: (1.0, 0.0), 90.0: (0.0, 1.0),
             180.0: (-1.0, 0.0), 270.0: (0.0, -1.0)}
    if a in exact:
        return exact[a]
    r = np.deg2rad(a)
    return float(np.cos(r)), float(np.sin(r))


def mirror_pad_1d(x: jax.Array, axis: int, lo: int, hi: int) -> jax.Array:
    """Mirror ('reflect' about the edge *sample*: d c b | a b c d | c b a)
    padding along one axis — the spline filter's boundary extension, distinct
    from :func:`~topo_descriptors_tpu.ops.conv.reflect_pad_1d`'s symmetric
    mode. Pad widths must be < axis length (always true here: K=14 taps vs
    kernel sizes >= 5)."""
    n = x.shape[axis]
    if lo >= n or hi >= n:
        raise ValueError(f"mirror pad ({lo}, {hi}) >= axis length {n}")
    parts = []
    if lo:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(1, lo + 1)
        parts.append(jnp.flip(x[tuple(sl)], axis=axis))
    parts.append(x)
    if hi:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(n - 1 - hi, n - 1)
        parts.append(jnp.flip(x[tuple(sl)], axis=axis))
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else x


def _fir_valid(x: jax.Array, taps: np.ndarray, axis: int) -> jax.Array:
    """VALID 1-D correlation with host-side taps, unrolled into shifted
    FMAs (the K+1 = 15 taps here sit far below the conv engine's unroll
    threshold); works for any rank."""
    n = x.shape[axis]
    t = len(taps)
    n_out = n - t + 1
    acc = None
    for i in range(t):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + n_out)
        term = x[tuple(sl)] * jnp.asarray(float(taps[i]), x.dtype)
        acc = term if acc is None else acc + term
    return acc


def _prefilter1d_o2(x: jax.Array, axis: int) -> jax.Array:
    """Order-2 spline prefilter along one axis (mirror boundary), as two
    K-tap FIR passes over the mirror-extended line."""
    # clamp the FIR truncation to the mirror period for tiny inputs; the
    # truncation error |z|^k stays below 1e-6 for any kernel >= 9 px (the
    # device path only ever runs at huge sizes, where k = 14 is exact to f32)
    k = min(_K_TAPS, x.shape[axis] - 1)
    xp = mirror_pad_1d(x * jnp.asarray(_GAIN, x.dtype), axis, k, k)
    # causal c[i] = sum_k z^k a[i-k]: valid-correlate with taps z^(K-t)
    causal_taps = np.array([_POLE ** (k - t) for t in range(k + 1)], np.float32)
    causal = _fir_valid(xp, causal_taps, axis)
    # causal now covers padded positions [0, n + k); anticausal needs the
    # k-sample lookahead: out[i] = sum_k -z^(k+1) c[i+k]
    anti_taps = np.array([-(_POLE ** (t + 1)) for t in range(k + 1)], np.float32)
    return _fir_valid(causal, anti_taps, axis)


def prefilter2d_o2(x: jax.Array) -> jax.Array:
    """Order-2 spline prefilter over the last two axes (scipy
    ``spline_filter(order=2, mode='constant')`` parity in float32)."""
    x = _prefilter1d_o2(x, x.ndim - 2)
    x = _prefilter1d_o2(x, x.ndim - 1)
    return x


def rotation_params(size: int, angle: float, ky_max: int, kx_max: int) -> np.ndarray:
    """Per-angle scalars for :func:`rotate_std_canvas` -> float32[8].

    Entries: cos, sin, offset_y, offset_x (scipy rotate's center-to-center
    offset), lo_y, lo_x (the 'same'-anchor placement inside the canvas),
    ky, kx (the true rotated extent)."""
    c, s = exact_deg_trig(angle)
    iy = ix = float(size)
    corners_y = np.array([0.0, 0.0, iy, iy])
    corners_x = np.array([0.0, ix, 0.0, ix])
    by = c * corners_y + s * corners_x
    bx = -s * corners_y + c * corners_x
    ky = int(np.ptp(by) + 0.5)
    kx = int(np.ptp(bx) + 0.5)
    out_c = np.array([(ky - 1) / 2.0, (kx - 1) / 2.0])
    off_y = (size - 1) / 2.0 - (c * out_c[0] + s * out_c[1])
    off_x = (size - 1) / 2.0 - (-s * out_c[0] + c * out_c[1])
    lo_y = (ky_max - 1) // 2 - (ky - 1) // 2
    lo_x = (kx_max - 1) // 2 - (kx - 1) // 2
    return np.array([c, s, off_y, off_x, lo_y, lo_x, ky, kx], np.float32)


def _mirror_idx(idx: jax.Array, n: int) -> jax.Array:
    """Single mirror reflection of footprint indices into [0, n-1]
    (footprints poke at most one sample past either edge)."""
    idx = jnp.where(idx < 0, -idx, idx)
    return jnp.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def rotate_std_canvas(
    filtered: jax.Array,
    params: jax.Array,
    canvas_shape: Tuple[int, int],
) -> jax.Array:
    """Rotate a prefiltered (F, n, n) stack by one angle into the common
    anchored canvas, masked-re-standardized (reference topo.py:521-531).

    ``params`` is one row of :func:`rotation_params` (may be traced — one
    compiled program serves every angle of the bank). Pixels outside the
    rotated support are exactly 0 after standardization, and the canvas
    region beyond the angle's true (ky, kx) extent is 0 too, matching the
    host bank's anchored zero padding bit-for-bit in structure (values agree
    with the scipy construction to float32 rounding)."""
    n_flats, n, _ = filtered.shape
    ky_max, kx_max = canvas_shape
    c, s, off_y, off_x, lo_y, lo_x, ky, kx = (params[i] for i in range(8))

    oi = jax.lax.broadcasted_iota(jnp.float32, (ky_max, kx_max), 0) - lo_y
    oj = jax.lax.broadcasted_iota(jnp.float32, (ky_max, kx_max), 1) - lo_x
    ycoord = c * oi + s * oj + off_y
    xcoord = -s * oi + c * oj + off_x

    in_canvas = (oi >= 0) & (oi < ky) & (oj >= 0) & (oj < kx)
    nm1 = jnp.float32(n - 1)
    inside = (
        in_canvas
        & (ycoord >= 0) & (ycoord <= nm1)
        & (xcoord >= 0) & (xcoord <= nm1)
    )

    ystart = jnp.floor(ycoord + 0.5).astype(jnp.int32) - 1
    xstart = jnp.floor(xcoord + 0.5).astype(jnp.int32) - 1
    ty = ycoord - (ystart.astype(jnp.float32) + 1.0)
    tx = xcoord - (xstart.astype(jnp.float32) + 1.0)
    wy = (0.5 * (0.5 - ty) ** 2, 0.75 - ty * ty, 0.5 * (0.5 + ty) ** 2)
    wx = (0.5 * (0.5 - tx) ** 2, 0.75 - tx * tx, 0.5 * (0.5 + tx) ** 2)

    # clamp start for masked-out pixels so flat indices stay in range
    ystart = jnp.clip(ystart, -1, n - 2)
    xstart = jnp.clip(xstart, -1, n - 2)

    flat = filtered.reshape(n_flats, n * n)
    val = jnp.zeros((n_flats, ky_max, kx_max), filtered.dtype)
    for a in range(3):
        yi = _mirror_idx(ystart + a, n)
        for b in range(3):
            xi = _mirror_idx(xstart + b, n)
            idx = (yi * n + xi).reshape(-1)
            g = jnp.take(flat, idx, axis=1).reshape(n_flats, ky_max, kx_max)
            val = val + (wy[a] * wx[b])[None] * g

    # masked re-standardization over the valid support, then zero-fill
    # (plain-arithmetic equivalent of the reference's numpy.ma recipe)
    m = inside[None]
    cnt = jnp.sum(inside.astype(filtered.dtype))
    mean = jnp.sum(jnp.where(m, val, 0), axis=(1, 2), keepdims=True) / cnt
    anom = jnp.where(m, val - mean, 0)
    var = jnp.sum(anom * anom, axis=(1, 2), keepdims=True) / cnt
    return anom * jax.lax.rsqrt(var)


# --- gather-table rotation + quadrant symmetry -------------------------------


def build_rotation_table(filtered: jax.Array) -> jax.Array:
    """Pack the prefiltered (F, n, n) stack into a lane-contiguous gather
    table of shape ``((n+2)^2, F*9)``.

    :func:`rotate_std_canvas` costs 9 XLA gathers of 3-element slices per
    canvas. Gather cost is dominated by *index count*, not bytes, so one
    gather pulling a contiguous 27-float slice per index does the same
    rotation with a ninth of the indices. Rows
    of the table hold the full 3x3 interpolation footprint of every flat at
    one (ystart, xstart) base position; the base grid is mirror-padded by 1
    so the footprint never needs per-tap index reflection (the clamp in
    :func:`rotate_std_canvas` bounds ystart/xstart to [-1, n-2], so one
    mirror sample each side covers exactly the reachable overhang).
    """
    n_flats, n, _ = filtered.shape
    fp = mirror_pad_1d(mirror_pad_1d(filtered, 1, 1, 1), 2, 1, 1)
    m = n + 2
    flat = fp.reshape(n_flats, m * m)
    taps = [
        jnp.roll(flat, -(a * m + b), axis=1)
        for a in range(3)
        for b in range(3)
    ]  # value at base+offset, aligned to the base index
    table = jnp.stack(taps, axis=0)  # (9, F, m^2)
    return table.transpose(2, 1, 0).reshape(m * m, n_flats * 9)


def rotate_std_canvas_table(
    table: jax.Array,
    n: int,
    params: jax.Array,
    canvas_shape: Tuple[int, int],
) -> jax.Array:
    """:func:`rotate_std_canvas` on the packed gather table — numerically
    the same construction (identical footprint indices, weights and masked
    re-standardization; float32 summation order differs only in the tap
    accumulation), with a ninth of the gather indices."""
    m = n + 2
    n_flats = table.shape[1] // 9
    ky_max, kx_max = canvas_shape
    c, s, off_y, off_x, lo_y, lo_x, ky, kx = (params[i] for i in range(8))

    oi = jax.lax.broadcasted_iota(jnp.float32, (ky_max, kx_max), 0) - lo_y
    oj = jax.lax.broadcasted_iota(jnp.float32, (ky_max, kx_max), 1) - lo_x
    ycoord = c * oi + s * oj + off_y
    xcoord = -s * oi + c * oj + off_x

    in_canvas = (oi >= 0) & (oi < ky) & (oj >= 0) & (oj < kx)
    nm1 = jnp.float32(n - 1)
    inside = (
        in_canvas
        & (ycoord >= 0) & (ycoord <= nm1)
        & (xcoord >= 0) & (xcoord <= nm1)
    )

    ystart = jnp.floor(ycoord + 0.5).astype(jnp.int32) - 1
    xstart = jnp.floor(xcoord + 0.5).astype(jnp.int32) - 1
    ty = ycoord - (ystart.astype(jnp.float32) + 1.0)
    tx = xcoord - (xstart.astype(jnp.float32) + 1.0)
    wy = jnp.stack([0.5 * (0.5 - ty) ** 2, 0.75 - ty * ty,
                    0.5 * (0.5 + ty) ** 2])
    wx = jnp.stack([0.5 * (0.5 - tx) ** 2, 0.75 - tx * tx,
                    0.5 * (0.5 + tx) ** 2])

    ystart = jnp.clip(ystart, -1, n - 2)
    xstart = jnp.clip(xstart, -1, n - 2)
    # base index into the mirror-padded (m, m) grid: +1 per axis
    idx = ((ystart + 1) * m + (xstart + 1)).reshape(-1)
    g = jnp.take(table, idx, axis=0)  # (P, F*9)
    g = g.reshape(ky_max, kx_max, n_flats, 3, 3)
    w = wy[:, None] * wx[None, :]  # (3, 3, KY, KX)
    val = jnp.einsum("abyx,yxfab->fyx", w, g, precision=dot_precision())

    m_in = inside[None]
    cnt = jnp.sum(inside.astype(table.dtype))
    mean = jnp.sum(jnp.where(m_in, val, 0), axis=(1, 2), keepdims=True) / cnt
    anom = jnp.where(m_in, val - mean, 0)
    var = jnp.sum(anom * anom, axis=(1, 2), keepdims=True) / cnt
    return anom * jax.lax.rsqrt(var)


def _flip_roll(c: jax.Array, axis: int, delta) -> jax.Array:
    return jnp.roll(jnp.flip(c, axis=axis), delta, axis=axis)


def canvas_variants(canvas: jax.Array, params: jax.Array):
    """The four quadrant variants of one rotated-standardized canvas.

    The valley/ridge base kernels are invariant under both axis flips
    (``|row - mid|`` ramp, constant along columns — kernels/valley.py:24-48),
    which makes three more of scipy's rotations exact lattice transforms of
    a single interpolated canvas (verified to float32 rounding against
    ``ndimage.rotate`` for all quadrants):

    ``R(90+t) = rot90(R(t))``, ``R(180-t) = flip(R(t))``,
    ``R(90-t) = flip(rot90(R(t)))``.

    Flips are about the *canvas* centre; when the angle's true extent and
    the canvas differ in parity the kernel sits one pixel off-centre and
    the flip must be followed by a 1-pixel roll (the 'same'-anchor rule
    ``lo = (kmax-1)//2 - (k-1)//2`` is not flip-symmetric for mixed
    parity). Returns ``(R(t), R(90+t), R(180-t), R(90-t))`` for a
    ``(..., K, K)`` canvas (square canvases only — rotated extents of
    square kernels are square).
    """
    kmax = canvas.shape[-1]
    ky = params[6].astype(jnp.int32)
    delta = (ky - 1) % 2 - (kmax - 1) % 2
    v90p = _flip_roll(jnp.swapaxes(canvas, -1, -2), -2, delta)
    v180m = _flip_roll(canvas, -2, delta)
    v90m = _flip_roll(v90p, -2, delta)
    return canvas, v90p, v180m, v90m


def quadrant_schedule(n_angles: int = 180):
    """Decompose integer angles 0..n_angles-1 (degrees) into quadrant
    rotations plus variant transforms.

    Returns ``(q_angles, slot_angle, slot_valid)``: ``q_angles`` the sorted
    unique base angles in [0, 45]; ``slot_angle[i, v]`` the angle covered
    by variant ``v`` of base ``q_angles[i]`` (see :func:`canvas_variants`
    order) and ``slot_valid[i, v]`` whether that slot is a real,
    non-duplicate member of the angle set. 180 angles need 46 rotations.

    The decomposition is only defined on the reference's angle domain
    0..179 deg (topo.py:441); angles >= 181 would map to negative base
    angles outside [0, 45] and silently produce wrong canvases,
    so they are rejected.
    """
    if not 1 <= n_angles <= 180:
        raise ValueError(
            f"n_angles must be in [1, 180] (reference domain 0..179 deg, "
            f"topo.py:441); got {n_angles}"
        )
    variant_of = {}
    for a in range(n_angles):
        if a <= 45:
            q, v = a, 0
        elif a <= 90:
            q, v = 90 - a, 3
        elif a <= 135:
            q, v = a - 90, 1
        else:
            q, v = 180 - a, 2
        slots = variant_of.setdefault(q, {})
        if v not in slots:  # a=45/90/135 are reachable twice; keep first
            slots[v] = a
    q_angles = sorted(variant_of)
    slot_angle = np.zeros((len(q_angles), 4), np.float32)
    slot_valid = np.zeros((len(q_angles), 4), bool)
    for i, q in enumerate(q_angles):
        for v, a in variant_of[q].items():
            slot_angle[i, v] = a
            slot_valid[i, v] = True
    return np.asarray(q_angles, np.float32), slot_angle, slot_valid
