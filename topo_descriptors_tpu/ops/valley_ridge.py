"""Valley / ridge index over 180 rotated V/U-kernel orientations."""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from topo_descriptors_tpu.config import CFG
from topo_descriptors_tpu.kernels.valley import (
    ridge_kernels,
    rotated_extent,
    rotated_kernel_bank,
    valley_kernels,
)
from topo_descriptors_tpu.ops.conv import _fft_shape, gaussian_filter
from topo_descriptors_tpu.ops.dft_conv import (
    DftConvPlan,
    conv_bank_mats,
    field_spectrum,
    get_plan,
    prefer_dft_matmul,
)


def bank_nbytes(size: int, n_flats: int, n_angles: int = 180) -> int:
    """float32 size of the full padded rotation bank, computed without
    building it. At the reference's own 60-100 km example scales
    (scripts/compute_topo_descriptors.py:63-72) this reaches 17-48 GB, which
    is why :func:`valley_ridge` switches to the streamed path above
    ``CFG.valley_bank_max_bytes``."""
    ky, kx = rotated_extent(size)
    return n_angles * n_flats * ky * kx * 4


def prepare_valley_bank(
    size: int,
    mode: str,
    flat_list: Sequence[float],
    angles: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Precompute the rotated kernel bank as one static (A, F, KY, KX) array.

    The per-angle rotations have varying spatial extent (reshape=True grows
    the support, reference topo.py:525); each is zero-padded to the common
    maximum with the padding split chosen so the scipy 'same' crop anchor
    ``(k-1)//2`` is preserved exactly — zero taps contribute nothing, so the
    padded bank is numerically identical to the ragged one.
    """
    if angles is None:
        angles = np.arange(0, 180, dtype=np.float32)
    bank = rotated_kernel_bank(size, mode, flat_list, angles)
    ky_max = max(k.shape[1] for k in bank)
    kx_max = max(k.shape[2] for k in bank)
    padded = np.zeros((len(bank), bank[0].shape[0], ky_max, kx_max), np.float32)
    for i, k in enumerate(bank):
        _, ky, kx = k.shape
        lo_y = (ky_max - 1) // 2 - (ky - 1) // 2
        lo_x = (kx_max - 1) // 2 - (kx - 1) // 2
        padded[i, :, lo_y : lo_y + ky, lo_x : lo_x + kx] = k
    return padded


def _flat_axis_combine(convs: jax.Array, axis: int = 0) -> jax.Array:
    """Flat-axis windowed sums of the reference's 3-D convolution.

    The reference broadcasts the DEM over the flat axis and runs a full 3-D
    ``signal.convolve(mode='same')`` (topo.py:431,443). Because the field is
    constant along that axis, the 3-D conv reduces to the F per-flat 2-D
    convolutions summed over a sliding window of the flat axis:
    ``out[f] = sum_g conv2d(dem, K[g])`` for ``g`` in
    ``[f+c-F+1, f+c] ∩ [0, F-1]`` with ``c=(F-1)//2``.

    Convolution is linear, so the same windowed sums applied to the
    *kernels* before convolving give identical outputs — the fast paths
    fold the combine into the kernel stack and convolve once.
    """
    f = convs.shape[axis]
    c = (f - 1) // 2
    cums = jnp.cumsum(convs, axis=axis)

    def take(i):
        return jax.lax.index_in_dim(cums, i, axis=axis, keepdims=False)

    outs = []
    for i in range(f):
        n = i + c
        lo = max(0, n - f + 1)
        hi = min(f - 1, n)
        upper = take(hi)
        outs.append(upper if lo == 0 else upper - take(lo - 1))
    return jnp.stack(outs, axis=axis)


def _fold_flats_np(bank: np.ndarray) -> np.ndarray:
    """Host-side :func:`_flat_axis_combine` over axis 1 of an
    (A, F, KY, KX) bank (fold-into-kernels for the precomputed-bank path)."""
    f = bank.shape[1]
    c = (f - 1) // 2
    cums = np.cumsum(bank, axis=1, dtype=np.float64)
    outs = []
    for i in range(f):
        n = i + c
        lo, hi = max(0, n - f + 1), min(f - 1, n)
        v = cums[:, hi]
        if lo > 0:
            v = v - cums[:, lo - 1]
        outs.append(v)
    return np.stack(outs, axis=1).astype(np.float32)


def _standardized(dem, sigma, stats):
    if sigma:
        dem = gaussian_filter(dem, sigma)
    if stats is None:
        return (dem - jnp.mean(dem)) / jnp.std(dem)
    return (dem - stats[0]) / stats[1]  # out-of-core: global, precomputed


# --- precomputed-bank conv paths --------------------------------------------


@functools.partial(jax.jit, static_argnames=("chunk", "n_flats"))
def _bank_scan_mm(bank_chunks, fdr, fdi, cxf, sxf, cyf, syf, cyi, syi,
                  cxi, sxi, *, chunk, n_flats):
    """Scan over pre-folded bank chunks with the matmul-DFT conv engine
    (ops/dft_conv.py). ``bank_chunks`` is (n_chunks, chunk*F, KY, KX) and a
    runtime argument — never a jit constant."""
    oh, ow = cyi.shape[0], cxi.shape[1]

    def step(carry, xs):
        norm, direction = carry
        kernels, chunk_idx = xs
        convs = conv_bank_mats(
            kernels, fdr, fdi, cxf, sxf, cyf, syf, cyi, syi, cxi, sxi
        ).reshape(chunk, n_flats, oh, ow)
        combined = jnp.max(convs, axis=1)  # kernels pre-folded over flats
        chunk_best = jnp.max(combined, axis=0)
        chunk_arg = jnp.argmax(combined, axis=0).astype(norm.dtype)
        greater = chunk_best > norm
        norm = jnp.where(greater, chunk_best, norm)
        direction = jnp.where(
            greater, chunk_idx * chunk + chunk_arg, direction
        )
        return (norm, direction), None

    n_chunks = bank_chunks.shape[0]
    init = (
        jnp.full((oh, ow), -jnp.inf, dtype=fdr.dtype),
        jnp.zeros((oh, ow), dtype=fdr.dtype),
    )
    (norm, direction), _ = jax.lax.scan(
        step, init, (bank_chunks, jnp.arange(n_chunks, dtype=fdr.dtype))
    )
    return norm, direction


_BANK_DEV_CACHE: dict = {}


def _valley_ridge_bank_mm(dem, bank, angle_chunk, cache_key=None,
                          bank_shape=None, builder=None):
    """Precomputed-bank valley/ridge via partial-DFT matmuls — the path
    taken whenever the scipy-exact host bank fits the memory budget (the
    scipy rotations and the bank upload amortize via the device cache
    below).

    ``cache_key`` (set when the caller built the bank from its canonical
    (size, mode, flat_list) signature) keeps the folded, chunked bank
    device-resident across calls — the scipy rotations plus the up-to-192 MB
    host->device upload happen once per signature, not once per call."""
    from topo_descriptors_tpu.utils.transfer import chunked_device_put

    h, w = dem.shape
    a_angles, n_flats, ky, kx = bank_shape if bank is None else bank.shape
    plan = get_plan(h, w, ky, kx, "same")
    # bound the (chunk*F, fh, nb) spectral transients by the chunk budget
    per_angle = plan.fh * plan.nb * 8 * n_flats
    chunk = int(max(1, min(angle_chunk, CFG.valley_chunk_bytes // per_angle)))
    while a_angles % chunk:
        chunk -= 1
    key = cache_key + (chunk,) if cache_key is not None else None
    bank_dev = _BANK_DEV_CACHE.get(key) if key is not None else None
    if bank_dev is None:
        if bank is None:
            bank = builder()
        folded = _fold_flats_np(np.asarray(bank))
        bank_dev = chunked_device_put(
            np.ascontiguousarray(
                folded.reshape(a_angles // chunk, chunk * n_flats, ky, kx)
            )
        )
        if key is not None and not DftConvPlan._tracing():
            while len(_BANK_DEV_CACHE) >= 2:  # bound resident banks
                _BANK_DEV_CACHE.pop(next(iter(_BANK_DEV_CACHE)))
            _BANK_DEV_CACHE[key] = bank_dev
    fdr, fdi = field_spectrum(dem, plan)
    norm, direction = _bank_scan_mm(
        bank_dev, fdr, fdi, *plan.mats, chunk=chunk, n_flats=n_flats
    )
    return [jnp.clip(norm, 0.0, None), direction]


# --- streamed path: on-device rotation + quadrant symmetry ------------------


_STREAM_CACHE: dict = {}
_CANVAS_DEV_CACHE: dict = {}


def _rotate_all_fn(n, kmax, n_flats):
    """jitted map over quadrant angles -> (Nq, F, kmax, kmax) stack of
    rotated, masked-standardized, flat-folded canvases (device-resident)."""
    from topo_descriptors_tpu.ops.spline_rotate import rotate_std_canvas_table

    key = ("rotate_all", n, kmax, n_flats)
    fn = _STREAM_CACHE.get(key)
    if fn is not None:
        return fn

    def rot(table, qparams):
        def one(params):
            canvas = rotate_std_canvas_table(table, n, params, (kmax, kmax))
            return _flat_axis_combine(canvas, axis=0)

        return jax.lax.map(one, qparams)

    fn = jax.jit(rot)
    _STREAM_CACHE[key] = fn
    return fn


def _streamed_scan_cached_fn(n, kmax, h, w, n_flats, conv: str,
                             q_batch: int = 1):
    """:func:`_streamed_scan_fn` variant consuming a pre-rotated canvas
    stack: the scan's xs carry the folded canvases, so each step only
    builds the four quadrant variants (cheap lattice flips) and convolves.

    Why this exists: the ~46 rotation gathers are the streamed path's
    non-conv cost, and they recompute an input-independent product. Production call sites
    repeat the same (size, mode, flats) signature — the banded out-of-core
    driver (parallel/tiles.py) calls the streamed op once per band, and
    multi-tile services per tile — so the stack is rotated once and cached
    on device (``_CANVAS_DEV_CACHE``), bounded by
    ``CFG.valley_canvas_cache_bytes`` (at 100 km the stack would be ~12 GB:
    those scales keep the inline rotation)."""
    from topo_descriptors_tpu.ops.spline_rotate import canvas_variants

    key = ("cached", n, kmax, h, w, n_flats, conv, q_batch)
    fn = _STREAM_CACHE.get(key)
    if fn is not None:
        return fn

    if conv == "fft":
        fh = _fft_shape(h + kmax - 1)
        fw = _fft_shape(w + kmax - 1)
        sh = sw = (kmax - 1) // 2

    def scan_fn(canvases, dem_or_fdr, fdi, mats, qparams, slot_angle,
                slot_valid):
        if conv == "fft":
            f_dem = jnp.fft.rfft2(dem_or_fdr, s=(fh, fw))

        def conv_fn(kernels):
            if conv == "mm":
                return conv_bank_mats(kernels, dem_or_fdr, fdi, *mats)
            fk = jnp.fft.rfft2(kernels, s=(fh, fw))
            full = jnp.fft.irfft2(f_dem[None] * fk, s=(fh, fw))
            return jax.lax.slice(
                full, (0, sh, sw), (kernels.shape[0], sh + h, sw + w)
            ).astype(dem_or_fdr.dtype)

        def body(carry, xs):
            norm, direction = carry
            folded_q, params_q, angles_q, valid_q = xs
            kerns = [
                jnp.concatenate(
                    canvas_variants(folded_q[q], params_q[q]), axis=0
                )
                for q in range(q_batch)
            ]
            kern = jnp.concatenate(kerns, axis=0)
            convs = conv_fn(kern).reshape(4 * q_batch, n_flats, h, w)
            comb = jnp.max(convs, axis=1)
            valid = valid_q.reshape(4 * q_batch)
            angles = angles_q.reshape(4 * q_batch)
            comb = jnp.where(valid[:, None, None] > 0, comb, -jnp.inf)
            best = jnp.max(comb, axis=0)
            amin = jnp.min(
                jnp.where(comb == best, angles[:, None, None], jnp.inf),
                axis=0,
            )
            greater = best > norm
            equal = (best == norm) & (norm > -jnp.inf)
            direction = jnp.where(
                greater,
                amin,
                jnp.where(equal, jnp.minimum(direction, amin), direction),
            )
            norm = jnp.where(greater, best, norm)
            return (norm, direction), None

        init = (
            jnp.full((h, w), -jnp.inf, dtype=jnp.float32),
            jnp.zeros((h, w), dtype=jnp.float32),
        )
        n_steps = qparams.shape[0] // q_batch
        xs = (
            canvases.reshape(n_steps, q_batch, n_flats, kmax, kmax),
            qparams.reshape(n_steps, q_batch, -1),
            slot_angle.reshape(n_steps, q_batch, -1),
            slot_valid.reshape(n_steps, q_batch, -1),
        )
        (norm, direction), _ = jax.lax.scan(body, init, xs)
        return norm, direction

    fn = jax.jit(scan_fn)
    _STREAM_CACHE[key] = fn
    return fn


def _streamed_scan_fn(n, kmax, h, w, n_flats, conv: str, q_batch: int = 1):
    """jit-compiled quadrant scan for :func:`valley_ridge_streamed`, cached
    per static signature. The gather table, field spectrum and DFT matrices
    arrive as arguments (not closure constants) so GB-scale operands never
    become jit constants — the compile-payload failure mode documented at
    ops/conv.py:612-618.

    ``q_batch`` packs that many quadrant angles into each scan step
    : the per-step conv batch grows from ``4*F`` to
    ``q_batch*4*F`` kernels — deeper contractions, fewer scan-step
    fusion boundaries — and the rotation gathers of the batch issue
    together. The caller pads the schedule to a multiple of ``q_batch``
    with invalid slots (``slot_valid=0`` everywhere, masked to ``-inf``
    before the running max, so results are unchanged)."""
    from topo_descriptors_tpu.ops.spline_rotate import (
        canvas_variants,
        rotate_std_canvas_table,
    )

    key = (n, kmax, h, w, n_flats, conv, q_batch)
    fn = _STREAM_CACHE.get(key)
    if fn is not None:
        return fn

    if conv == "fft":
        fh = _fft_shape(h + kmax - 1)
        fw = _fft_shape(w + kmax - 1)
        sh = sw = (kmax - 1) // 2

    def scan_fn(table, dem_or_fdr, fdi, mats, qparams, slot_angle,
                slot_valid):
        if conv == "fft":
            f_dem = jnp.fft.rfft2(dem_or_fdr, s=(fh, fw))

        def conv_fn(kernels):
            if conv == "mm":
                return conv_bank_mats(kernels, dem_or_fdr, fdi, *mats)
            fk = jnp.fft.rfft2(kernels, s=(fh, fw))
            full = jnp.fft.irfft2(f_dem[None] * fk, s=(fh, fw))
            return jax.lax.slice(
                full, (0, sh, sw), (kernels.shape[0], sh + h, sw + w)
            ).astype(dem_or_fdr.dtype)

        def body(carry, xs):
            norm, direction = carry
            params_q, angles_q, valid_q = xs  # (Q,8), (Q,4), (Q,4)
            kerns = []
            for q in range(q_batch):  # static unroll over the angle batch
                canvas = rotate_std_canvas_table(
                    table, n, params_q[q], (kmax, kmax)
                )
                folded = _flat_axis_combine(canvas, axis=0)
                # all four quadrant variants of every batched angle
                # convolve as ONE call (same total MACs, larger matmuls,
                # fewer fusion boundaries)
                kerns.append(
                    jnp.concatenate(
                        canvas_variants(folded, params_q[q]), axis=0
                    )
                )
            kern = jnp.concatenate(kerns, axis=0)  # (Q*4*F, kmax, kmax)
            convs = conv_fn(kern).reshape(4 * q_batch, n_flats, h, w)
            comb = jnp.max(convs, axis=1)  # (Q*4, h, w)
            valid = valid_q.reshape(4 * q_batch)
            angles = angles_q.reshape(4 * q_batch)
            comb = jnp.where(valid[:, None, None] > 0, comb, -jnp.inf)
            best = jnp.max(comb, axis=0)
            # min angle among the batch's argmax set — equals the
            # reference's ascending strictly-greater update for any order
            amin = jnp.min(
                jnp.where(comb == best, angles[:, None, None], jnp.inf),
                axis=0,
            )
            greater = best > norm
            equal = (best == norm) & (norm > -jnp.inf)
            direction = jnp.where(
                greater,
                amin,
                jnp.where(equal, jnp.minimum(direction, amin), direction),
            )
            norm = jnp.where(greater, best, norm)
            return (norm, direction), None

        init = (
            jnp.full((h, w), -jnp.inf, dtype=jnp.float32),
            jnp.zeros((h, w), dtype=jnp.float32),
        )
        n_steps = qparams.shape[0] // q_batch
        xs = (
            qparams.reshape(n_steps, q_batch, -1),
            slot_angle.reshape(n_steps, q_batch, -1),
            slot_valid.reshape(n_steps, q_batch, -1),
        )
        (norm, direction), _ = jax.lax.scan(body, init, xs)
        return norm, direction

    fn = jax.jit(scan_fn)
    _STREAM_CACHE[key] = fn
    return fn


def valley_ridge_streamed(
    dem: jax.Array,
    size: int,
    mode: str,
    flat_list: Sequence[float] = (0, 0.15, 0.3),
    sigma: Optional[float] = None,
    stats: Optional[tuple] = None,
    n_angles: int = 180,
    conv_method: str = "auto",
    q_batch: int = 4,
) -> List[jax.Array]:
    """Valley/ridge with the kernel rotation performed ON DEVICE.

    Semantics match :func:`valley_ridge` (reference topo.py:389-453) to
    float32 rounding; the restructure is for scales where the 180-angle bank
    cannot exist as one array — the reference's 20-100 km batch scales imply
    a 1.9-48 GB bank at 30 m resolution (the reference itself only ever
    holds ONE rotated stack at a time, topo.py:441-443, and pays 180 host
    rotations per scale).

    Execution model (one jitted ``lax.scan``, everything device-resident):

    * the *base* V/U stack is spline-prefiltered once and packed into the
      lane-contiguous gather table
      (:func:`~topo_descriptors_tpu.ops.spline_rotate.build_rotation_table`
      — one 27-wide gather per canvas instead of nine 3-wide ones, ~4x);
    * only the ~46 quadrant angles [0, 45] are actually rotated; the other
      three quadrants are exact flips/rot90s of those canvases
      (:func:`~topo_descriptors_tpu.ops.spline_rotate.canvas_variants` —
      the base kernels' flip symmetry makes this bit-faithful to scipy);
    * the flat-axis combine is folded into the kernel canvases before
      convolving (linearity), so each angle costs F convolutions + a max;
    * convolutions run as partial-DFT matmuls
      (:mod:`~topo_descriptors_tpu.ops.dft_conv`) or hoisted-field XLA FFT,
      whichever the calibrated cost model prefers at this size
      (``conv_method='auto'``; the FFT side wins only at ~100 km where the
      kernel extent dwarfs the field).

    The running max/argmax uses the min-angle-on-ties rule, which equals
    the reference's ascending strictly-greater update (topo.py:445) for
    any processing order. Peak memory is O(one angle) in the kernel extent.
    """
    if mode not in ("valley", "ridge"):
        raise ValueError(f"Unknown mode {mode!r}")
    from topo_descriptors_tpu.ops.spline_rotate import (
        build_rotation_table,
        prefilter2d_o2,
        quadrant_schedule,
        rotation_params,
    )
    from topo_descriptors_tpu.utils.transfer import chunked_device_put

    dem = _standardized(dem, sigma, stats)
    base = (
        ridge_kernels(size, flat_list)
        if mode == "ridge"
        else valley_kernels(size, flat_list)
    )
    n_flats = len(flat_list)
    ky_max, kx_max = rotated_extent(size, np.arange(n_angles))
    kmax = max(ky_max, kx_max)
    h, w = dem.shape

    filt = prefilter2d_o2(chunked_device_put(base.astype(np.float32)))
    table = build_rotation_table(filt)
    q_angles, slot_angle, slot_valid = quadrant_schedule(n_angles)
    qparams = np.stack(
        [rotation_params(size, float(q), kmax, kmax) for q in q_angles]
    )
    q_batch = max(1, min(int(q_batch), len(q_angles)))
    if pad := (-len(q_angles)) % q_batch:
        # pad the schedule with all-invalid slots (masked to -inf before
        # the running max) so steps hold exactly q_batch angles each
        qparams = np.concatenate([qparams, np.repeat(qparams[:1], pad, 0)])
        slot_angle = np.concatenate(
            [slot_angle, np.zeros((pad, 4), np.float32)]
        )
        slot_valid = np.concatenate([slot_valid, np.zeros((pad, 4), bool)])

    if conv_method == "auto":
        conv = "mm" if prefer_dft_matmul(h, w, kmax, kmax) else "fft"
    else:
        conv = conv_method
    if conv == "mm":
        plan = get_plan(h, w, kmax, kmax, "same")
        fdr, fdi = field_spectrum(dem, plan)
        mats = plan.mats
        first = fdr
    else:
        fdi = jnp.zeros((), jnp.float32)
        mats = ()
        first = dem

    qparams_j = jnp.asarray(qparams)
    stack_bytes = qparams.shape[0] * n_flats * kmax * kmax * 4
    if (
        stack_bytes <= CFG.valley_canvas_cache_bytes
        and not DftConvPlan._tracing()
    ):
        # rotate once per (size, mode, flats) signature, cache the folded
        # canvas stack on device — banded/tiled drivers and warm services
        # repeat the signature every call (see _streamed_scan_cached_fn)
        ckey = (
            size, mode, tuple(float(f) for f in flat_list), n_angles,
            n_flats, q_batch,
        )
        canvases = _CANVAS_DEV_CACHE.get(ckey)
        if canvases is None:
            canvases = _rotate_all_fn(size, kmax, n_flats)(table, qparams_j)
            while len(_CANVAS_DEV_CACHE) >= 2:  # bound resident stacks
                _CANVAS_DEV_CACHE.pop(next(iter(_CANVAS_DEV_CACHE)))
            _CANVAS_DEV_CACHE[ckey] = canvases
        scan = _streamed_scan_cached_fn(
            size, kmax, h, w, n_flats, conv, q_batch
        )
        norm, direction = scan(
            canvases,
            first,
            fdi,
            mats,
            qparams_j,
            jnp.asarray(slot_angle),
            jnp.asarray(slot_valid.astype(np.float32)),
        )
        return [jnp.clip(norm, 0.0, None), direction]

    scan = _streamed_scan_fn(size, kmax, h, w, n_flats, conv, q_batch)
    norm, direction = scan(
        table,
        first,
        fdi,
        mats,
        qparams_j,
        jnp.asarray(slot_angle),
        jnp.asarray(slot_valid.astype(np.float32)),
    )
    return [jnp.clip(norm, 0.0, None), direction]


def valley_ridge(
    dem: jax.Array,
    size: int,
    mode: str,
    flat_list: Sequence[float] = (0, 0.15, 0.3),
    sigma: Optional[float] = None,
    bank: Optional[np.ndarray] = None,
    method: str = "auto",
    stats: Optional[tuple] = None,
    angle_chunk: int = 30,
) -> List[jax.Array]:
    """Valley/ridge index norm and direction (0..179 deg, clockwise).

    Parity target: reference ``valley_ridge`` (topo.py:389-453): optional
    Gaussian pre-smooth, global standardization (a cross-device psum in the
    sharded path), then for each integer angle a rotated-kernel 3-D
    convolution, max over flat variants and a running strictly-greater
    max/argmax across angles (ties keep the earliest angle).

    Restructure: the reference rotates kernels and convolves inside a
    Python loop per angle (180 host round-trips). Here the angle loop is a
    device-side ``lax.scan``; the kernel bank is either precomputed
    host-side with scipy-exact rotation (banks within
    ``CFG.valley_bank_max_bytes``) or rotated on device per quadrant angle
    (:func:`valley_ridge_streamed`). ``method``:

    * ``'auto'`` — streamed when the bank exceeds the budget, else
      ``'dftmm'``;
    * ``'dftmm'`` — pre-folded bank convolved by partial-DFT matmuls
      (ops/dft_conv.py);
    * ``'fft'`` — hoisted-field XLA-FFT scan;
    * ``'stream'`` — force the streamed on-device-rotation path.
    """
    if mode not in ("valley", "ridge"):
        raise ValueError(f"Unknown mode {mode!r}")
    if bank is None and (
        method == "stream"
        or (
            method == "auto"
            and bank_nbytes(size, len(flat_list)) > CFG.valley_bank_max_bytes
        )
    ):
        # bank too large to exist as one static array (17-48 GB at the
        # reference's own 60-100 km example scales): rotate on device
        return valley_ridge_streamed(dem, size, mode, flat_list, sigma, stats)

    dem = _standardized(dem, sigma, stats)
    if method in ("auto", "dftmm"):
        if bank is None:
            # canonical signature: cache the folded device bank and skip
            # the scipy rotations entirely on a hit
            key = (size, mode, tuple(float(f) for f in flat_list))
            ky, kx = rotated_extent(size)
            shape = (180, len(flat_list), ky, kx)
            return _valley_ridge_bank_mm(
                dem, None, angle_chunk, cache_key=key, bank_shape=shape,
                builder=lambda: prepare_valley_bank(size, mode, flat_list),
            )
        return _valley_ridge_bank_mm(dem, bank, angle_chunk)

    if method != "fft":
        raise ValueError(f"unknown valley/ridge method {method!r}")
    if bank is None:
        bank = prepare_valley_bank(size, mode, flat_list)
    a_angles, n_flats, ky, kx = bank.shape
    h, w = dem.shape
    fh = _fft_shape(h + ky - 1)
    fw = _fft_shape(w + kx - 1)
    # bound the (chunk*F, fh, fw/2+1) complex transients (and cuFFT's work
    # area) by the chunk budget, as the matmul path does
    per_angle = fh * (fw // 2 + 1) * 8 * n_flats
    angle_chunk = max(1, min(angle_chunk, CFG.valley_chunk_bytes // per_angle))
    while a_angles % angle_chunk:
        angle_chunk -= 1
    n_chunks = a_angles // angle_chunk

    f_dem = jnp.fft.rfft2(dem, s=(fh, fw))
    sh, sw = (ky - 1) // 2, (kx - 1) // 2

    def conv_chunk(kernels):  # (chunk*F, ky, kx) -> (chunk*F, H, W)
        fk = jnp.fft.rfft2(kernels, s=(fh, fw))
        full = jnp.fft.irfft2(f_dem[None] * fk, s=(fh, fw))
        return jax.lax.slice(
            full, (0, sh, sw), (kernels.shape[0], sh + h, sw + w)
        ).astype(dem.dtype)

    bank_chunks = jnp.asarray(
        bank.reshape(n_chunks, angle_chunk * n_flats, ky, kx), dtype=dem.dtype
    )

    def step(carry, inputs):
        norm, direction = carry
        kernels, chunk_idx = inputs
        convs = conv_chunk(kernels).reshape(angle_chunk, n_flats, h, w)
        combined = jnp.max(_flat_axis_combine(convs, axis=1), axis=1)
        # within-chunk: argmax keeps the earliest angle on ties, matching the
        # reference's strictly-greater running update (topo.py:445)
        chunk_best = jnp.max(combined, axis=0)
        chunk_arg = jnp.argmax(combined, axis=0).astype(dem.dtype)
        greater = chunk_best > norm
        norm = jnp.where(greater, chunk_best, norm)
        direction = jnp.where(
            greater, chunk_idx * angle_chunk + chunk_arg, direction
        )
        return (norm, direction), None

    init = (
        jnp.full((h, w), -jnp.inf, dtype=dem.dtype),
        jnp.zeros((h, w), dtype=dem.dtype),
    )
    (index_norm, index_dir), _ = jax.lax.scan(
        step, init, (bank_chunks, jnp.arange(n_chunks, dtype=dem.dtype))
    )
    return [jnp.clip(index_norm, 0.0, None), index_dir]
