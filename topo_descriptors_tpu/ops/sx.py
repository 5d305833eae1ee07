"""Sx (Winstral wind-shelter) horizon scan."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def sx_backend(method: str = "auto") -> str:
    """The one place that picks the Sx backend.

    ``'auto'`` takes the Pallas kernel (ops/pallas/sx_gpu.py) when JAX's
    default backend is a GPU and the XLA scan everywhere else; ``'pallas'``
    and ``'xla'`` name a backend explicitly. Interpret mode is never chosen
    here: the CPU tests call the kernel with ``interpret=True`` themselves.
    """
    if method == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "xla"
    if method not in ("pallas", "xla"):
        raise ValueError(f"unknown Sx method {method!r}")
    return method


def _scan_max_ratio(dem, offsets, distances, border, height):
    """Raw max ratio (A, H, W) by a scan of K shifted whole-array slices per
    azimuth (``lax.map`` over the fan)."""
    h, w = dem.shape
    pad = int(border)
    padded = jnp.pad(dem, pad, mode="constant", constant_values=np.nan)
    base = dem + jnp.asarray(height, dtype=dem.dtype)
    neg_inf = jnp.full((h, w), -jnp.inf, dtype=dem.dtype)

    offs = jnp.asarray(np.asarray(offsets) + pad, dtype=jnp.int32)
    with np.errstate(divide="ignore"):  # distance-0 quirk pixels, see sx()
        invs = jnp.asarray(
            (1.0 / np.asarray(distances)).astype(np.float32), dtype=dem.dtype
        )

    def one_azimuth(args):
        offs_a, invs_a = args

        def step(carry, inputs):
            start, inv = inputs
            shifted = jax.lax.dynamic_slice(padded, (start[0], start[1]), (h, w))
            return jnp.fmax(carry, (shifted - base) * inv), None

        max_ratio, _ = jax.lax.scan(step, neg_inf, (offs_a, invs_a), unroll=8)
        return max_ratio

    return jax.lax.map(one_azimuth, (offs, invs))


def _finish(max_ratio, border, zero_border, dtype):
    """atan epilogue shared by both backends: one transcendental per pixel
    after the max, NaN where no candidate existed, the zero border."""
    sx_deg = jnp.degrees(jnp.arctan(max_ratio))
    # no valid candidate at all (NaN centre pixel, or radius_min masked every
    # ray pixel) -> reference np.nanmax yields NaN (topo.py:951)
    sx_deg = jnp.where(jnp.isneginf(max_ratio), jnp.nan, sx_deg)
    if not zero_border:  # tiled path masks at the global frame instead
        return sx_deg.astype(dtype)
    h, w = max_ratio.shape[-2:]
    pad = int(border)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= pad) & (yy < h - pad) & (xx >= pad) & (xx < w - pad)
    return jnp.where(interior, sx_deg, 0.0).astype(dtype)


def sx(
    dem: jax.Array,
    offsets: np.ndarray,
    distances: np.ndarray,
    border: int,
    height: float = 10.0,
    method: str = "auto",
    zero_border: bool = True,
) -> jax.Array:
    """Maximum elevation angle along the azimuth fan's ray pixels.

    Parity target: reference ``_sx_rolling`` (topo.py:928-953): for every
    interior pixel, gather the DEM along all Bresenham line pixels,
    ``elev = atan((dem_line - dem0 - height) / dist)`` in degrees, NaN-ignoring
    max; a border of width ``border`` stays 0.

    Restructure: the reference's per-pixel gather loop becomes K
    whole-array shifted fused-multiply-max passes over static offsets —
    a pure data-parallel reduction with *no* gathers. Two identities make
    this cheap:

    * ``atan`` is monotonic, so ``max(atan(r_k)) == atan(max(r_k))`` — one
      transcendental per pixel instead of K;
    * NaN distances (radius_min exclusions, reference topo.py:845) map to
      NaN ratios, which ``fmax`` skips exactly like the reference's
      ``np.nanmax``.

    Parameters come from :func:`topo_descriptors_tpu.kernels.sx_offsets`.

    Quirk parity: for even window sizes the reference's distance window is
    centred one pixel off the ray convergence point (floor(w_float/2) vs
    floor(w_int/2), topo.py:869-871 vs 848), leaving a ray pixel at distance
    0; its candidates are atan(z/0) = +/-90 deg (or skipped when z == 0).
    The infinities here reproduce that: (z)*(1/0)=+/-inf -> +/-90, and
    0*inf = NaN is dropped by fmax exactly like the reference's nanmax.

    The offset table is deduplicated first
    (:func:`~topo_descriptors_tpu.kernels.sx_geometry.sx_dedupe` — exact:
    duplicates carry identical candidates and the max is idempotent), which
    shrinks the reference's fan tables 2-7x at 30 m resolution.

    ``method`` is resolved by :func:`sx_backend`; this is the one-azimuth
    case of :func:`sx_sweep`.
    """
    out = sx_sweep(
        dem, np.asarray(offsets)[None], np.asarray(distances)[None], border,
        height, method, zero_border,
    )
    return out[0]


def sx_sweep(
    dem: jax.Array,
    offsets: np.ndarray,
    distances: np.ndarray,
    border: int,
    height: float = 10.0,
    method: str = "auto",
    zero_border: bool = True,
) -> jax.Array:
    """Sx for a whole fan of azimuths in one device program -> (A, H, W).

    The reference loops ``compute_sx`` per azimuth from the host, re-reading
    the DEM each time (an azimuth sweep 0-350 deg is 36 independent runs).
    Here all azimuths share one device program: the Pallas kernel's grid
    carries the azimuth as its fastest dimension, and the XLA scan maps over
    the azimuths of one NaN-padded DEM. Rectangular tables pad rays with NaN
    distances, which the fmax reduction ignores by construction.

    ``offsets`` is (A, Kmax, 2) int32, ``distances`` (A, Kmax) with NaN
    padding; build both with
    :func:`topo_descriptors_tpu.kernels.sx_geometry.sx_sweep_offsets`.

    All fan tables are deduplicated first (sx_sweep_dedupe — exact, the
    reference's arcs are massively redundant: 240 -> 32 rays at r=500 m,
    986 -> 464 at r=2000 m on 30 m grids). ``method`` is resolved by
    :func:`sx_backend`.
    """
    from topo_descriptors_tpu.kernels.sx_geometry import sx_sweep_dedupe

    offsets, distances = sx_sweep_dedupe(offsets, distances)
    if sx_backend(method) == "pallas":
        from topo_descriptors_tpu.ops.pallas.sx_gpu import sx_max_ratio

        max_ratio = sx_max_ratio(dem, offsets, distances, border, height)
    else:
        max_ratio = _scan_max_ratio(dem, offsets, distances, border, height)
    return _finish(max_ratio, border, zero_border, dem.dtype)
