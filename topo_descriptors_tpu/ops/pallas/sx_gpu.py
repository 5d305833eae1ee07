"""Sx horizon scan as a Pallas kernel for NVIDIA GPUs (Triton route).

Same arithmetic as the XLA scan in :mod:`topo_descriptors_tpu.ops.sx`: for
every pixel, ``max_k (dem[p + off_k] - dem[p] - height) * inv_dist_k`` over
the ray pixels of one azimuth fan, NaN candidates skipped by ``fmax``. Only
the raw maximum ratio is produced here; the ``atan`` epilogue, the NaN
rule for pixels without a candidate and the border mask stay in the
caller, shared with the scan.

Execution model:

* the grid is (azimuth, tile_y, tile_x) over power-of-two output tiles;
  the azimuth is the fastest grid dimension, so the programs that re-read
  one tile's halo window for every azimuth of a fan run back to back and
  find it in L2;
* each program reads its own ray table (row offset, column offset,
  1/distance) as runtime data, so one compiled program serves any fan of
  the same table shape, and loops over the rays: one shifted tile load,
  a subtract, a multiply and an ``fmax`` per ray;
* the shifted loads of neighbouring rays overlap almost entirely, so they
  are served from L1/L2: device memory sees each halo window about once
  per program, where the scan streams the whole field once per ray.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Output tile (rows, cols) and warps per program. Powers of two, as Triton
# requires; see PERF.md for the shapes timed on the H100.
TILE = (32, 128)
NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def tile_for(h: int, w: int, tile=TILE) -> tuple:
    """The output tile for an (h, w) grid: ``tile``, shrunk to the grid's
    own power-of-two extent on small grids."""
    return min(tile[0], _next_pow2(h)), min(tile[1], _next_pow2(w))


def ray_tables(offsets: np.ndarray, distances: np.ndarray, border: int):
    """Host-side (A, K) tables of row starts, column starts and 1/distance.

    Starts are offsets shifted by ``border`` so that every load from the
    NaN-padded field begins at a non-negative index. Padding rows (zero
    offset, NaN distance) stay in: their NaN ratio is dropped by ``fmax``.
    """
    offsets = np.asarray(offsets)
    with np.errstate(divide="ignore"):  # distance-0 quirk, see ops.sx
        inv = (1.0 / np.asarray(distances, np.float64)).astype(np.float32)
    oy = (offsets[..., 0] + border).astype(np.int32)
    ox = (offsets[..., 1] + border).astype(np.int32)
    return oy, ox, inv


def _sx_kernel(oy_ref, ox_ref, inv_ref, dem_ref, out_ref, *, border, tile,
               n_rays, height):
    a = pl.program_id(0)
    ty, tx = tile
    r0 = pl.program_id(1) * ty
    c0 = pl.program_id(2) * tx
    base = dem_ref[pl.ds(r0 + border, ty), pl.ds(c0 + border, tx)] + height

    def body(k, acc):
        shifted = dem_ref[pl.ds(r0 + oy_ref[a, k], ty),
                          pl.ds(c0 + ox_ref[a, k], tx)]
        return jnp.fmax(acc, (shifted - base) * inv_ref[a, k])

    acc = jax.lax.fori_loop(
        0, n_rays, body, jnp.full((ty, tx), -jnp.inf, jnp.float32)
    )
    out_ref[...] = acc


def sx_max_ratio(
    dem: jax.Array,
    offsets: np.ndarray,
    distances: np.ndarray,
    border: int,
    height: float = 10.0,
    tile=TILE,
    interpret: bool = False,
) -> jax.Array:
    """Raw max ratio (A, H, W) of a fan of azimuths.

    ``offsets`` (A, K, 2) and ``distances`` (A, K) as built by
    :func:`topo_descriptors_tpu.kernels.sx_geometry.sx_sweep_offsets`
    (deduplicated or not). A pixel without any finite candidate keeps
    ``-inf``. ``interpret=True`` runs the kernel body in the Pallas
    interpreter (CPU tests); it is never chosen automatically.
    """
    h, w = dem.shape
    b = int(border)
    oy, ox, inv = ray_tables(offsets, distances, b)
    n_az, n_rays = oy.shape
    ty, tx = tile_for(h, w, tile)
    gy, gx = pl.cdiv(h, ty), pl.cdiv(w, tx)
    # NaN halo of the ray border on every side, plus the round-up of the
    # last tile: every shifted load stays in bounds, and NaN candidates are
    # skipped by fmax exactly like beyond-edge pixels in the scan
    padded = jnp.pad(
        dem.astype(jnp.float32),
        ((b, gy * ty - h + b), (b, gx * tx - w + b)),
        constant_values=np.nan,
    )
    kernel = functools.partial(
        _sx_kernel, border=b, tile=(ty, tx), n_rays=n_rays,
        height=float(height),
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_az, gy * ty, gx * tx), jnp.float32),
        grid=(n_az, gy, gx),
        # tables and field stay in device memory; programs load what they use
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 4,
        out_specs=pl.BlockSpec((None, ty, tx), lambda a, i, j: (a, i, j)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="sx_fan",
    )(jnp.asarray(oy), jnp.asarray(ox), jnp.asarray(inv), padded)
    return out[:, :h, :w]
