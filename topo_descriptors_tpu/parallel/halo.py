"""Halo-exchange collectives over the ('gy','gx') mesh.

Each stencil op needs a rim of neighbour data around its local block: the
kernel radius for disk/valley convolutions, ``int(4*sigma+0.5)`` for the
Gaussian, one row for np.gradient, the full ray length ``radius_pxl`` for Sx
(SURVEY.md §2b N2). The rim moves with ``jax.lax.ppermute`` shifts along each
mesh axis — nearest-neighbour traffic that XLA hands to NCCL over NVLink — with
multi-hop shifts when the halo is wider than a block (Sx at coarse meshes).

Boundary fills at the true domain edge reproduce the single-chip semantics:

* ``'zero'``   — scipy.signal.convolve 'same' zero boundary (TPI/STD/valley)
* ``'nan'``    — Sx (border pixels are overwritten with 0 afterwards)
* ``'reflect'``— scipy.ndimage 'reflect' (Gaussian, Sobel)
* ``'linear_extrap'`` — one-row linear extrapolation; central differences on
  it reproduce np.gradient's one-sided edge formula exactly
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp

HaloSpec = Union[int, Tuple[int, int]]


def _norm_halo(h: HaloSpec) -> Tuple[int, int]:
    if isinstance(h, tuple):
        return h
    return (int(h), int(h))


def _take(x, axis: int, start: int, size: int):
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(start, start + size)
    return x[tuple(sl)]


def _edge_fill(x, axis: int, size: int, side: str, fill: str):
    """Boundary fill chunk of ``size`` rows/cols at the true domain edge."""
    if fill == "zero":
        shape = list(x.shape)
        shape[axis] = size
        return jnp.zeros(shape, x.dtype)
    if fill == "nan":
        shape = list(x.shape)
        shape[axis] = size
        return jnp.full(shape, jnp.nan, x.dtype)
    if fill == "reflect":
        # symmetric reflection about the edge: d c b a | a b c d
        if side == "lo":
            return jnp.flip(_take(x, axis, 0, size), axis=axis)
        return jnp.flip(_take(x, axis, x.shape[axis] - size, size), axis=axis)
    if fill == "linear_extrap":
        if size != 1:
            raise ValueError("linear_extrap fill supports halo width 1 only")
        if side == "lo":
            a0 = _take(x, axis, 0, 1)
            a1 = _take(x, axis, 1, 1)
        else:
            n = x.shape[axis]
            a0 = _take(x, axis, n - 1, 1)
            a1 = _take(x, axis, n - 2, 1)
        return 2.0 * a0 - a1
    raise ValueError(f"unknown fill {fill!r}")


def _reflect_oob(
    ext: jax.Array, axis: int, lo: int, axis_name: str, n: int, total: int
) -> jax.Array:
    """Overwrite out-of-domain positions of a halo-extended block with the
    symmetric reflection of the in-domain data.

    ``ext`` is the block extended by a multi-hop zero-fill exchange, so every
    position whose *global* index lies inside ``[0, total)`` already holds
    true data; positions beyond the domain edge hold filler. The reflection
    source of global row ``g`` is ``-1-g`` (top) / ``2*total-1-g`` (bottom) —
    scipy.ndimage's 'reflect' (``d c b a | a b c d``) — and, provided the
    halo is no wider than block + opposite halo (checked by the caller), that
    source is already present in ``ext``, so one dynamic gather finishes the
    job. Interior devices gather the identity.
    """
    length = ext.shape[axis]
    base = jax.lax.axis_index(axis_name) * n - lo
    g = base + jnp.arange(length)
    r = jnp.where(g < 0, -1 - g, jnp.where(g >= total, 2 * total - 1 - g, g))
    return jnp.take(ext, r - base, axis=axis)


def halo_pad_1d(
    x: jax.Array,
    axis: int,
    halo: HaloSpec,
    axis_name: str,
    axis_size: int,
    fill: str = "zero",
) -> jax.Array:
    """Extend the local block along one mesh axis with (lo, hi) halo rows.

    Multi-hop: a halo wider than the block length gathers from
    neighbours-of-neighbours via repeated ``ppermute`` shifts. ``reflect``
    supports halos wider than a block too (big-sigma Gaussian on wide
    meshes): the halo is first gathered with a zero-fill multi-hop exchange,
    then out-of-domain positions are overwritten with reflections of the
    gathered in-domain data (:func:`_reflect_oob`). ``linear_extrap`` is
    one-row by contract (np.gradient edges).
    """
    lo, hi = _norm_halo(halo)
    n = x.shape[axis]
    if (lo > n or hi > n) and fill == "linear_extrap":
        raise ValueError(f"{fill} fill needs halo <= block ({(lo, hi)} vs {n})")
    if (lo > n or hi > n) and fill == "reflect":
        total = axis_size * n
        if lo > n + hi or hi > n + lo or lo >= total or hi >= total:
            raise ValueError(
                f"reflect halo {(lo, hi)} too wide for mesh axis "
                f"{axis_name} (block {n}, domain {total}): the reflection "
                "source must fit in block + opposite halo; use fewer devices "
                "along this axis or the tiled runner"
            )
        ext = halo_pad_1d(x, axis, halo, axis_name, axis_size, fill="zero")
        return _reflect_oob(ext, axis, lo, axis_name, n, total)
    idx = jax.lax.axis_index(axis_name)

    def side_chunks(side: str, width: int):
        chunks = []
        remaining = width
        k = 1
        while remaining > 0:
            c = min(n, remaining)
            if side == "lo":
                src = _take(x, axis, n - c, c)  # neighbour above sends its tail
                perm = [(s, (s + k) % axis_size) for s in range(axis_size)]
                invalid = idx < k
            else:
                src = _take(x, axis, 0, c)  # neighbour below sends its head
                perm = [(s, (s - k) % axis_size) for s in range(axis_size)]
                invalid = idx >= axis_size - k
            if axis_size > 1:
                recv = jax.lax.ppermute(src, axis_name, perm)
            else:
                recv = src  # unused; fill always wins when axis_size == 1
            filler = _edge_fill(x, axis, c, side, fill)
            chunk = jnp.where(invalid, filler, recv)
            if side == "lo":
                chunks.insert(0, chunk)
            else:
                chunks.append(chunk)
            remaining -= c
            k += 1
        return chunks

    parts = side_chunks("lo", lo) + [x] + side_chunks("hi", hi)
    if len(parts) == 1:
        return x
    return jnp.concatenate(parts, axis=axis)


def exchange_halo(
    x: jax.Array,
    halo_y: HaloSpec,
    halo_x: HaloSpec,
    mesh_shape: Tuple[int, int],
    fill: str = "zero",
    axis_names: Tuple[str, str] = ("gy", "gx"),
    y_axis: int = 0,
    x_axis: int = 1,
) -> jax.Array:
    """2-D halo exchange: rows first, then columns over the row-extended
    block, so corner regions carry true diagonal-neighbour data."""
    gy, gx = mesh_shape
    x = halo_pad_1d(x, y_axis, halo_y, axis_names[0], gy, fill)
    x = halo_pad_1d(x, x_axis, halo_x, axis_names[1], gx, fill)
    return x


def global_index(axis: int, axis_name: str, local_len: int, shape) -> jax.Array:
    """Per-element global index along one axis of a local block."""
    base = jax.lax.axis_index(axis_name) * local_len
    return base + jax.lax.broadcasted_iota(jnp.int32, shape, axis)
