"""Device mesh construction and raster sharding."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from topo_descriptors_tpu.config import CFG

GY, GX = "gy", "gx"


def _near_square_factors(n: int) -> Tuple[int, int]:
    """Factor n into (gy, gx) as close to square as possible."""
    best = (1, n)
    for gy in range(1, int(np.sqrt(n)) + 1):
        if n % gy == 0:
            best = (gy, n // gy)
    return best


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2-D ``Mesh`` with axes ('gy', 'gx') — the spatial decomposition grid.

    The y/x split mirrors the DEM's row/column blocking; collectives along
    each axis are nearest-neighbour (halo) or all-reduce (global stats),
    which XLA hands to NCCL over NVLink. Every card of a host reaches every
    other at the same rate, so the near-square shape follows the algorithm
    alone: it minimizes halo perimeter.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = CFG.mesh_shape or _near_square_factors(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(np.asarray(devices).reshape(shape), (GY, GX))


def spatial_spec() -> P:
    return P(GY, GX)


def shard_raster(mesh: Mesh, array) -> jax.Array:
    """Place a (possibly padded) global 2-D array onto the mesh, blocked
    (gy, gx). The global shape must divide evenly by the mesh — use
    :func:`pad_to_mesh` first for arbitrary shapes."""
    sharding = NamedSharding(mesh, spatial_spec())
    return jax.device_put(array, sharding)


def pad_to_mesh(array: np.ndarray, mesh: Mesh, fill=np.nan):
    """Pad a global array on the bottom/right so each dim divides the mesh.

    Returns (padded, (orig_h, orig_w)). The fill value is NaN by default so
    stray padding is loud if it ever leaks into a result (outputs are cropped
    back to the original shape by the drivers).
    """
    gy, gx = mesh.devices.shape
    h, w = array.shape
    ph = (-h) % gy
    pw = (-w) % gx
    if ph or pw:
        array = np.pad(
            array, ((0, ph), (0, pw)), mode="constant", constant_values=fill
        )
    return array, (h, w)
