"""Topographic Position Index (TPI)."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from topo_descriptors_tpu.kernels.disk import circular_kernel
from topo_descriptors_tpu.ops.conv import (
    conv2d_same,
    edge_count_plane_device,
    gaussian_filter,
)


def tpi(
    dem: jax.Array,
    size: int,
    sigma: Optional[float] = None,
    count_plane: Optional[np.ndarray] = None,
    center: Optional[float] = None,
) -> jax.Array:
    """Elevation difference of each pixel to the mean of its disk-shaped
    neighbourhood (centre tap excluded).

    Parity target: reference ``tpi`` (topo.py:145-181) — disk kernel with
    zeroed centre, optional Gaussian pre-smooth, ``signal.convolve(mode=
    'same')`` (zero boundary) and ``dem - conv/sum(kernel)``.

    Formulation: the convolution runs on the *mean-centred* field, with
    the exact boundary tap-count plane (host-precomputed integral image)
    restoring the offset. Mathematically identical, but float32 device
    arithmetic keeps full precision where the naive form loses ~5 digits to
    the large elevation offset.
    """
    kernel = circular_kernel(size, exclude_center=True)
    kernel_sum = float(kernel.sum())

    if sigma:
        dem = gaussian_filter(dem, sigma)

    if count_plane is None:
        counts = edge_count_plane_device(dem.shape, kernel).astype(dem.dtype)
    else:
        counts = jnp.asarray(count_plane, dtype=dem.dtype)

    if center is None:
        center = jnp.round(jnp.mean(dem))
    else:
        center = jnp.asarray(center, dtype=dem.dtype)
    conv_centered = conv2d_same(dem - center, kernel)
    neighbourhood_sum = conv_centered + center * counts
    return dem - neighbourhood_sum / kernel_sum
