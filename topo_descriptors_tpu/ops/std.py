"""Rolling standard deviation over a disk neighbourhood."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from topo_descriptors_tpu.config import CFG
from topo_descriptors_tpu.kernels.disk import circular_kernel
from topo_descriptors_tpu.ops.conv import (
    conv2d_same_multi,
    edge_count_plane_device,
    gaussian_filter,
)


def std(
    dem: jax.Array,
    size: int,
    sigma: Optional[float] = None,
    count_plane: Optional[np.ndarray] = None,
    int32_parity: Optional[bool] = None,
    center: Optional[float] = None,
) -> jax.Array:
    """One-pass rolling standard deviation within a disk of diameter ``size``.

    Parity target: reference ``std`` (topo.py:272-307) —
    ``var = (conv(trunc32(dem)^2, k) - conv(dem, k)^2 / sum(k)) / (sum(k)-1)``
    clipped at 0, then sqrt. The reference truncates the DEM to int32 before
    squaring (topo.py:300); ``int32_parity`` reproduces that quirk (default
    from CFG.std_int32_parity; set False for the clean float variance).

    Formulation: the naive sum/sum-of-squares difference cancels
    catastrophically in float32 (scipy hides it by accumulating the squared
    field in float64). Instead, all three moment fields are *mean-centred*
    before a single batched convolution, and the exact boundary tap-count
    plane restores the offset terms:

        sum_sq = Q + 2c*T + c^2*C,   sum = Z + c*C

    with Q=conv((t-c)^2), T=conv(t-c), Z=conv(z-c), C the in-bounds tap
    count, t the (optionally truncated) field, z the field, c=round(mean(z)).
    Identical algebra, float32-stable everywhere including borders.
    """
    if int32_parity is None:
        int32_parity = CFG.std_int32_parity
    kernel = circular_kernel(size)
    kernel_sum = float(kernel.sum())

    if sigma:
        dem = gaussian_filter(dem, sigma)

    if count_plane is None:
        counts = edge_count_plane_device(dem.shape, kernel).astype(dem.dtype)
    else:
        counts = jnp.asarray(count_plane, dtype=dem.dtype)

    if center is None:
        c = jnp.round(jnp.mean(dem))
    else:
        c = jnp.asarray(center, dtype=dem.dtype)
    t = jnp.trunc(dem) if int32_parity else dem
    t_c = t - c
    z_c = dem - c

    stack = jnp.stack([t_c * t_c, t_c, z_c])
    q_conv, t_conv, z_conv = conv2d_same_multi(stack, kernel)

    sum_sq = q_conv + 2.0 * c * t_conv + c * c * counts
    sum_dem = z_conv + c * counts
    variance = (sum_sq - sum_dem * sum_dem / kernel_sum) / (kernel_sum - 1.0)
    variance = jnp.clip(variance, 0.0, None)
    return jnp.sqrt(variance)
