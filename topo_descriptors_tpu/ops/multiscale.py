"""Fused multi-scale disk descriptors: TPI + rolling STD for S scales in one
device program.

The reference computes each (descriptor, scale) independently — for a
12-scale batch that is 12 Gaussian-smooths + 12 TPI convs + 24 STD convs,
each a fresh pass over the DEM (scripts/compute_topo_descriptors.py:44-62).
Here the whole batch is one XLA program:

* the three moment fields (z-c, t-c, (t-c)^2) are built **once** and shared
  by every scale;
* each scale runs one prefix-sum disk convolution over the stacked fields
  (``conv2d_same_multi``), whose cost scales with the disk *diameter*, not its area;
* TPI costs nothing beyond STD: the centre-zeroed disk conv is the full
  disk conv minus the centre value (conv(z, disk - delta) = conv(z, disk)
  - z), so TPI is an elementwise epilogue on STD's intermediates.

An earlier formulation shared batched rFFTs across scales; the prefix-sum
engine replaced it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


def disk_descriptors(
    dem: jax.Array,
    sizes: Sequence[int],
    sigma: Optional[float] = None,
    int32_parity: Optional[bool] = None,
    compute_tpi: bool = True,
    compute_std: bool = True,
    center: Optional[float] = None,
) -> Dict[str, jax.Array]:
    """TPI and/or rolling STD at every disk size, sharing the moment fields.

    Semantics per scale are identical to :func:`ops.tpi` / :func:`ops.std`
    (reference topo.py:145-181, 272-307) with one shared pre-smooth sigma
    (pass None for raw). Returns ``{"tpi": (S,H,W), "std": (S,H,W)}``.
    ``center`` overrides the centring constant — the banded out-of-core
    runner passes the global one so every band sees identical algebra.
    """
    if int32_parity is None:
        int32_parity = CFG.std_int32_parity
    sizes = [int(s) for s in sizes]
    if sigma:
        dem = gaussian_filter(dem, sigma)

    if center is None:
        c = jnp.round(jnp.mean(dem))
    else:
        c = jnp.asarray(center, dtype=dem.dtype)
    z_c = dem - c
    if compute_std:
        t = jnp.trunc(dem) if int32_parity else dem
        t_c = t - c
        fields = jnp.stack([z_c, t_c, t_c * t_c])  # shared across scales
    else:
        fields = z_c[None]

    out_tpi = []
    out_std = []
    for size in sizes:
        disk = circular_kernel(size)
        ksum = float(disk.sum())
        count = edge_count_plane_device(dem.shape, disk).astype(dem.dtype)
        convs = conv2d_same_multi(fields, disk)
        z_conv = convs[0]
        if compute_tpi:
            # centre-zeroed disk: subtract the centre tap contribution
            tpi_sum = (z_conv - z_c) + c * (count - 1.0)
            out_tpi.append(dem - tpi_sum / (ksum - 1.0))
        if compute_std:
            t_conv, q_conv = convs[1], convs[2]
            sum_sq = q_conv + 2.0 * c * t_conv + c * c * count
            sum_dem = z_conv + c * count
            var = (sum_sq - sum_dem * sum_dem / ksum) / (ksum - 1.0)
            out_std.append(jnp.sqrt(jnp.clip(var, 0.0, None)))

    result: Dict[str, jax.Array] = {}
    if compute_tpi:
        result["tpi"] = jnp.stack(out_tpi)
    if compute_std:
        result["std"] = jnp.stack(out_std)
    return result
