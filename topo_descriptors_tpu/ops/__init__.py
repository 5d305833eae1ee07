"""Descriptor ops: pure, jit-compiled array -> array transforms.

Each op mirrors one numerical core of the reference (topo.py) with identical
semantics but a data-parallel execution plan for the accelerator. Ops never touch metadata or I/O —
that lives in grid.py / pipeline.py — so every function here can be wrapped
in ``jax.jit``, ``shard_map``, or ``vmap`` unchanged.
"""

from topo_descriptors_tpu.ops.conv import (
    conv2d_same,
    conv2d_same_batch,
    convolve_reflect,
    edge_count_plane,
    gaussian_filter,
    gradient_axis,
)
from topo_descriptors_tpu.ops.dem import dem
from topo_descriptors_tpu.ops.tpi import tpi
from topo_descriptors_tpu.ops.std import std
from topo_descriptors_tpu.ops.gradient import gradient, sobel
from topo_descriptors_tpu.ops.valley_ridge import (
    valley_ridge,
    valley_ridge_streamed,
)
from topo_descriptors_tpu.ops.sx import sx, sx_sweep
from topo_descriptors_tpu.ops.multiscale import disk_descriptors

__all__ = [
    "conv2d_same",
    "conv2d_same_batch",
    "convolve_reflect",
    "edge_count_plane",
    "gaussian_filter",
    "gradient_axis",
    "dem",
    "tpi",
    "std",
    "gradient",
    "sobel",
    "valley_ridge",
    "valley_ridge_streamed",
    "sx",
    "sx_sweep",
    "disk_descriptors",
]
