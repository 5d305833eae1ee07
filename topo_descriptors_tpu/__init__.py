"""topo_descriptors_tpu — a terrain-descriptor engine for NVIDIA GPUs.

A from-scratch JAX / XLA / Pallas framework with the full capability surface of
MeteoSwiss/topo-descriptors, built for the accelerator:

* descriptor math runs as jit-compiled XLA programs (matmul-DFT convolutions,
  fused elementwise chains) instead of scipy.ndimage loops on numpy arrays;
* the Sx horizon scan is a static-offset shifted-max kernel instead of a
  per-pixel Numba loop (reference topo.py:928-953);
* DEMs scale past one chip through 2-D spatial sharding over a
  ``jax.sharding.Mesh`` with halo-exchange collectives (``ppermute``) instead
  of dask ``map_overlap`` tiling (reference topo.py:177-178).

Public API mirrors the reference's two-module layout:

* :mod:`topo_descriptors_tpu.pipeline` — ``compute_*`` batch drivers
  (reference topo.py:16,88,216,317,534,715)
* :mod:`topo_descriptors_tpu.ops` — pure-array descriptor ops
  (reference topo.py:62,145,273,390,598,776)
* :mod:`topo_descriptors_tpu.geo` / :mod:`topo_descriptors_tpu.grid` — grid
  helpers (reference helpers.py)
"""

from topo_descriptors_tpu.config import CFG, Config

__version__ = "0.1.0"
__all__ = ["CFG", "Config", "__version__"]
