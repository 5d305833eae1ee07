"""Distributed tiling layer: 2-D spatial domain decomposition over a device
mesh with halo-exchange collectives.

The reference's only scaling stories are a Numba shared-memory loop
(topo.py:928) and an optional dask ``map_overlap`` tile path inside tpi
(topo.py:177-178). This package is their multi-device replacement (SURVEY.md
§2b N1-N3): DEM blocks sharded over a ``Mesh(('gy','gx'))``, descriptor ops
run under ``shard_map`` with per-op halo widths exchanged via ``ppermute``
neighbour collectives over NVLink, and global statistics (valley/ridge
standardization, the centring constants) reduced with ``pmean``.
"""

from topo_descriptors_tpu.parallel.mesh import make_mesh, shard_raster
from topo_descriptors_tpu.parallel.halo import exchange_halo, halo_pad_1d
from topo_descriptors_tpu.parallel.sharded import ShardedOps
from topo_descriptors_tpu.parallel.tiles import TiledRunner

__all__ = [
    "make_mesh",
    "shard_raster",
    "exchange_halo",
    "halo_pad_1d",
    "ShardedOps",
    "TiledRunner",
]
