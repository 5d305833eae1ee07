"""Multi-process SPMD runtime initialization.

The reference is single-process (SURVEY.md §2b: no comm backend at all).
One process drives every card of a host: ``make_mesh()`` sees all local
GPUs and the ShardedOps programs move halos over NVLink, so a single-host
run needs no initialization at all. Only when several processes share one
SPMD program (one per host, or one per card) does ``jax.distributed``
have to wire them together, and nothing on a GPU machine tells JAX of the
cluster: every process passes the coordinator address, the process count
and its own id.

Typical launch (one command per process)::

    from topo_descriptors_tpu.parallel import runtime, make_mesh, ShardedOps

    runtime.initialize("host0:12345", num_processes=2, process_id=rank)
    mesh = make_mesh()                # all cards across all processes
    sops = ShardedOps(mesh)
    dem = runtime.host_local_to_global(mesh, local_block)  # per-process shard
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import jax
import numpy as np

logger = logging.getLogger(__name__)

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-process JAX runtime (idempotent).

    With no coordinator (or a single process) there is nothing to
    coordinate and ``jax.distributed`` is not called at all; otherwise all
    three arguments are required.
    """
    global _initialized
    if _initialized or coordinator_address is None or num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    logger.info(
        f"distributed runtime: process {jax.process_index()}/"
        f"{jax.process_count()}, {jax.local_device_count()} local / "
        f"{jax.device_count()} global devices"
    )


def ingest_sharded(reader, mesh, fill: float = 0.0):
    """Windowed ingest straight onto the mesh: read only each local device's
    block and assemble the global sharded DEM without ANY host materializing
    the full mosaic.

    ``reader`` is any window reader (``.shape`` + 2-D contiguous slicing,
    e.g. :class:`~topo_descriptors_tpu.io.windowed.DemWindowReader`). Each
    process walks the mesh rows that contain one of its local devices, reads
    that row-block's columns per device, and ``device_put``s the block —
    peak host memory is ONE device block (plus the reader's row window).
    Grids that don't divide the mesh are padded bottom/right with ``fill``
    per block (the valid-aware sharded ops handle the rest; see
    ``ShardedOps`` valid_shape).

    Returns ``(global_sharded_array, valid_shape)``. This is the multi-host
    ingest path for continental mosaics (SURVEY.md §7 steps 6-7): each host
    opens the same file (or its own region replica) and reads only its
    devices' windows, composing with :func:`initialize` + ``ShardedOps``.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    h, w = reader.shape
    gy, gx = mesh.devices.shape
    bh = -(-h // gy)  # padded block sizes
    bw = -(-w // gx)
    sharding = NamedSharding(mesh, P("gy", "gx"))
    proc = jax.process_index()

    arrays = []
    devices = []
    for i in range(gy):
        row_devs = [
            (j, mesh.devices[i, j])
            for j in range(gx)
            if mesh.devices[i, j].process_index == proc
        ]
        if not row_devs:
            continue
        r0, r1 = i * bh, min((i + 1) * bh, h)
        for j, dev in row_devs:
            c0, c1 = j * bw, min((j + 1) * bw, w)
            block = np.asarray(
                reader[r0:r1, c0:c1], dtype=np.float32
            )
            if block.shape != (bh, bw):
                block = np.pad(
                    block,
                    ((0, bh - block.shape[0]), (0, bw - block.shape[1])),
                    mode="constant",
                    constant_values=fill,
                )
            arrays.append(jax.device_put(block, dev))
            devices.append(dev)
    global_arr = jax.make_array_from_single_device_arrays(
        (gy * bh, gx * bw), sharding, arrays
    )
    return global_arr, (h, w)


def host_local_to_global(mesh, local_blocks: Sequence[np.ndarray]):
    """Assemble a global sharded array from per-host local DEM blocks.

    Each host passes the row-major list of blocks for its *local* devices
    (one 2-D numpy array per local device, all equal shape); the result is
    a single global jax.Array blocked over the ('gy','gx') mesh without any
    host ever materializing the full grid — the multi-host ingest path for
    continental mosaics.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("gy", "gx"))
    local_devices = [d for d in mesh.devices.flat if d.process_index ==
                     jax.process_index()]
    if len(local_blocks) != len(local_devices):
        raise ValueError(
            f"{len(local_blocks)} blocks for {len(local_devices)} local devices"
        )
    gy, gx = mesh.devices.shape
    bh, bw = local_blocks[0].shape
    global_shape = (gy * bh, gx * bw)
    arrays = [
        jax.device_put(block, dev)
        for block, dev in zip(local_blocks, local_devices)
    ]
    return jax.make_array_from_single_device_arrays(
        global_shape, sharding, arrays
    )
