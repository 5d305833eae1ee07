"""Worker for the spawned 2-process multi-host SPMD test (not a test file).

Each process owns 4 virtual CPU devices of a shared (2, 4) mesh, wires up
via explicit-args ``runtime.initialize`` (what every process of a GPU
cluster passes; the reference has no analogue — SURVEY.md §2b N3), assembles the global DEM from
host-local blocks, runs a sharded descriptor, and checks its OWN shards
against the single-chip op.
"""

import os
import sys

proc_id = int(sys.argv[1])
coordinator = sys.argv[2]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from topo_descriptors_tpu import ops  # noqa: E402
from topo_descriptors_tpu.parallel import runtime  # noqa: E402
from topo_descriptors_tpu.parallel.mesh import make_mesh  # noqa: E402
from topo_descriptors_tpu.parallel.sharded import ShardedOps  # noqa: E402

runtime.initialize(
    coordinator_address=coordinator, num_processes=2, process_id=proc_id
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

mesh = make_mesh(shape=(2, 4))
sops = ShardedOps(mesh)

rng = np.random.default_rng(42)  # same seed everywhere; only local blocks used
dem = (1200 + 300 * rng.standard_normal((64, 96))).astype(np.float32)
gy, gx = 2, 4
bh, bw = 64 // gy, 96 // gx
local_devs = [
    d for d in mesh.devices.flat if d.process_index == jax.process_index()
]
blocks = []
for d in local_devs:
    i, j = np.argwhere(mesh.devices == d)[0]
    blocks.append(dem[i * bh : (i + 1) * bh, j * bw : (j + 1) * bw])

garr = runtime.host_local_to_global(mesh, blocks)
out = sops.tpi(garr, 7)
single = np.asarray(jax.jit(lambda x: ops.tpi(x, 7))(jnp.asarray(dem)))
for shard in out.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(shard.data), single[shard.index], rtol=1e-5, atol=2e-2
    )

# global stats ride the DCN-analog path too (pmean collective)
norm, _ = sops.valley_ridge(garr, 7, "valley", (0, 0.2))
vr_single = jax.jit(lambda x: ops.valley_ridge(x, 7, "valley", (0, 0.2)))(
    jnp.asarray(dem)
)
for shard in norm.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(shard.data),
        np.asarray(vr_single[0])[shard.index],
        rtol=1e-4, atol=2e-3,
    )

print(f"proc {proc_id} OK", flush=True)
