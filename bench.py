"""Single-GPU benchmark: TPI-2000m and Sx-500m on the Basodino-size tile.

Times each op on a 900 x 1440 SRTM-30m grid (1.30 Mpixel), the reference's
own example tile, and prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "Mpixel/s", "vs_baseline": N,
     "device": {"platform": "gpu", "kind": ..., "count": N}}

Each timing is the median wall time of repeated calls that each end in
``block_until_ready``, after a warm-up call that compiles. ``value`` is the
geometric mean of the two throughputs; ``vs_baseline`` compares it against
the reference's derived CPU numbers (TPI ~1.3 Mpixel/s, Sx ~0.22
Mpixel/s; BASELINE.md). Refuses to run when JAX finds no GPU:

    python bench.py
"""

import json
import sys
import time

import numpy as np


def median_seconds(fn, arg, repeats=50):
    import jax

    jax.block_until_ready(fn(arg))  # compile
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main():
    import jax
    import jax.numpy as jnp

    from topo_descriptors_tpu.config import ensure_compilation_cache

    ensure_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform}")

    from topo_descriptors_tpu import ops
    from topo_descriptors_tpu.geo import round_up_to_odd
    from topo_descriptors_tpu.io.synthetic import basodino_like_dem
    from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets

    dem = jnp.asarray(basodino_like_dem(projected=True).data)
    mpix = dem.size / 1e6

    size = int(round_up_to_odd(2000 / 30.0))
    t_tpi = median_seconds(jax.jit(lambda x: ops.tpi(x, size)), dem)
    offsets, distances, border = sx_offsets(0.0, 500.0, 30.0, 30.0)
    t_sx = median_seconds(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border)), dem
    )
    for label, t in (("TPI-2000m", t_tpi), ("Sx-500m", t_sx)):
        print(f"{label}: {t * 1e3:.3f} ms/tile -> {mpix / t:.0f} Mpixel/s "
              f"on {dev.device_kind}", file=sys.stderr)

    value = float(np.sqrt((mpix / t_tpi) * (mpix / t_sx)))
    baseline = float(np.sqrt(1.3 * 0.22))  # reference CPU numbers, BASELINE.md
    print(json.dumps({
        "metric": "geomean Mpixel/s per GPU (TPI-2000m, Sx-500m, SRTM-30m)",
        "value": round(value, 2),
        "unit": "Mpixel/s",
        "vs_baseline": round(value / baseline, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
