"""Gpix-scale out-of-core execution on one GPU.

Synthesizes a full-Alps-scale DEM (default 32768 x 32768 = 1.07 Gpix,
4.3 GB float32 — the ~SRTM-30m full-Alps footprint from BASELINE.md)
directly to a NetCDF file band-by-band (never holding the grid in RAM),
then streams it through the out-of-core drivers on one card:

    TPI-2000m + STD-2000m (fused one pass) -> gradient-2000m (4 outputs)
    -> Sx-500m az 0

i.e. windowed ingest (io/windowed.DemWindowReader hyperslabs) -> banded
halo-overlapped device compute (parallel/tiles.TiledRunner) -> banded
NetCDF output (io/netcdf.RasterBandWriter), recording wall time, Mpix/s and
peak host RSS per family. This is the composition the whole streaming layer
exists for, executed at the scale it was built for.

Outputs land in --outdir (default ``.gpix/`` in the checkout, listed in
.gitignore); input + 7 outputs ~ 35 GB of disk. Refuses to run when JAX
finds no GPU:

    python bench_gpix.py [--n 32768] [--tile-rows 4096]
"""

import argparse
import os
import resource
import sys
import time

import numpy as np


def synth_band(y0: int, rows: int, nx: int) -> np.ndarray:
    """Deterministic alpine-ish terrain, evaluable per band: smooth
    multi-wavelength sinusoid ridges + short-wavelength roughness."""
    y = (y0 + np.arange(rows, dtype=np.float32))[:, None]
    x = np.arange(nx, dtype=np.float32)[None, :]
    f = (
        1800.0
        + 700.0 * np.sin(2 * np.pi * y / 2900.0) * np.cos(2 * np.pi * x / 2300.0)
        + 400.0 * np.sin(2 * np.pi * (y + x) / 1700.0)
        + 200.0 * np.sin(2 * np.pi * y / 530.0) * np.sin(2 * np.pi * x / 610.0)
        + 60.0 * np.sin(2 * np.pi * (3 * y - 2 * x) / 97.0)
    )
    return f.astype(np.float32)


def rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 2**30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument(
        "--outdir", default=os.path.join(os.path.dirname(__file__), ".gpix")
    )
    ap.add_argument("--tile-rows", type=int, default=4096)
    ap.add_argument("--keep-input", action="store_true")
    args = ap.parse_args()

    import jax

    from topo_descriptors_tpu.config import ensure_compilation_cache

    ensure_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_gpix.py measures a GPU; JAX found {dev.platform}")

    from topo_descriptors_tpu import streaming
    from topo_descriptors_tpu.grid import RasterGrid
    from topo_descriptors_tpu.io.netcdf import RasterBandWriter

    n = args.n
    mpix = n * n / 1e6
    os.makedirs(args.outdir, exist_ok=True)
    dem_path = os.path.join(args.outdir, f"DEM_{n}.nc")
    print(f"device: {dev.device_kind} x {len(jax.devices())}", flush=True)

    # --- synthesize the input, band by band -------------------------------
    if not os.path.exists(dem_path):
        t0 = time.perf_counter()
        grid = RasterGrid(
            y=np.arange(n, dtype=np.float64)[::-1] * 30.0,
            x=np.arange(n, dtype=np.float64) * 30.0,
            crs="epsg:2056",
        )
        with RasterBandWriter(dem_path, grid, "dem", units="m") as w:
            for y0 in range(0, n, 2048):
                rows = min(2048, n - y0)
                w.write_rows(y0, synth_band(y0, rows, n))
        print(
            f"synthesized {n}x{n} ({mpix/1e3:.2f} Gpix, "
            f"{n*n*4/2**30:.1f} GiB) in {time.perf_counter()-t0:.0f} s, "
            f"RSS {rss_gib():.2f} GiB",
            flush=True,
        )

    rows = []

    def run(label, outputs_gb, fn):
        t0 = time.perf_counter()
        files = fn()
        sec = time.perf_counter() - t0
        rows.append((label, sec, mpix / sec, rss_gib()))
        n_files = files if isinstance(files, int) else len(files)
        line = (
            f"{label}: {sec:.0f} s ({mpix/sec:.0f} Mpix/s end-to-end incl. "
            f"disk I/O; {outputs_gb:.1f} GB written), peak RSS "
            f"{rss_gib():.2f} GiB -> {n_files} files"
        )
        print(line, flush=True)

    gb = n * n * 4 / 1e9
    run(
        "TPI-2000m + STD-2000m (fused pass)",
        2 * gb,
        lambda: streaming.compute_tpi_std(
            dem_path, [2000], outdir=args.outdir, tile_rows=args.tile_rows,
            skip_existing=True,
        ),
    )
    run(
        "gradient-2000m (4 outputs)",
        4 * gb,
        lambda: streaming.compute_gradient(
            dem_path, [2000], outdir=args.outdir, tile_rows=args.tile_rows,
            skip_existing=True,
        ),
    )
    run(
        "Sx-500m az 0",
        gb,
        lambda: streaming.compute_sx(
            dem_path, [0.0], 500.0, outdir=args.outdir,
            tile_rows=args.tile_rows, skip_existing=True,
        ),
    )

    total = sum(r[1] for r in rows)
    summary = (
        f"TOTAL {len(rows)} streamed families over {mpix/1e3:.2f} Gpix: "
        f"{total:.0f} s wall, {mpix*len(rows)/total:.0f} Mpix/s aggregate, "
        f"peak host RSS {rss_gib():.2f} GiB (grid itself is "
        f"{n*n*4/2**30:.1f} GiB — never resident)"
    )
    print(summary, flush=True)
    if not args.keep_input:
        os.unlink(dem_path)


if __name__ == "__main__":
    main()
