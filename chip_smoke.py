"""Smoke run of the terrain-descriptor battery on NVIDIA GPUs.

Drives the main path once through the entry points a user calls, at real
data sizes, and checks the results against the plain scipy/numpy reference
in tests/oracles.py:

    python chip_smoke.py          # phases (a)-(f) on one card
    python chip_smoke.py --four   # the sharded path on 4 cards vs one card

Phases of the default run, all in this one process:

(a) the CLI battery on the reference's Basodino example tile (900 x 1440
    at 30 m) read from NetCDF, every output file read back;
(b) a production-size 8192^2 grid in memory through the pipeline drivers;
(c) the same grid out of core (``--stream 2048``), checked against (b);
(d) the ``gpu``-marked tests (tests/test_gpu.py);
(e) every family against the oracles, at the widths of (a) and (b);
(f) ``memory_analysis()`` of the hand-written kernel at its real widths.

It prints the card's name and power limit, and as its last line one JSON
object ``{"ok": true, "device": {...}}``. When JAX finds no GPU, when
``nvidia-smi`` fails, or when any phase fails it exits non-zero and prints
no result.
"""

import os
import sys

# before JAX is imported: a missing CUDA plugin must fail, not fall back
os.environ["JAX_PLATFORMS"] = "cuda"
os.environ["TOPO_TEST_ON_GPU"] = "1"  # phase (d): tests keep the GPU

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
RES = 30.0
N_BIG = 8192
SCALES = ["100", "300", "500", "1000", "2000", "4000", "6000", "10000"]
AZIMUTHS_36 = [str(a) for a in range(0, 360, 10)]
ROWS_TILE = (400, 416)  # full-width row bands compared against the oracles
ROWS_BIG = (4000, 4008)

# Tolerances against tests/oracles.py, the CPU suite's for each family
# (tests/test_e2e.py): float32 device arithmetic against scipy's float64
# accumulation. rtol is relative to each pixel, atol in the output's unit.
TOL = {
    "tpi": (1e-4, 2e-2),  # m
    # the reference's int32 truncation of the DEM before squaring makes
    # float32 variance cancellation visible
    "std": (2e-3, 5e-1),  # m
    "gradient": (1e-3, 5e-3),
    "sx": (1e-4, 1e-3),  # degrees
    "valley": (1e-3, 5e-3),  # standardized-field units
}
MAX_DIR_MISMATCH = 0.02  # direction share that may differ at near-ties
# --four: valley windows (top-left corner, side) checked against the oracle,
# one where the four blocks of the 2 x 2 mesh meet and one at the field's
# corner, where the halo is the zero boundary
FOUR_WINDOWS = ((N_BIG // 2 - 16, N_BIG // 2 - 16, 32), (0, 0, 32))


def log(msg):
    print(msg, flush=True)


def compare(name, out, ref, tol_key, factor=1):
    """Print and check one family's errors against its reference; with
    ``factor`` 2 the reference is a second approximation, each within the
    family's tolerance of the exact result."""
    rtol, atol = (factor * t for t in TOL[tol_key])
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    keep = np.isfinite(ref)
    assert np.array_equal(np.isfinite(out), keep), name
    err = np.abs(out - ref)[keep]
    scale = np.abs(ref[keep]).max()
    big = np.abs(ref[keep]) >= 0.01 * scale
    rel = (err[big] / np.abs(ref[keep][big])).max() if scale > 0 else 0.0
    ok = bool(np.all(err <= atol + rtol * np.abs(ref[keep])))
    log(f"  {name}: max abs err {err.max():.3e}, max rel err {rel:.3e} "
        f"(|ref| >= 1% of its max), tol rtol {rtol:g} atol {atol:g}: "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, name


def compare_direction(name, direction, ref_dir, gap, ref_norm):
    """Each angle's response may be off by the norm tolerance, so a winner
    whose margin over the runner-up is under twice that is a near-tie and
    may fall either way; a clear winner may not."""
    rtol, atol = TOL["valley"]
    mismatch = np.asarray(direction) != ref_dir
    clear = mismatch & (gap > 2 * (atol + rtol * ref_norm))
    log(f"  {name}: direction mismatch share {mismatch.mean():.3e}, "
        f"{int(clear.sum())} at clear winners")
    assert mismatch.mean() < MAX_DIR_MISMATCH and not clear.any(), name


def big_raster():
    from topo_descriptors_tpu.grid import Raster, RasterGrid
    from topo_descriptors_tpu.io.synthetic import synthetic_dem

    grid = RasterGrid(
        y=np.arange(N_BIG, dtype=np.float64)[::-1] * RES + 5_100_000.0,
        x=np.arange(N_BIG, dtype=np.float64) * RES + 680_000.0,
        crs="epsg:32632",
    )
    return Raster(data=synthetic_dem(N_BIG, N_BIG, seed=3), grid=grid,
                  name="DEM", units="m")


def phase_a(work):
    """The CLI battery on the Basodino tile, every output read back."""
    from topo_descriptors_tpu import cli
    from topo_descriptors_tpu.io import basodino_like_dem, read_raster, write_raster

    dem_path = work / "DEM.nc"
    write_raster(basodino_like_dem(projected=True), dem_path)
    runs = {
        "battery": ["--descriptors", "dem", "tpi", "std", "gradient",
                    "--scales", *SCALES],
        # the reference script's flat lists and smoothing
        # (examples/compute_topo_descriptors.py)
        "valley": ["--descriptors", "valley", "--scales", "1000", "2000",
                   "--flat-list", "0", "0.2", "0.4", "--smth-factors", "0.5"],
        "ridge": ["--descriptors", "ridge", "--scales", "1000", "2000",
                  "--flat-list", "0", "0.15", "0.3", "--smth-factors", "0.5"],
        "sx500": ["--descriptors", "sx", "--sx-radius", "500"],
        "sx2000": ["--descriptors", "sx", "--sx-radius", "2000"],
        "sweep500": ["--descriptors", "sx", "--sx-radius", "500",
                     "--sx-azimuths", *AZIMUTHS_36],
    }
    for name, args in runs.items():
        t0 = time.perf_counter()
        rc = cli.main(["--dem", str(dem_path), "--outdir",
                       str(work / "a" / name), *args])
        assert rc == 0, (name, rc)
        log(f"  cli {name}: {time.perf_counter() - t0:.2f} s")
    files = sorted((work / "a").rglob("topo_*.nc"))
    # 8 scales x (dem, tpi, std, 4 gradient fields); 2 scales x 2 fields
    # for valley and ridge; 1 + 1 + 36 Sx azimuths
    assert len(files) == 8 * 7 + 2 * 4 + 38, len(files)
    for path in files:
        r = read_raster(path)
        assert r.data.shape == (900, 1440), (path.name, r.data.shape)
        assert np.isfinite(r.data).mean() > 0.99, path.name
    log(f"  read back {len(files)} files")


def phase_b(work, raster):
    """A production-size grid in memory through the pipeline drivers."""
    from topo_descriptors_tpu import pipeline

    out = work / "b"
    for label, fn in [
        ("tpi 2000 m", lambda: pipeline.compute_tpi(raster, [2000], outdir=out)),
        ("std 2000 m", lambda: pipeline.compute_std(raster, [2000], outdir=out)),
        ("sx r=500 m", lambda: pipeline.compute_sx(raster, 0.0, 500.0, outdir=out)),
        ("sx r=2000 m", lambda: pipeline.compute_sx(raster, 0.0, 2000.0,
                                                    outdir=out)),
    ]:
        t0 = time.perf_counter()
        fn()
        log(f"  {label}: {time.perf_counter() - t0:.2f} s (NetCDF write included)")


def phase_c(work, raster):
    """The same grid out of core, checked against the outputs of (b).

    Windowed ingest, banded compute and banded writes."""
    from topo_descriptors_tpu import cli
    from topo_descriptors_tpu.io import read_raster, write_raster

    dem_path = work / "DEM_8192.nc"
    write_raster(raster, dem_path)
    t0 = time.perf_counter()
    rc = cli.main(["--dem", str(dem_path), "--stream", "2048", "--outdir",
                   str(work / "c"), "--descriptors", "tpi", "std", "sx",
                   "--scales", "2000", "--sx-radius", "2000"])
    assert rc == 0, rc
    log(f"  --stream 2048 (tpi+std 2000 m, sx r=2000 m): "
        f"{time.perf_counter() - t0:.2f} s")
    for name, key in [("TPI_2000M", "tpi"), ("STD_2000M", "std"),
                      ("SX_RADIUS2000_AZIMUTH0", "sx")]:
        streamed = read_raster(work / "c" / f"topo_{name}.nc").data
        resident = read_raster(work / "b" / f"topo_{name}.nc").data
        compare(f"streamed vs resident {name}", streamed, resident, key)


def phase_d():
    """The gpu-marked tests, in this process (one process per card)."""
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests")])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


def phase_e(work, tile_raster, raster):
    """Every family against tests/oracles.py at the widths of (a) and (b)."""
    from scipy import ndimage

    sys.path.insert(0, str(ROOT / "tests"))
    import oracles as orc

    from topo_descriptors_tpu.geo import round_up_to_odd, scale_to_pixel
    from topo_descriptors_tpu.io import read_raster
    from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets
    from topo_descriptors_tpu.kernels.valley import rotated_extent

    def load(run, name):
        return read_raster(work / run / f"topo_{name}.nc").data

    def size(meters):
        return int(round_up_to_odd(meters / RES))

    def sx_geometry(r, azimuth, radius):  # as pipeline.sx derives it
        _, res = scale_to_pixel(radius, r)
        return sx_offsets(azimuth, radius, float(res["x"].mean()),
                          float(res["y"].mean()))

    a = work / "a"
    tile = tile_raster.data
    log(f" Basodino tile {tile.shape} (files of phase a):")
    for m in (500, 2000):
        compare(f"TPI {m} m", load(a / "battery", f"TPI_{m}M"),
                orc._tpi_oracle(tile, size(m)), "tpi")
    compare("STD 2000 m", load(a / "battery", "STD_2000M"),
            orc._std_oracle(tile, size(2000)), "std")
    _, res = scale_to_pixel([1000], tile_raster)
    refs = orc._gradient_oracle(tile, size(1000) / 4.0, res)
    for name, ref in zip(["WE_DERIVATIVE", "SN_DERIVATIVE", "SLOPE"], refs):
        compare(f"{name} 1000 m", load(a / "battery", f"{name}_1000M_SIGRATIO1"),
                ref, "gradient")

    band = slice(*ROWS_TILE)
    for run, radius, az in [("sx500", 500.0, 0.0), ("sx2000", 2000.0, 0.0),
                            ("sweep500", 500.0, 90.0)]:
        o, d, b = sx_geometry(tile_raster, az, radius)
        ref = orc._rows_oracle(orc._sx_oracle, tile, *ROWS_TILE, b, o, d, b, 10.0)
        name = f"SX_RADIUS{int(radius)}_AZIMUTH{int(az)}"
        compare(f"{name} rows {ROWS_TILE}", load(a / run, name)[band], ref, "sx")

    for mode, flats in [("valley", [0, 0.2, 0.4]), ("ridge", [0, 0.15, 0.3])]:
        sigma = 0.5 * size(2000) / 4.0
        smooth = ndimage.gaussian_filter(tile, sigma)
        margin = max(rotated_extent(size(2000))) // 2 + int(4 * sigma + 2)
        ref_n, ref_d, gap = orc._rows_oracle(
            orc._valley_ridge_oracle, tile, *ROWS_TILE, margin, size(2000),
            mode, flats, sigma=sigma, stats=(smooth.mean(), smooth.std()),
            with_gap=True,
        )
        up = mode.upper()
        compare(f"{up}_NORM 2000 m rows {ROWS_TILE}",
                load(a / mode, f"{up}_NORM_2000M_SMTHFACT0.5")[band], ref_n,
                "valley")
        compare_direction(f"{up}_DIR 2000 m rows {ROWS_TILE}",
                          load(a / mode, f"{up}_DIR_2000M_SMTHFACT0.5")[band],
                          ref_d, gap, ref_n)

    log(f" {N_BIG}^2 grid, rows {ROWS_BIG} (files of phase b):")
    big = raster.data
    rows = slice(*ROWS_BIG)
    k = size(2000)
    compare("TPI 2000 m", load(work / "b", "TPI_2000M")[rows],
            orc._rows_oracle(orc._tpi_oracle, big, *ROWS_BIG, k, k), "tpi")
    compare("STD 2000 m", load(work / "b", "STD_2000M")[rows],
            orc._rows_oracle(orc._std_oracle, big, *ROWS_BIG, k, k), "std")
    for radius in (500.0, 2000.0):
        o, d, b = sx_geometry(raster, 0.0, radius)
        name = f"SX_RADIUS{int(radius)}_AZIMUTH0"
        compare(name, load(work / "b", name)[rows],
                orc._rows_oracle(orc._sx_oracle, big, *ROWS_BIG, b, o, d, b,
                                 10.0), "sx")


def phase_f(tile_raster, raster):
    """Compiled-kernel facts of the Sx kernel at its real widths."""
    import jax

    from topo_descriptors_tpu.kernels.sx_geometry import (
        sx_sweep_dedupe,
        sx_sweep_offsets,
    )
    from topo_descriptors_tpu.ops.pallas.sx_gpu import sx_max_ratio

    for label, dem, azimuths, radius in [
        (f"{N_BIG}^2, r=2000 m, 1 azimuth", raster.data, [0.0], 2000.0),
        ("Basodino tile, r=500 m, 36 azimuths", tile_raster.data,
         range(0, 360, 10), 500.0),
    ]:
        o, d, b = sx_sweep_offsets(list(azimuths), radius, RES, RES)
        o, d = sx_sweep_dedupe(o, d)
        compiled = jax.jit(
            lambda x: sx_max_ratio(x, o, d, b)
        ).lower(dem).compile()
        log(f"  sx_fan kernel, {label}: {compiled.memory_analysis()}")


def run_four():
    """ShardedOps over 4 cards (2 x 2 mesh) against the same ops on one."""
    import jax

    from topo_descriptors_tpu import ops
    from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets
    from topo_descriptors_tpu.parallel import ShardedOps, make_mesh

    assert len(jax.devices()) == 4, jax.devices()
    mesh = make_mesh()
    log(f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")
    sops = ShardedOps(mesh)
    dem = big_raster().data
    sharded = sops.put(dem)
    single = jax.device_put(dem, jax.devices()[0])
    k = 67  # 2000 m at 30 m
    res = {"x": np.float32(RES), "y": np.full(N_BIG, -RES, np.float32)}
    o, d, b = sx_offsets(0.0, 2000.0, RES, RES)
    assert b > 0 and N_BIG // 2 > b
    flats = (0, 0.15, 0.3)
    cases = [
        ("TPI 2000 m", "tpi", lambda x: sops.tpi(x, k),
         jax.jit(lambda x: ops.tpi(x, k))),
        ("STD 2000 m", "std", lambda x: sops.std(x, k),
         jax.jit(lambda x: ops.std(x, k))),
        ("slope 1000 m", "gradient",
         lambda x: sops.gradient(x, 33 / 4.0, res, 1.0)[2],
         jax.jit(lambda x: ops.gradient(x, 33 / 4.0, res, 1.0)[2])),
        ("Sx r=2000 m", "sx", lambda x: sops.sx(x, o, d, b),
         jax.jit(lambda x: ops.sx(x, o, d, b))),
        # one card through the XLA FFT engine, the mesh's own: at 8192^2
        # the matmul-DFT engine that auto picks takes about a minute
        ("valley 2 km", "valley",
         lambda x: sops.valley_ridge(x, k, "valley", flats),
         lambda x: ops.valley_ridge(x, k, "valley", flats, method="fft")),
    ]
    for label, key, fn_sharded, fn_single in cases:
        t0 = time.perf_counter()
        out_s = jax.block_until_ready(fn_sharded(sharded))
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_1 = jax.block_until_ready(fn_single(single))
        t_1 = time.perf_counter() - t0
        log(f" {label}: 4 cards {t_s:.2f} s, 1 card {t_1:.2f} s "
            "(first calls, compilation included)")
        if key == "valley":
            check_valley_four(label, dem, k, flats, out_s, out_1)
        else:
            compare(label, out_s, out_1, key)
        del out_s, out_1


def check_valley_four(label, dem, size, flats, out_s, out_1):
    """The mesh's and the one card's valley index, each against the oracle
    on FOUR_WINDOWS at the per-pixel tolerance of phase (e); then the two
    against each other over the whole field at twice that tolerance."""
    sys.path.insert(0, str(ROOT / "tests"))
    import oracles as orc

    from topo_descriptors_tpu.kernels.valley import rotated_extent

    norm_s, dir_s = np.asarray(out_s[0]), np.asarray(out_s[1])
    norm_1, dir_1 = np.asarray(out_1[0]), np.asarray(out_1[1])
    reach = max(rotated_extent(size)) // 2 + 1
    field = dem.astype(np.float64)
    stats = (field.mean(), field.std())
    for r0, c0, n in FOUR_WINDOWS:
        ys = slice(max(0, r0 - reach), min(N_BIG, r0 + n + reach))
        xs = slice(max(0, c0 - reach), min(N_BIG, c0 + n + reach))
        ref_n, ref_d, gap = (
            o[r0 - ys.start:r0 - ys.start + n, c0 - xs.start:c0 - xs.start + n]
            for o in orc._valley_ridge_oracle(
                dem[ys, xs], size, "valley", flats, stats=stats,
                with_gap=True,
            )
        )
        win = (slice(r0, r0 + n), slice(c0, c0 + n))
        for who, norm, direction in [("4 cards", norm_s, dir_s),
                                     ("1 card", norm_1, dir_1)]:
            name = f"{label} {who} vs oracle, {n}^2 window at ({r0}, {c0})"
            compare(f"{name} norm", norm[win], ref_n, "valley")
            compare_direction(f"{name} dir", direction[win], ref_d, gap, ref_n)
    mismatch = dir_s != dir_1
    log(f"  {label} 4 cards vs 1 card: direction mismatch share "
        f"{mismatch.mean():.3e} over the field")
    compare(f"{label} 4 cards vs 1 card norm", norm_s, norm_1, "valley", 2)
    assert mismatch.mean() < MAX_DIR_MISMATCH, label


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded path on 4 cards")
    args = parser.parse_args()

    import jax

    devices = jax.devices()
    dev = devices[0]
    assert dev.platform == "gpu", f"JAX found {dev.platform}, not a GPU"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)

    import topo_descriptors_tpu
    from topo_descriptors_tpu.config import ensure_compilation_cache

    package = Path(topo_descriptors_tpu.__file__).resolve().parent
    assert package.parent == ROOT, f"package found outside {ROOT}: {package}"
    log(f"compile cache: {ensure_compilation_cache()}")
    log(f"devices: {len(devices)} x {dev.device_kind}")

    if args.four:
        t0 = time.perf_counter()
        run_four()
        log(f"phase four: {time.perf_counter() - t0:.1f} s")
    else:
        from topo_descriptors_tpu.io import basodino_like_dem

        tile = basodino_like_dem(projected=True)
        raster = big_raster()
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            for name, fn, fn_args in [
                ("a", phase_a, (work,)),
                ("b", phase_b, (work, raster)),
                ("c", phase_c, (work, raster)),
                ("d", phase_d, ()),
                ("e", phase_e, (work, tile, raster)),
                ("f", phase_f, (tile, raster)),
            ]:
                log(f"phase {name}: {fn.__doc__.splitlines()[0]}")
                t0 = time.perf_counter()
                fn(*fn_args)
                log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main()
