"""The Sx Pallas kernel (ops/pallas/sx_gpu.py) and the Sx backend routing.

The kernel is compiled through Triton only on the card (``chip_smoke.py``
and the ``gpu``-marked tests); here its body runs in the Pallas
interpreter and must reproduce the XLA scan's max ratio exactly — both
take the same float32 ``fmax`` over the same candidates.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topo_descriptors_tpu import kernels, ops
from topo_descriptors_tpu.ops.pallas import sx_gpu

sxmod = importlib.import_module("topo_descriptors_tpu.ops.sx")

# (azimuths, radius m, radius_min m, what the geometry exercises)
GEOMETRIES = {
    "single_azimuth": ([0.0], 300.0, 0.0),
    "single_azimuth_east": ([90.0], 250.0, 0.0),
    "distance0_quirk": ([225.0, 45.0], 250.0, 0.0),
    "radius_min": ([10.0, 200.0, 355.0], 300.0, 100.0),
    "ragged_4_azimuths": ([0.0, 45.0, 120.0, 290.0], 300.0, 0.0),
    # border 20 px > the 8-row tile: a ray crosses several tiles of halo
    "long_fan_multi_tile_halo": ([30.0, 210.0], 600.0, 0.0),
}


def _tables(name):
    az, radius, radius_min = GEOMETRIES[name]
    o, d, b = kernels.sx_sweep_offsets(az, radius, 30.0, 30.0,
                                       radius_min=radius_min)
    return o, d, b


def _scan(dem, o, d, b):
    return np.asarray(jax.jit(
        lambda x: sxmod._scan_max_ratio(x, o, d, b, 10.0)
    )(dem))


def _assert_same_ratio(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_kernel_matches_scan(dem_tiny, name):
    o, d, b = _tables(name)
    if name == "distance0_quirk":
        assert np.any(d == 0.0), "geometry must hit the distance-0 quirk"
    if name == "radius_min":
        assert np.isnan(d).any()
    o, d = kernels.sx_sweep_dedupe(o, d)
    out = sx_gpu.sx_max_ratio(jnp.asarray(dem_tiny), o, d, b, 10.0,
                              tile=(8, 16), interpret=True)
    _assert_same_ratio(out, _scan(dem_tiny, o, d, b))


@pytest.mark.parametrize("tile", [(8, 16), (16, 32), (32, 128)])
def test_kernel_tile_shapes(dem_tiny, tile):
    # ragged grids: 40 x 48 divides none of these tiles in both dims
    o, d, b = _tables("ragged_4_azimuths")
    out = sx_gpu.sx_max_ratio(jnp.asarray(dem_tiny), o, d, b, 10.0,
                              tile=tile, interpret=True)
    _assert_same_ratio(out, _scan(dem_tiny, o, d, b))


def test_kernel_needs_no_dedupe(dem_tiny):
    # duplicate rays carry identical candidates: raw tables, same result
    o, d, b = _tables("single_azimuth")
    do, dd = kernels.sx_sweep_dedupe(o, d)
    assert do.shape[1] < o.shape[1]
    raw = sx_gpu.sx_max_ratio(jnp.asarray(dem_tiny), o, d, b, 10.0,
                              tile=(16, 32), interpret=True)
    dedup = sx_gpu.sx_max_ratio(jnp.asarray(dem_tiny), do, dd, b, 10.0,
                                tile=(16, 32), interpret=True)
    _assert_same_ratio(raw, dedup)


@pytest.mark.parametrize("shape, expect", [
    ((40, 48), (32, 64)),
    ((900, 1440), (32, 128)),
    ((5, 3), (8, 4)),
])
def test_tile_for_shrinks_to_small_grids(shape, expect):
    assert sx_gpu.tile_for(*shape) == expect


def test_ray_tables_shift_and_pad():
    o, d, b = kernels.sx_sweep_offsets([0.0, 45.0], 300.0, 30.0, 30.0)
    oy, ox, inv = sx_gpu.ray_tables(o, d, b)
    assert oy.dtype == ox.dtype == np.int32 and inv.dtype == np.float32
    np.testing.assert_array_equal(oy, o[..., 0] + b)
    assert oy.min() >= 0 and ox.min() >= 0 and oy.max() <= 2 * b
    # rectangular padding rows: zero offset -> start b, NaN 1/distance
    pad = np.isnan(d) & ~o.any(axis=-1)
    assert pad.any()
    assert np.isnan(inv[pad]).all() and (oy[pad] == b).all()


@pytest.fixture()
def interpret_kernel(monkeypatch):
    """Route ops.sx*/method='pallas' through the interpreted kernel."""
    monkeypatch.setattr(
        sx_gpu, "sx_max_ratio",
        functools.partial(sx_gpu.sx_max_ratio, interpret=True),
    )


@pytest.mark.parametrize("zero_border", [True, False])
@pytest.mark.parametrize("sweep", [False, True])
def test_ops_pallas_route_matches_xla(dem_tiny, interpret_kernel, sweep,
                                      zero_border):
    if sweep:
        o, d, b = _tables("ragged_4_azimuths")
        fn = ops.sx_sweep
    else:
        o, d, b = kernels.sx_offsets(0.0, 300.0, 30.0, 30.0)
        fn = ops.sx
    ref = np.asarray(fn(jnp.asarray(dem_tiny), o, d, b, method="xla",
                        zero_border=zero_border))
    out = np.asarray(fn(jnp.asarray(dem_tiny), o, d, b, method="pallas",
                        zero_border=zero_border))
    np.testing.assert_array_equal(out, ref)
    if zero_border:
        assert (ref[..., :b, :] == 0).all()
    else:  # the tiled path masks at the global frame instead
        assert not (ref[..., :b, :] == 0).all()


@pytest.mark.parametrize("method, platform, expect", [
    ("auto", "gpu", "pallas"),
    ("auto", "cpu", "xla"),
    ("xla", "gpu", "xla"),
    ("pallas", "cpu", "pallas"),
])
def test_sx_backend_routing(monkeypatch, method, platform, expect):
    monkeypatch.setattr(sxmod.jax, "default_backend", lambda: platform)
    assert sxmod.sx_backend(method) == expect


def test_sx_backend_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown Sx method"):
        sxmod.sx_backend("pallas_fan")


def test_auto_on_gpu_takes_the_kernel(dem_tiny, monkeypatch):
    calls = []
    real = sx_gpu.sx_max_ratio

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, interpret=True, **kwargs)

    monkeypatch.setattr(sx_gpu, "sx_max_ratio", spy)
    monkeypatch.setattr(sxmod.jax, "default_backend", lambda: "gpu")
    o, d, b = kernels.sx_offsets(0.0, 300.0, 30.0, 30.0)
    out = np.asarray(ops.sx(jnp.asarray(dem_tiny), o, d, b))
    assert len(calls) == 1 and calls[0][0] == 1  # one azimuth, one call
    ref = np.asarray(ops.sx(jnp.asarray(dem_tiny), o, d, b, method="xla"))
    np.testing.assert_array_equal(out, ref)
