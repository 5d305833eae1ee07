"""Multi-device parity: sharded shard_map ops vs single-chip ops.

Runs on an 8-virtual-CPU-device ('gy','gx') mesh (conftest sets
--xla_force_host_platform_device_count=8), exercising halo exchange
(including multi-hop), boundary fills, and global-stat collectives. Results
must match the single-chip jit ops to float32 round-off.
"""

import jax
import numpy as np
import pytest

from topo_descriptors_tpu import kernels, ops
from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets
from topo_descriptors_tpu.parallel.mesh import make_mesh
from topo_descriptors_tpu.parallel.sharded import ShardedOps


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "tests need 8 virtual devices"
    return make_mesh(shape=(2, 4), devices=jax.devices()[:8])


@pytest.fixture(scope="module")
def sops(mesh):
    return ShardedOps(mesh)


@pytest.fixture(scope="module")
def dem64():
    # owns its rng (conftest NOTE): a shared session rng makes the content
    # depend on which tests ran before, turning marginal tolerance checks
    # flaky under subset selection
    from scipy import ndimage

    noise = np.random.default_rng(44).standard_normal((64, 96))
    smooth = ndimage.gaussian_filter(noise, 5.0)
    return (1400.0 + 800.0 * smooth / np.abs(smooth).max()).astype(np.float32)


def test_sharded_gaussian(sops, dem64):
    single = np.asarray(jax.jit(lambda x: ops.gaussian_filter(x, 2.5))(dem64))
    shard = np.asarray(sops.gaussian(sops.put(dem64), 2.5))
    np.testing.assert_allclose(shard, single, rtol=1e-6, atol=1e-3)


def test_sharded_gaussian_halo_wider_than_block(sops, dem64):
    # sigma 6 -> radius 24 vs block height 32: halo close to block size
    single = np.asarray(jax.jit(lambda x: ops.gaussian_filter(x, 6.0))(dem64))
    shard = np.asarray(sops.gaussian(sops.put(dem64), 6.0))
    np.testing.assert_allclose(shard, single, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("size,sigma", [(7, None), (15, 1.75)])
def test_sharded_tpi(sops, dem64, size, sigma):
    single = np.asarray(jax.jit(lambda x: ops.tpi(x, size, sigma))(dem64))
    shard = np.asarray(sops.tpi(sops.put(dem64), size, sigma))
    np.testing.assert_allclose(shard, single, rtol=1e-5, atol=2e-2)


@pytest.mark.parametrize("size", [7, 15])
def test_sharded_std(sops, dem64, size):
    single = np.asarray(jax.jit(lambda x: ops.std(x, size))(dem64))
    shard = np.asarray(sops.std(sops.put(dem64), size))
    np.testing.assert_allclose(shard, single, rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("sigma,ratio", [(0.5, 1.0), (2.25, 1.0), (2.0, 1.5)])
def test_sharded_gradient(sops, dem64, sigma, ratio):
    ny, nx = dem64.shape
    res = {
        "x": np.full(nx, 30.0, np.float32),
        "y": np.full(ny, -30.0, np.float32),
    }
    single = jax.jit(lambda x: ops.gradient(x, sigma, res, ratio))(dem64)
    shard = sops.gradient(sops.put(dem64), sigma, res, ratio)
    for s, sh in zip(single, shard):
        np.testing.assert_allclose(
            np.asarray(sh), np.asarray(s), rtol=1e-3, atol=2e-2
        )


def test_sharded_valley_ridge(sops, dem64):
    single = jax.jit(
        lambda x: ops.valley_ridge(x, 7, "valley", (0, 0.2))
    )(dem64)
    shard = sops.valley_ridge(sops.put(dem64), 7, "valley", (0, 0.2))
    np.testing.assert_allclose(
        np.asarray(shard[0]), np.asarray(single[0]), rtol=1e-4, atol=2e-3
    )
    # direction ties can flip at float round-off; require near-total agreement
    assert (np.asarray(shard[1]) != np.asarray(single[1])).mean() < 0.02


def test_sharded_valley_ridge_streamed(sops, dem64):
    """Mesh-resident streamed valley/ridge (on-device rotation + VALID
    matmul-DFT convs on halo-extended blocks) vs the single-chip streamed
    op — the bank>budget path that round 3 fell back to one chip for.
    Size 15's rotated extent (21) exceeds the 32x24 blocks, so the halo
    exchange is multi-hop."""
    single = ops.valley_ridge_streamed(
        jax.numpy.asarray(dem64), 15, "valley", (0, 0.2)
    )
    shard = sops.valley_ridge_streamed(sops.put(dem64), 15, "valley", (0, 0.2))
    np.testing.assert_allclose(
        np.asarray(shard[0]), np.asarray(single[0]), rtol=1e-4, atol=2e-3
    )
    assert (np.asarray(shard[1]) != np.asarray(single[1])).mean() < 0.02


def test_sharded_valley_ridge_streamed_ragged_smoothed(mesh, sops):
    """Ragged grid + pre-smoothing through the sharded streamed path."""
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(5)
    from scipy import ndimage

    dem = (
        1200.0
        + 500.0 * ndimage.gaussian_filter(rng.standard_normal((62, 93)), 4.0)
    ).astype(np.float32)
    single = ops.valley_ridge_streamed(
        jax.numpy.asarray(dem), 9, "ridge", (0, 0.2), sigma=1.5
    )
    padded, _ = pad_to_mesh(dem, mesh, fill=0.0)
    shard = sops.valley_ridge_streamed(
        sops.put(padded), 9, "ridge", (0, 0.2), sigma=1.5,
        valid_shape=dem.shape,
    )
    np.testing.assert_allclose(
        np.asarray(shard[0])[: dem.shape[0], : dem.shape[1]],
        np.asarray(single[0]),
        rtol=1e-4,
        atol=2e-3,
    )


def test_sharded_sx_single_hop_wide_halo(sops, dem64):
    # border 20 px vs block 32x24: halo is most of a block but still one
    # ppermute hop per side (the k>=2 multi-hop path needs halo > block;
    # see test_sharded_sx_multihop_halo below for that)
    offsets, distances, border = sx_offsets(30.0, 600.0, 30.0, 30.0)
    single = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border))(dem64)
    )
    shard = np.asarray(sops.sx(sops.put(dem64), offsets, distances, border))
    np.testing.assert_allclose(shard, single, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def sops81():
    # 8x1 mesh: 8-row blocks on dem64 make any halo > 8 genuinely multi-hop
    assert len(jax.devices()) >= 8, "tests need 8 virtual devices"
    return ShardedOps(make_mesh(shape=(8, 1), devices=jax.devices()[:8]))


def test_sharded_sx_multihop_halo(sops81, dem64):
    # border 20 px vs block height 8: the lo/hi halos need ceil(20/8) = 3
    # ppermute hops (halo.py side_chunks k = 1..3). Same float32 reduction
    # order as the single-chip scan -> bit-exact, not just allclose.
    offsets, distances, border = sx_offsets(30.0, 600.0, 30.0, 30.0)
    assert border > 2 * dem64.shape[0] // 8, "geometry must need >= 3 hops"
    single = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border))(dem64)
    )
    shard = np.asarray(sops81.sx(sops81.put(dem64), offsets, distances, border))
    np.testing.assert_array_equal(shard, single)


def test_sharded_gaussian_multihop_reflect(sops81, dem64):
    # sigma 6 -> tap radius 24 vs block height 8: the reflect fill must
    # gather 3 hops of neighbour data and reflect the true domain edge
    # (halo.py _reflect_oob), matching scipy.ndimage 'reflect' semantics
    single = np.asarray(jax.jit(lambda x: ops.gaussian_filter(x, 6.0))(dem64))
    shard = np.asarray(sops81.gaussian(sops81.put(dem64), 6.0))
    np.testing.assert_allclose(shard, single, rtol=1e-6, atol=1e-3)


def test_sharded_gaussian_reflect_too_wide_raises(sops81, dem64):
    # tap radius > block + opposite halo is unreachable; radius >= domain is
    # the genuinely impossible case and must fail loudly at the driver level
    with pytest.raises(Exception, match="reflect halo"):
        np.asarray(sops81.gaussian(sops81.put(dem64), 20.0))


def test_sharded_tpi_ragged_grid(mesh, sops):
    # a (63, 97) grid does not divide the (2, 4) mesh; zero pad_to_mesh +
    # crop is exact for the plain disk conv (pad pixel == zero boundary)
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(7)
    dem = (1200 + 300 * rng.standard_normal((63, 97))).astype(np.float32)
    single = np.asarray(jax.jit(lambda x: ops.tpi(x, 7))(dem))
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    shard = np.asarray(sops.tpi(sops.put(padded), 7))[:h, :w]
    np.testing.assert_allclose(shard, single, rtol=1e-5, atol=2e-2)


def test_sharded_sx_ragged_grid(mesh, sops):
    # NaN pad pixels are fmax-skipped like beyond-edge halo fill; the zero
    # border is masked at the original frame via valid_shape
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(8)
    dem = (1200 + 300 * rng.standard_normal((61, 95))).astype(np.float32)
    offsets, distances, border = sx_offsets(45.0, 300.0, 30.0, 30.0)
    single = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border))(dem)
    )
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=np.nan)
    shard = np.asarray(
        sops.sx(sops.put(padded), offsets, distances, border,
                valid_shape=(h, w))
    )[:h, :w]
    np.testing.assert_array_equal(shard, single)


def test_sharded_valley_ridge_ragged_grid(mesh, sops):
    # masked-psum standardization + post-standardize zeroing of pad pixels
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(9)
    dem = (1200 + 300 * rng.standard_normal((63, 94))).astype(np.float32)
    single = jax.jit(lambda x: ops.valley_ridge(x, 7, "valley", (0, 0.2)))(dem)
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    shard = sops.valley_ridge(
        sops.put(padded), 7, "valley", (0, 0.2), valid_shape=(h, w)
    )
    np.testing.assert_allclose(
        np.asarray(shard[0])[:h, :w], np.asarray(single[0]),
        rtol=1e-4, atol=2e-3,
    )
    assert (
        np.asarray(shard[1])[:h, :w] != np.asarray(single[1])
    ).mean() < 0.02


def test_pipeline_ragged_sharded_drivers(mesh, sops, tmp_path):
    # end-to-end: the drivers pad, compute, and crop transparently
    from topo_descriptors_tpu import pipeline
    from topo_descriptors_tpu.io.netcdf import read_raster
    from topo_descriptors_tpu.io.synthetic import basodino_like_dem

    raster = basodino_like_dem(61, 94, seed=11)  # 30 m grid; 200 m -> size 7
    single = np.asarray(
        jax.jit(lambda x: ops.tpi(x, 7))(raster.data.astype(np.float32))
    )
    paths = pipeline.compute_tpi(raster, 200, outdir=tmp_path, sharded=sops)
    out = read_raster(paths[0])
    assert out.data.shape == raster.data.shape
    np.testing.assert_allclose(out.data, single, rtol=1e-5, atol=2e-2)

    # gaussian smoothing on a ragged grid: true-edge reflect keeps parity
    single_dem = np.asarray(
        jax.jit(lambda x: ops.gaussian_filter(x, 7 / 4))(
            raster.data.astype(np.float32)
        )
    )
    paths = pipeline.compute_dem(raster, 200, outdir=tmp_path, sharded=sops)
    out = read_raster(paths[0])
    np.testing.assert_allclose(out.data, single_dem, rtol=1e-6, atol=1e-3)


def test_sharded_sx_small_radius(sops, dem64):
    offsets, distances, border = sx_offsets(120.0, 200.0, 30.0, 30.0)
    single = np.asarray(
        jax.jit(lambda x: ops.sx(x, offsets, distances, border))(dem64)
    )
    shard = np.asarray(sops.sx(sops.put(dem64), offsets, distances, border))
    np.testing.assert_allclose(shard, single, rtol=1e-4, atol=1e-3)


def test_mesh_shape_validation(sops, dem64):
    with pytest.raises(ValueError):
        sops.put(np.zeros((63, 96), np.float32))


def test_host_local_to_global(mesh, sops, dem64):
    # single-process: all mesh devices are local; assemble the global array
    # from per-device blocks and check it matches a plain device_put
    from topo_descriptors_tpu.parallel import runtime

    gy, gx = mesh.devices.shape
    bh, bw = dem64.shape[0] // gy, dem64.shape[1] // gx
    blocks = [
        dem64[i * bh : (i + 1) * bh, j * bw : (j + 1) * bw]
        for i in range(gy)
        for j in range(gx)
    ]
    global_arr = runtime.host_local_to_global(mesh, blocks)
    np.testing.assert_array_equal(np.asarray(global_arr), dem64)
    # and it is directly consumable by the sharded ops
    out = np.asarray(sops.tpi(global_arr, 7))
    ref = np.asarray(sops.tpi(sops.put(dem64), 7))
    np.testing.assert_array_equal(out, ref)


def test_runtime_initialize_single_process():
    from topo_descriptors_tpu.parallel import runtime

    runtime.initialize()  # must be a safe no-op without a coordinator
    runtime.initialize()  # idempotent


def test_sharded_sx_sweep(sops, dem64):
    # whole fan in one shard_map program: the ray halo is exchanged once and
    # shared by every azimuth; same scan order as single-chip -> bit-exact
    from topo_descriptors_tpu.kernels.sx_geometry import sx_sweep_offsets

    o, d, b = sx_sweep_offsets([0.0, 90.0, 225.0], 300.0, 30.0, 30.0)
    single = np.asarray(
        jax.jit(lambda x: ops.sx_sweep(x, o, d, b, method="xla"))(dem64)
    )
    shard = np.asarray(sops.sx_sweep(sops.put(dem64), o, d, b))
    np.testing.assert_array_equal(shard, single)


def test_sharded_sx_sweep_ragged_multihop(sops81, dem64):
    # ragged fan table (NaN pad rows) + multi-hop halo (border 20 > block 8)
    from topo_descriptors_tpu.kernels.sx_geometry import sx_sweep_offsets

    o, d, b = sx_sweep_offsets([30.0, 210.0], 600.0, 30.0, 30.0)
    assert b > 8
    single = np.asarray(
        jax.jit(lambda x: ops.sx_sweep(x, o, d, b, method="xla"))(dem64)
    )
    shard = np.asarray(sops81.sx_sweep(sops81.put(dem64), o, d, b))
    np.testing.assert_array_equal(shard, single)


def test_pipeline_sx_sweep_sharded_ragged(mesh, sops, tmp_path):
    from topo_descriptors_tpu import pipeline
    from topo_descriptors_tpu.io.netcdf import read_raster
    from topo_descriptors_tpu.io.synthetic import basodino_like_dem

    raster = basodino_like_dem(61, 94, seed=13)
    single = pipeline.compute_sx_sweep(
        raster, [0.0, 90.0], 300.0, outdir=tmp_path / "single"
    )
    shard = pipeline.compute_sx_sweep(
        raster, [0.0, 90.0], 300.0, outdir=tmp_path / "shard", sharded=sops
    )
    for p_single, p_shard in zip(single, shard):
        a = read_raster(p_single)
        b_ = read_raster(p_shard)
        np.testing.assert_array_equal(b_.data, a.data)


def test_sharded_tpi_ragged_with_smoothing(mesh, sops):
    # smth_factors=1 TPI on a (63, 97) grid over the 2x4
    # mesh — the pre-smooth reflects at the true edge, the centring constant
    # and counts come from the true domain only
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(12)
    dem = (1200 + 300 * rng.standard_normal((63, 97))).astype(np.float32)
    single = np.asarray(jax.jit(lambda x: ops.tpi(x, 7, 1.75))(dem))
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    shard = np.asarray(
        sops.tpi(sops.put(padded), 7, 1.75, valid_shape=(h, w))
    )[:h, :w]
    np.testing.assert_allclose(shard, single, rtol=1e-5, atol=2e-2)


def test_sharded_std_ragged_with_smoothing(mesh, sops):
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(13)
    dem = (1200 + 300 * rng.standard_normal((63, 97))).astype(np.float32)
    single = np.asarray(jax.jit(lambda x: ops.std(x, 7, 1.75))(dem))
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    shard = np.asarray(
        sops.std(sops.put(padded), 7, 1.75, valid_shape=(h, w))
    )[:h, :w]
    # rtol/atol as in test_sharded_std: the int32-trunc quirk amplifies
    # 1-ulp smoothing differences at integer boundaries
    np.testing.assert_allclose(shard, single, rtol=1e-3, atol=5e-2)


def test_sharded_gradient_ragged(mesh, sops):
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(14)
    dem = (1200 + 300 * rng.standard_normal((63, 94))).astype(np.float32)
    res = {
        "x": np.full(94, 30.0, np.float32),
        "y": np.full(63, -30.0, np.float32),
    }
    single = jax.jit(lambda x: ops.gradient(x, 2.0, res, 1.0))(dem)
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    shard = sops.gradient(sops.put(padded), 2.0, res, 1.0, valid_shape=(h, w))
    for s, o in zip(shard, single):
        np.testing.assert_allclose(
            np.asarray(s)[:h, :w], np.asarray(o), rtol=1e-4, atol=1e-3
        )


def test_sharded_gradient_ragged_sobel(mesh, sops):
    # sigma <= 1 routes through the Sobel path: reflect at the true edge
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(15)
    dem = (1200 + 300 * rng.standard_normal((63, 94))).astype(np.float32)
    res = {
        "x": np.full(94, 30.0, np.float32),
        "y": np.full(63, -30.0, np.float32),
    }
    single = jax.jit(lambda x: ops.gradient(x, 0.75, res, 1.0))(dem)
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    shard = sops.gradient(sops.put(padded), 0.75, res, 1.0, valid_shape=(h, w))
    for s, o in zip(shard, single):
        np.testing.assert_allclose(
            np.asarray(s)[:h, :w], np.asarray(o), rtol=1e-4, atol=1e-3
        )


def test_sharded_valley_ridge_ragged_with_smoothing(mesh, sops):
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(16)
    dem = (1200 + 300 * rng.standard_normal((63, 94))).astype(np.float32)
    single = jax.jit(
        lambda x: ops.valley_ridge(x, 7, "valley", (0, 0.2), sigma=1.5)
    )(dem)
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    shard = sops.valley_ridge(
        sops.put(padded), 7, "valley", (0, 0.2), sigma=1.5, valid_shape=(h, w)
    )
    np.testing.assert_allclose(
        np.asarray(shard[0])[:h, :w], np.asarray(single[0]),
        rtol=1e-4, atol=2e-3,
    )


@pytest.mark.parametrize("sigma", [None, 1.75])
def test_sharded_disk_descriptors_fused(sops, dem64, sigma):
    sizes = (7, 15, 23)
    batch = sops.disk_descriptors(sops.put(dem64), sizes, sigma)
    for j, size in enumerate(sizes):
        tpi1 = np.asarray(jax.jit(lambda x: ops.tpi(x, size, sigma))(dem64))
        std1 = np.asarray(jax.jit(lambda x: ops.std(x, size, sigma))(dem64))
        np.testing.assert_allclose(
            np.asarray(batch["tpi"][j]), tpi1, rtol=1e-5, atol=2e-2
        )
        # same atol as test_sharded_std: the int32-truncation quirk's
        # cancellation leaves the fused STD a touch more f32 noise
        np.testing.assert_allclose(
            np.asarray(batch["std"][j]), std1, rtol=1e-4, atol=5e-2
        )


def test_sharded_disk_descriptors_fused_ragged(mesh, sops):
    from topo_descriptors_tpu.parallel.mesh import pad_to_mesh

    rng = np.random.default_rng(17)
    dem = (1200 + 300 * rng.standard_normal((63, 97))).astype(np.float32)
    padded, (h, w) = pad_to_mesh(dem, mesh, fill=0.0)
    batch = sops.disk_descriptors(
        sops.put(padded), (7, 15), 1.75, valid_shape=(h, w)
    )
    for j, size in enumerate((7, 15)):
        tpi1 = np.asarray(jax.jit(lambda x: ops.tpi(x, size, 1.75))(dem))
        np.testing.assert_allclose(
            np.asarray(batch["tpi"][j])[:h, :w], tpi1, rtol=1e-5, atol=2e-2
        )


def test_pipeline_fused_sharded_tpi_std(mesh, sops, tmp_path):
    # the 12-scale batch use-case: one fused sharded program per smth group
    from topo_descriptors_tpu import pipeline
    from topo_descriptors_tpu.io.netcdf import read_raster
    from topo_descriptors_tpu.io.synthetic import basodino_like_dem

    raster = basodino_like_dem(64, 96, seed=18)
    scales = [200, 500, 700]
    paths = pipeline.compute_tpi_std(
        raster, scales, outdir=tmp_path, sharded=sops
    )
    assert len(paths) == 6
    dem = raster.data.astype(np.float32)
    single = np.asarray(jax.jit(lambda x: ops.std(x, 17))(dem))  # 500 m
    out = read_raster(paths[4])
    np.testing.assert_allclose(out.data, single, rtol=1e-4, atol=2e-2)
