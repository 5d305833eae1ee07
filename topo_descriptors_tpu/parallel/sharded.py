"""Sharded descriptor ops: shard_map wrappers with per-op halo exchange.

Every method of :class:`ShardedOps` computes a full descriptor on a DEM that
lives blocked over the ('gy','gx') mesh, producing bit-equivalent results to
the single-chip ops on valid interiors:

* convolution halos sized by the kernel's 'same' anchor ((k-1-s, s) per axis)
* Gaussian halos of the tap radius with reflect fill at true edges
* np.gradient edges reproduced via linear-extrapolation fill
* global statistics (valley/ridge standardization topo.py:429; the
  float32-stabilizing centring constants) as ``pmean`` collectives
* Sx halos of the full ray length, multi-hop when rays span several blocks

Global shapes must divide the mesh evenly (use ``mesh.pad_to_mesh`` +
cropping at the driver level for ragged grids).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from topo_descriptors_tpu.kernels.disk import circular_kernel
from topo_descriptors_tpu.kernels.gaussian import gaussian_kernel1d, gaussian_radius
from topo_descriptors_tpu.kernels.sobel import sobel_kernel
from topo_descriptors_tpu.ops import conv as C
from topo_descriptors_tpu.ops.valley_ridge import prepare_valley_bank
from topo_descriptors_tpu.parallel.halo import (
    exchange_halo,
    global_index,
    halo_pad_1d,
)
from topo_descriptors_tpu.parallel.mesh import GX, GY

SPATIAL = P(GY, GX)


def _global_mean(x: jax.Array) -> jax.Array:
    """Mean over the full sharded field (uniform blocks -> mean of means)."""
    return jax.lax.pmean(jnp.mean(x), (GY, GX))


def _varying(x: jax.Array) -> jax.Array:
    """Mark a replicated constant as device-varying over the spatial mesh,
    so it can seed a scan carry whose outputs are varying (shard_map's
    varying-manual-axes typing)."""
    return jax.lax.pcast(x, (GY, GX), to="varying")


class ShardedOps:
    """Descriptor suite over a 2-D device mesh.

    Construct once per mesh; methods are jit-compiled shard_map programs
    cached per static-parameter signature. Inputs/outputs are global jax
    arrays carrying a ``NamedSharding(mesh, P('gy','gx'))``.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.gy, self.gx = mesh.devices.shape
        self._cache = {}

    # ------------------------------------------------------------------
    def _spec(self):
        return NamedSharding(self.mesh, SPATIAL)

    def _check(self, shape):
        if shape[0] % self.gy or shape[1] % self.gx:
            raise ValueError(
                f"global shape {shape} must divide mesh "
                f"({self.gy}, {self.gx}); pad with mesh.pad_to_mesh first"
            )

    def _wrap(self, key, builder, n_args: int, n_out: int = 1):
        fn = self._cache.get(key)
        if fn is None:
            local = builder()
            out_specs = SPATIAL if n_out == 1 else tuple([SPATIAL] * n_out)
            fn = jax.jit(
                shard_map(
                    local,
                    mesh=self.mesh,
                    in_specs=tuple([SPATIAL] * n_args),
                    out_specs=out_specs,
                )
            )
            self._cache[key] = fn
        return fn

    def put(self, array) -> jax.Array:
        """Place a global array onto the mesh, spatially blocked."""
        self._check(array.shape)
        return jax.device_put(array, self._spec())

    # ------------------------------------------------------------------
    def _local_gaussian(self, block, sigma, truncate=4.0, valid=None):
        """Per-axis separable Gaussian on a local block: halo-exchange the tap
        radius with reflect fill at the true boundary, then VALID correlate —
        equal to scipy.ndimage.gaussian_filter of the global field.

        ``valid`` (vh, vw) supports ragged grids padded bottom/right with
        ``pad_to_mesh``: the reflection then happens at the *true* domain
        edge — pad positions (and the halo beyond them) are overwritten with
        reflections of in-domain data before correlating, so valid outputs
        equal the unpadded single-chip filter exactly. Requires the pad to
        fit alongside its reflection inside one block (pad <= block/2)."""
        from topo_descriptors_tpu.parallel.halo import _reflect_oob

        sigmas = (sigma, sigma) if np.isscalar(sigma) else tuple(sigma)
        mesh_sizes = (self.gy, self.gx)
        names = (GY, GX)
        h, w = block.shape
        for axis, s in enumerate(sigmas):
            if not s or s <= 0:
                continue
            taps = gaussian_kernel1d(s, truncate).astype(np.float32)
            r = gaussian_radius(s, truncate)
            n = block.shape[axis]
            total = mesh_sizes[axis] * (h, w)[axis]
            v = valid[axis] if valid is not None else total
            if v == total:
                block = halo_pad_1d(
                    block, axis, (r, r), names[axis], mesh_sizes[axis],
                    fill="reflect",
                )
            else:
                if 2 * (total - v) > n:
                    raise ValueError(
                        f"ragged pad {total - v} too wide for block {n} "
                        f"along {names[axis]}: the true-edge reflection "
                        "source must fit in the same block"
                    )
                ext = halo_pad_1d(
                    block, axis, (r, r), names[axis], mesh_sizes[axis],
                    fill="zero",
                )
                block = _reflect_oob(ext, axis, r, names[axis], n, v)
            block = C._correlate1d_valid(block, taps, axis)
        return block

    def _valid_mask(self, block_shape, valid_shape, dtype):
        """Per-block 0/1 mask of the true domain for ragged grids, plus the
        (giy, gix) global index planes."""
        lh, lw = block_shape
        giy = global_index(0, GY, lh, block_shape)
        gix = global_index(1, GX, lw, block_shape)
        vh, vw = valid_shape
        mask = ((giy < vh) & (gix < vw)).astype(dtype)
        return mask, giy, gix

    def _masked_center(self, block, mask, count):
        """round(mean) over the true domain (the TPI/STD centring constant;
        rounding absorbs cross-device summation-order differences)."""
        return jnp.round(
            jax.lax.psum(jnp.sum(block * mask), (GY, GX)) / count
        )

    def _valid_counts(self, shape, valid_shape, kernel):
        """Host-side exact boundary tap-count plane of the *true* grid,
        zero-embedded into the padded global shape."""
        vh, vw = valid_shape
        plane = np.zeros(shape, np.float32)
        plane[:vh, :vw] = C.edge_count_plane(valid_shape, kernel)
        return self.put(plane)

    # ------------------------------------------------------------------
    def gaussian(
        self,
        x: jax.Array,
        sigma,
        truncate: float = 4.0,
        valid_shape: Optional[Tuple[int, int]] = None,
    ) -> jax.Array:
        """Sharded scipy-parity Gaussian smoothing (reference dem op,
        topo.py:62-80). ``valid_shape`` reflects at the *true* edge of a
        ragged padded grid (see :meth:`_local_gaussian`)."""
        self._check(x.shape)
        sig_key = tuple(sigma) if not np.isscalar(sigma) else float(sigma)

        def build():
            return lambda b: self._local_gaussian(
                b, sigma, truncate, valid=valid_shape
            )

        return self._wrap(
            ("gauss", sig_key, truncate, x.shape, valid_shape), build, 1
        )(x)

    # ------------------------------------------------------------------
    def tpi(
        self,
        x: jax.Array,
        size: int,
        sigma: Optional[float] = None,
        valid_shape: Optional[Tuple[int, int]] = None,
    ) -> jax.Array:
        """Sharded TPI (reference topo.py:145-181).

        ``valid_shape`` supports ragged grids padded with ``pad_to_mesh``:
        the pre-smooth reflects at the *true* edge, the centring constant and
        tap-count plane come from the true domain only, and pad pixels are
        zeroed in the centred field so they contribute exactly what the
        single-chip zero boundary would."""
        self._check(x.shape)
        kernel = circular_kernel(size, exclude_center=True)
        ksum = float(kernel.sum())
        if valid_shape is None:
            counts = self.put(
                C.edge_count_plane(x.shape, kernel).astype(np.float32)
            )
        else:
            counts = self._valid_counts(x.shape, valid_shape, kernel)
        kh, kw = kernel.shape
        (ply, phy), (plx, phx) = C._same_pads(kh), C._same_pads(kw)

        def build():
            def local(block, counts_l):
                if sigma:
                    block = self._local_gaussian(
                        block, sigma, valid=valid_shape
                    )
                if valid_shape is None:
                    c = jnp.round(_global_mean(block))
                    z = block - c
                else:
                    mask, _, _ = self._valid_mask(
                        block.shape, valid_shape, block.dtype
                    )
                    cnt = float(valid_shape[0] * valid_shape[1])
                    c = self._masked_center(block, mask, cnt)
                    z = (block - c) * mask
                zp = exchange_halo(
                    z, (ply, phy), (plx, phx), (self.gy, self.gx), fill="zero"
                )
                conv = C.conv2d_valid(zp[None], kernel)[0]
                return block - (conv + c * counts_l) / ksum

            return local

        return self._wrap(
            ("tpi", size, sigma, x.shape, valid_shape), build, 2
        )(x, counts)

    # ------------------------------------------------------------------
    def std(
        self,
        x: jax.Array,
        size: int,
        sigma: Optional[float] = None,
        int32_parity: bool = True,
        valid_shape: Optional[Tuple[int, int]] = None,
    ) -> jax.Array:
        """Sharded rolling STD (reference topo.py:272-307), with the
        mean-centred float32-stable formulation of ops.std. ``valid_shape``
        handles ragged padded grids exactly as in :meth:`tpi`."""
        self._check(x.shape)
        kernel = circular_kernel(size)
        ksum = float(kernel.sum())
        if valid_shape is None:
            counts = self.put(
                C.edge_count_plane(x.shape, kernel).astype(np.float32)
            )
        else:
            counts = self._valid_counts(x.shape, valid_shape, kernel)
        kh, kw = kernel.shape
        (ply, phy), (plx, phx) = C._same_pads(kh), C._same_pads(kw)

        def build():
            def local(block, counts_l):
                if sigma:
                    block = self._local_gaussian(
                        block, sigma, valid=valid_shape
                    )
                if valid_shape is None:
                    c = jnp.round(_global_mean(block))
                    mask = None
                else:
                    mask, _, _ = self._valid_mask(
                        block.shape, valid_shape, block.dtype
                    )
                    cnt = float(valid_shape[0] * valid_shape[1])
                    c = self._masked_center(block, mask, cnt)
                t = jnp.trunc(block) if int32_parity else block
                t_c, z_c = t - c, block - c
                if mask is not None:
                    t_c, z_c = t_c * mask, z_c * mask
                stack = jnp.stack([t_c * t_c, t_c, z_c])
                stackp = exchange_halo(
                    stack,
                    (ply, phy),
                    (plx, phx),
                    (self.gy, self.gx),
                    fill="zero",
                    y_axis=1,
                    x_axis=2,
                )
                q, tt, z = C.conv2d_valid(stackp, kernel)
                sum_sq = q + 2.0 * c * tt + c * c * counts_l
                sum_dem = z + c * counts_l
                var = (sum_sq - sum_dem * sum_dem / ksum) / (ksum - 1.0)
                return jnp.sqrt(jnp.clip(var, 0.0, None))

            return local

        return self._wrap(
            ("std", size, sigma, int32_parity, x.shape, valid_shape), build, 2
        )(x, counts)

    # ------------------------------------------------------------------
    def disk_descriptors(
        self,
        x: jax.Array,
        sizes: Sequence[int],
        sigma: Optional[float] = None,
        compute_tpi: bool = True,
        compute_std: bool = True,
        int32_parity: bool = True,
        valid_shape: Optional[Tuple[int, int]] = None,
    ):
        """Fused multi-scale TPI/STD over the mesh — the sharded counterpart
        of :func:`topo_descriptors_tpu.ops.disk_descriptors`.

        One shard_map program for the whole (descriptor, scale) batch: the
        centred moment fields are built once, the halo is exchanged ONCE at
        the *largest* scale's width (each smaller scale convolves a centred
        crop of the same extended stack), and TPI rides STD's intermediates
        as an elementwise epilogue. The per-scale sharded methods rebuild
        fields and re-exchange per scale — for the reference's 12-scale batch
        (scripts/compute_topo_descriptors.py:44-62) that is 12 exchanges and
        36 conv inputs vs one exchange here.

        Returns ``{"tpi": (S, H, W), "std": (S, H, W)}`` sharded arrays.
        """
        self._check(x.shape)
        sizes = [int(s) for s in sizes]
        disks = [circular_kernel(s) for s in sizes]
        ksums = [float(k.sum()) for k in disks]
        pads = [(C._same_pads(k.shape[0]), C._same_pads(k.shape[1]))
                for k in disks]
        ply_m = max(p[0][0] for p in pads)
        phy_m = max(p[0][1] for p in pads)
        plx_m = max(p[1][0] for p in pads)
        phx_m = max(p[1][1] for p in pads)
        if valid_shape is None:
            counts = [
                self.put(C.edge_count_plane(x.shape, k).astype(np.float32))
                for k in disks
            ]
        else:
            counts = [
                self._valid_counts(x.shape, valid_shape, k) for k in disks
            ]
        def build():
            def local(block, *counts_l):
                if sigma:
                    block = self._local_gaussian(
                        block, sigma, valid=valid_shape
                    )
                if valid_shape is None:
                    c = jnp.round(_global_mean(block))
                    mask = None
                else:
                    mask, _, _ = self._valid_mask(
                        block.shape, valid_shape, block.dtype
                    )
                    cnt = float(valid_shape[0] * valid_shape[1])
                    c = self._masked_center(block, mask, cnt)
                z_c = block - c
                if mask is not None:
                    z_c = z_c * mask
                if compute_std:
                    t = jnp.trunc(block) if int32_parity else block
                    t_c = t - c
                    if mask is not None:
                        t_c = t_c * mask
                    fields = jnp.stack([z_c, t_c, t_c * t_c])
                else:
                    fields = z_c[None]
                stackp = exchange_halo(
                    fields,
                    (ply_m, phy_m),
                    (plx_m, phx_m),
                    (self.gy, self.gx),
                    fill="zero",
                    y_axis=1,
                    x_axis=2,
                )
                out_tpi, out_std = [], []
                for i, (disk, ksum) in enumerate(zip(disks, ksums)):
                    (ply, phy), (plx, phx) = pads[i]
                    trimmed = stackp[
                        :,
                        ply_m - ply : stackp.shape[1] - (phy_m - phy),
                        plx_m - plx : stackp.shape[2] - (phx_m - phx),
                    ]
                    convs = C.conv2d_valid(trimmed, disk)
                    z_conv = convs[0]
                    if compute_tpi:
                        # centre-zeroed disk = full disk minus the centre tap
                        tpi_sum = (z_conv - z_c) + c * (counts_l[i] - 1.0)
                        out_tpi.append(block - tpi_sum / (ksum - 1.0))
                    if compute_std:
                        t_conv, q_conv = convs[1], convs[2]
                        sum_sq = q_conv + 2.0 * c * t_conv + c * c * counts_l[i]
                        sum_dem = z_conv + c * counts_l[i]
                        var = (sum_sq - sum_dem * sum_dem / ksum) / (ksum - 1.0)
                        out_std.append(jnp.sqrt(jnp.clip(var, 0.0, None)))
                return tuple(
                    (jnp.stack(out_tpi),) if compute_tpi else ()
                ) + tuple((jnp.stack(out_std),) if compute_std else ())

            return local

        key = (
            "disk_multi", tuple(sizes), sigma, compute_tpi, compute_std,
            int32_parity, x.shape, valid_shape,
        )
        fn = self._cache.get(key)
        if fn is None:
            local = build()
            n_res = int(compute_tpi) + int(compute_std)
            out_specs = tuple([P(None, GY, GX)] * n_res)
            fn = jax.jit(
                shard_map(
                    local,
                    mesh=self.mesh,
                    in_specs=tuple([SPATIAL] * (1 + len(sizes))),
                    out_specs=out_specs if n_res > 1 else out_specs[0],
                )
            )
            self._cache[key] = fn
        res = fn(x, *counts)
        if not isinstance(res, tuple):
            res = (res,)
        out = {}
        if compute_tpi:
            out["tpi"] = res[0]
        if compute_std:
            out["std"] = res[-1]
        return out

    # ------------------------------------------------------------------
    def _central_diff(self, block, axis, valid_len=None):
        """np.gradient: halo of 1 with linear-extrapolation fill makes the
        central difference reproduce the one-sided edge formula. For ragged
        grids (``valid_len`` < padded length) the last *valid* row/col is
        overwritten with the backward difference — np.gradient's bottom/right
        edge formula at the true edge."""
        names = (GY, GX)
        sizes = (self.gy, self.gx)
        ext = halo_pad_1d(block, axis, (1, 1), names[axis], sizes[axis],
                          fill="linear_extrap")
        n = ext.shape[axis]
        hi = _slice_axis(ext, axis, 2, n)
        lo = _slice_axis(ext, axis, 0, n - 2)
        grad = (hi - lo) * jnp.asarray(0.5, block.dtype)
        total = sizes[axis] * block.shape[axis]
        if valid_len is not None and valid_len < total:
            mid = _slice_axis(ext, axis, 1, n - 1)
            backward = mid - _slice_axis(ext, axis, 0, n - 2)
            gi = global_index(axis, names[axis], block.shape[axis], block.shape)
            grad = jnp.where(gi == valid_len - 1, backward, grad)
        return grad

    def gradient(
        self,
        x: jax.Array,
        sigma: float,
        res_meters,
        sig_ratio: float = 1.0,
        valid_shape: Optional[Tuple[int, int]] = None,
    ):
        """Sharded gradient/slope/aspect (reference topo.py:597-644).

        ``res_meters`` is the dict from scale_to_pixel; resolutions are
        broadcast host-side to full 2-D planes so both projected (1-D) and
        geographic (2-D) grids shard uniformly. ``valid_shape`` supports
        ragged padded grids: the pre-smooth reflects at the true edge and
        np.gradient's one-sided formula is applied at the true bottom/right
        rows (outputs in the pad region are garbage and cropped by the
        caller).
        """
        self._check(x.shape)
        h, w = x.shape
        vh, vw = valid_shape if valid_shape is not None else (h, w)
        xr = np.asarray(res_meters["x"], dtype=np.float32)
        xr = np.broadcast_to(xr, (vh, vw))
        yr = np.asarray(res_meters["y"], dtype=np.float32)
        if yr.ndim == 1:
            yr = yr[:, None]
        yr = np.broadcast_to(yr, (vh, vw))
        if (vh, vw) != (h, w):  # edge-repeat into the pad region (cropped)
            xr = np.pad(xr, ((0, h - vh), (0, w - vw)), mode="edge")
            yr = np.pad(yr, ((0, h - vh), (0, w - vw)), mode="edge")
        xr_s = self.put(np.ascontiguousarray(xr))
        yr_s = self.put(np.ascontiguousarray(yr))
        vlen = valid_shape

        def build():
            def local(block, xres, yres):
                if sigma <= 1:
                    k = sobel_kernel()
                    if vlen is None:
                        ext = exchange_halo(
                            block, 1, 1, (self.gy, self.gx), fill="reflect"
                        )
                    else:
                        from topo_descriptors_tpu.parallel.halo import (
                            _reflect_oob,
                        )

                        ext = exchange_halo(
                            block, 1, 1, (self.gy, self.gx), fill="zero"
                        )
                        ext = _reflect_oob(ext, 0, 1, GY, block.shape[0],
                                           vlen[0])
                        ext = _reflect_oob(ext, 1, 1, GX, block.shape[1],
                                           vlen[1])
                    dx = C.conv2d_valid(ext[None], k)[0]
                    dy = C.conv2d_valid(ext[None], k.T)[0]
                elif sig_ratio == 1:
                    smooth = self._local_gaussian(block, sigma, valid=vlen)
                    dy = self._central_diff(
                        smooth, 0, vlen[0] if vlen else None
                    )
                    dx = self._central_diff(
                        smooth, 1, vlen[1] if vlen else None
                    )
                else:
                    sp = sigma * sig_ratio
                    dx = self._central_diff(
                        self._local_gaussian(block, (sp, sigma), valid=vlen),
                        1, vlen[1] if vlen else None,
                    )
                    dy = self._central_diff(
                        self._local_gaussian(block, (sigma, sp), valid=vlen),
                        0, vlen[0] if vlen else None,
                    )
                dx = dx / xres
                dy = dy / yres
                rad2deg = jnp.asarray(180.0 / np.pi, block.dtype)
                slope = jnp.arctan(jnp.sqrt(dx * dx + dy * dy)) * rad2deg
                aspect = (180.0 + jnp.degrees(jnp.arctan2(dx, dy))) % 360.0
                return dx, dy, slope, aspect

            return local

        return self._wrap(
            ("grad", sigma, sig_ratio, x.shape, valid_shape), build, 3,
            n_out=4,
        )(x, xr_s, yr_s)

    # ------------------------------------------------------------------
    def _standardized(self, block, sigma, valid_shape):
        """Pre-smooth, then standardize with global statistics (reference
        topo.py:427-429) as pmean/psum collectives. With ``valid_shape``
        the statistics cover the true domain only and pad pixels are zeroed
        after standardizing — a zero pixel contributes nothing to the
        convolution, exactly like the single-device zero boundary."""
        if sigma:
            block = self._local_gaussian(block, sigma, valid=valid_shape)
        if valid_shape is None:
            mean = _global_mean(block)
            var = _global_mean((block - mean) ** 2)
            return (block - mean) / jnp.sqrt(var)
        vh, vw = valid_shape
        mask, _, _ = self._valid_mask(block.shape, valid_shape, block.dtype)
        cnt = float(vh * vw)
        mean = jax.lax.psum(jnp.sum(block * mask), (GY, GX)) / cnt
        var = jax.lax.psum(jnp.sum((block - mean) ** 2 * mask), (GY, GX)) / cnt
        return (block - mean) / jnp.sqrt(var) * mask

    def valley_ridge(
        self,
        x: jax.Array,
        size: int,
        mode: str,
        flat_list: Sequence[float] = (0, 0.15, 0.3),
        sigma: Optional[float] = None,
        valid_shape: Optional[Tuple[int, int]] = None,
    ):
        """Sharded valley/ridge index (reference topo.py:389-453) over the
        precomputed rotated bank. The global standardization becomes a
        pmean collective; each device convolves its halo-extended block
        with the flat-folded bank by a VALID FFT convolution (the block's
        transform hoisted out of the scan over angles), keeping the
        earliest angle on ties. The FFT's float32 roundoff grows with the
        log of the block's width, where the matmul-DFT engine's grows with
        its square root: at 4096-wide blocks the latter misses the oracle's
        per-pixel tolerance.

        ``valid_shape`` enables ragged grids padded with ``pad_to_mesh``
        (see :meth:`_standardized`), so the cropped result is comparable to
        the unpadded single-device op. A pre-smooth sigma reflects at the
        *true* edge (:meth:`_local_gaussian` with valid)."""
        from topo_descriptors_tpu.ops.valley_ridge import _fold_flats_np

        self._check(x.shape)
        bank = _fold_flats_np(prepare_valley_bank(size, mode, tuple(flat_list)))
        _, n_flats, ky, kx = bank.shape
        (ply, phy), (plx, phx) = C._same_pads(ky), C._same_pads(kx)
        key = ("valley", size, mode, tuple(flat_list), sigma, x.shape,
               valid_shape)
        fn = self._cache.get(key)
        if fn is None:

            def local(block, bank_k):
                block = self._standardized(block, sigma, valid_shape)
                padded = exchange_halo(
                    block, (ply, phy), (plx, phx), (self.gy, self.gx), "zero"
                )
                # a transform at least as long as the extended block: the
                # circular wrap reaches only the first k-1 outputs, which
                # the VALID crop drops
                fh, fw = C._fft_shape(padded.shape[0]), C._fft_shape(padded.shape[1])
                f_block = jnp.fft.rfft2(padded, s=(fh, fw))
                lh, lw = block.shape

                def step(carry, inputs):
                    norm, direction = carry
                    kernels, angle = inputs
                    fk = jnp.fft.rfft2(kernels, s=(fh, fw))
                    full = jnp.fft.irfft2(f_block[None] * fk, s=(fh, fw))
                    convs = jax.lax.slice(
                        full, (0, ky - 1, kx - 1), (n_flats, ky - 1 + lh, kx - 1 + lw)
                    )
                    combined = jnp.max(convs, axis=0)
                    greater = combined > norm
                    return (
                        jnp.where(greater, combined, norm),
                        jnp.where(greater, angle, direction),
                    ), None

                init = (
                    _varying(jnp.full(block.shape, -jnp.inf, block.dtype)),
                    _varying(jnp.zeros(block.shape, block.dtype)),
                )
                angles = jnp.arange(bank_k.shape[0], dtype=block.dtype)
                (norm, direction), _ = jax.lax.scan(
                    step, init, (bank_k, angles)
                )
                return jnp.clip(norm, 0.0, None), direction

            fn = jax.jit(shard_map(
                local,
                mesh=self.mesh,
                in_specs=(SPATIAL, P()),
                out_specs=(SPATIAL, SPATIAL),
            ))
            self._cache[key] = fn
        return fn(x, bank)

    # ------------------------------------------------------------------
    def valley_ridge_streamed(
        self,
        x: jax.Array,
        size: int,
        mode: str,
        flat_list: Sequence[float] = (0, 0.15, 0.3),
        sigma: Optional[float] = None,
        valid_shape: Optional[Tuple[int, int]] = None,
        n_angles: int = 180,
    ):
        """Sharded valley/ridge for bank sizes past the memory budget — the
        mesh-resident counterpart of
        :func:`~topo_descriptors_tpu.ops.valley_ridge.valley_ridge_streamed`.

        Per device: global standardization via psum collectives
        (reference topo.py:429), ONE multi-hop halo exchange at the rotated
        extent's 'same' anchor widths, then a jitted scan over the ~46
        quadrant angles — on-device spline rotation from the packed gather
        table, flips/rot90s for the other quadrants, flat-combine folded
        into the kernels, and VALID partial-DFT matmul convolutions of the
        halo-extended block (ops/dft_conv.py, mode='valid': the VALID true
        convolution over the extended block equals the interior of the
        global 'same' convolution exactly).

        Scaling note: the rotation and the kernel-side forward transform
        are replicated work, and the halo makes each device convolve a
        (block + kernel) extent — at kernel extents comparable to the whole
        grid the speedup over one chip is modest; on production grids where
        blocks dwarf the kernel the per-device cost approaches 1/N of the
        single-chip op. ``valid_shape`` handles ragged zero-padded grids
        exactly as :meth:`valley_ridge` (masked stats, pads zeroed after
        standardization).
        """
        self._check(x.shape)
        if mode not in ("valley", "ridge"):
            raise ValueError(f"Unknown mode {mode!r}")
        from topo_descriptors_tpu.kernels.valley import (
            ridge_kernels,
            rotated_extent,
            valley_kernels,
        )
        from topo_descriptors_tpu.ops.dft_conv import get_plan
        from topo_descriptors_tpu.ops.spline_rotate import (
            quadrant_schedule,
            rotation_params,
        )

        base = (
            ridge_kernels(size, tuple(flat_list))
            if mode == "ridge"
            else valley_kernels(size, tuple(flat_list))
        ).astype(np.float32)
        n_flats = len(flat_list)
        ky_max, kx_max = rotated_extent(size, np.arange(n_angles))
        kmax = max(ky_max, kx_max)
        (ply, phy), (plx, phx) = C._same_pads(kmax), C._same_pads(kmax)
        h, w = x.shape
        lh, lw = h // self.gy, w // self.gx
        eh, ew = lh + ply + phy, lw + plx + phx
        plan = get_plan(eh, ew, kmax, kmax, "valid")
        assert plan.oshape == (lh, lw)

        q_angles, slot_angle, slot_valid = quadrant_schedule(n_angles)
        qparams = np.stack(
            [rotation_params(size, float(q), kmax, kmax) for q in q_angles]
        )
        q_batch = max(1, min(4, len(q_angles)))
        if pad := (-len(q_angles)) % q_batch:
            # all-invalid slots (masked to -inf) pad the schedule so each
            # scan step holds exactly q_batch angles (ops/valley_ridge.py)
            qparams = np.concatenate(
                [qparams, np.repeat(qparams[:1], pad, 0)]
            )
            slot_angle = np.concatenate(
                [slot_angle, np.zeros((pad, 4), np.float32)]
            )
            slot_valid = np.concatenate(
                [slot_valid, np.zeros((pad, 4), bool)]
            )
        key = (
            "valley_stream", size, mode, tuple(flat_list), sigma, x.shape,
            valid_shape, n_angles, q_batch,
        )
        fn = self._cache.get(key)
        if fn is None:
            fn = self._build_valley_streamed(
                sigma, valid_shape, n_flats, size, kmax,
                (ply, phy), (plx, phx), (lh, lw), q_batch,
            )
            self._cache[key] = fn
        return fn(
            x,
            base,
            qparams.astype(np.float32),
            slot_angle.astype(np.float32),
            slot_valid.astype(np.float32),
            *plan.mats,
            *plan.field_mats,
        )

    def _build_valley_streamed(self, sigma, valid_shape, n_flats, size,
                               kmax, pads_y, pads_x, block_shape,
                               q_batch: int = 4):
        from topo_descriptors_tpu.ops.dft_conv import (
            _field_spectrum_jit,
            conv_bank_mats,
        )
        from topo_descriptors_tpu.ops.spline_rotate import (
            build_rotation_table,
            canvas_variants,
            prefilter2d_o2,
            rotate_std_canvas_table,
        )
        from topo_descriptors_tpu.ops.valley_ridge import _flat_axis_combine

        (ply, phy), (plx, phx) = pads_y, pads_x
        lh, lw = block_shape

        def local(block, base_k, qp, sa, sv, cxf, sxf, cyf, syf, cyi, syi,
                  cxi, sxi, fxc, fxs, fyc, fys):
            block = self._standardized(block, sigma, valid_shape)
            padded = exchange_halo(
                block, (ply, phy), (plx, phx), (self.gy, self.gx), "zero"
            )
            fdr, fdi = _field_spectrum_jit(padded, fxc, fxs, fyc, fys)
            table = build_rotation_table(prefilter2d_o2(base_k))

            def body(carry, xs):
                norm, direction = carry
                params_q, angles_q, valid_q = xs  # (Q,8), (Q,4), (Q,4)
                kerns = []
                for q in range(q_batch):  # static unroll (ops/valley_ridge)
                    canvas = rotate_std_canvas_table(
                        table, size, params_q[q], (kmax, kmax)
                    )
                    folded = _flat_axis_combine(canvas, axis=0)
                    kerns.append(
                        jnp.concatenate(
                            canvas_variants(folded, params_q[q]), axis=0
                        )
                    )
                kern = jnp.concatenate(kerns, axis=0)
                convs = conv_bank_mats(
                    kern, fdr, fdi, cxf, sxf, cyf, syf, cyi, syi, cxi, sxi
                ).reshape(4 * q_batch, -1, lh, lw)
                comb = jnp.max(convs, axis=1)
                valid = valid_q.reshape(4 * q_batch)
                angles = angles_q.reshape(4 * q_batch)
                comb = jnp.where(valid[:, None, None] > 0, comb, -jnp.inf)
                best = jnp.max(comb, axis=0)
                amin = jnp.min(
                    jnp.where(comb == best, angles[:, None, None], jnp.inf),
                    axis=0,
                )
                greater = best > norm
                equal = (best == norm) & (norm > -jnp.inf)
                direction = jnp.where(
                    greater,
                    amin,
                    jnp.where(equal, jnp.minimum(direction, amin), direction),
                )
                norm = jnp.where(greater, best, norm)
                return (norm, direction), None

            init = (
                _varying(jnp.full((lh, lw), -jnp.inf, block.dtype)),
                _varying(jnp.zeros((lh, lw), block.dtype)),
            )
            n_steps = qp.shape[0] // q_batch
            xs = (
                qp.reshape(n_steps, q_batch, -1),
                sa.reshape(n_steps, q_batch, -1),
                sv.reshape(n_steps, q_batch, -1),
            )
            (norm, direction), _ = jax.lax.scan(body, init, xs)
            return jnp.clip(norm, 0.0, None), direction

        return jax.jit(
            shard_map(
                local,
                mesh=self.mesh,
                in_specs=(SPATIAL,) + (P(),) * 16,
                out_specs=(SPATIAL, SPATIAL),
            )
        )

    # ------------------------------------------------------------------
    def sx(
        self,
        x: jax.Array,
        offsets: np.ndarray,
        distances: np.ndarray,
        border: int,
        height: float = 10.0,
        valid_shape: Optional[Tuple[int, int]] = None,
    ) -> jax.Array:
        """Sharded Sx horizon scan (reference topo.py:928-953). Halo width is
        the full ray length — the 'long-context' stressor of the spatial
        decomposition (SURVEY.md §5) — exchanged multi-hop when rays span
        multiple blocks. The zero border lives at *global* edges.

        ``valid_shape`` enables ragged grids padded with NaN via
        ``pad_to_mesh``: NaN pad pixels are skipped by the fmax reduction
        exactly like beyond-edge NaN halo fill on the single chip, and the
        zero border is masked at the *original* frame, so the cropped result
        is bit-comparable to the unpadded single-chip op."""
        from topo_descriptors_tpu.kernels.sx_geometry import sx_dedupe

        self._check(x.shape)
        offsets, distances = sx_dedupe(offsets, distances)
        h, w = x.shape
        vh, vw = valid_shape if valid_shape is not None else (h, w)
        with np.errstate(divide="ignore"):  # distance-0 quirk (ops.sx docstring)
            inv_dist = (1.0 / np.asarray(distances)).astype(np.float32)
        pad = int(border)

        def build():
            offs = jnp.asarray(np.asarray(offsets) + pad, dtype=jnp.int32)
            invs = jnp.asarray(inv_dist)
            lh, lw = h // self.gy, w // self.gx

            def local(block):
                padded = exchange_halo(
                    block, pad, pad, (self.gy, self.gx), fill="nan"
                )
                base = block + jnp.asarray(height, block.dtype)
                neg_inf = _varying(jnp.full(block.shape, -jnp.inf, block.dtype))

                def step(carry, inputs):
                    start, inv = inputs
                    shifted = jax.lax.dynamic_slice(
                        padded, (start[0], start[1]), (lh, lw)
                    )
                    return jnp.fmax(carry, (shifted - base) * inv), None

                max_ratio, _ = jax.lax.scan(step, neg_inf, (offs, invs))
                sx_deg = jnp.degrees(jnp.arctan(max_ratio))
                sx_deg = jnp.where(jnp.isneginf(max_ratio), jnp.nan, sx_deg)
                giy = global_index(0, GY, lh, block.shape)
                gix = global_index(1, GX, lw, block.shape)
                interior = (
                    (giy >= pad) & (giy < vh - pad) & (gix >= pad) & (gix < vw - pad)
                )
                return jnp.where(interior, sx_deg, 0.0).astype(block.dtype)

            return local

        key = (
            "sx",
            x.shape,
            border,
            height,
            offsets.shape[0],
            (vh, vw),
            hash(offsets.tobytes()),
            hash(inv_dist.tobytes()),
        )
        return self._wrap(key, build, 1)(x)


    # ------------------------------------------------------------------
    def sx_sweep(
        self,
        x: jax.Array,
        offsets: np.ndarray,
        distances: np.ndarray,
        border: int,
        height: float = 10.0,
        valid_shape: Optional[Tuple[int, int]] = None,
    ) -> jax.Array:
        """Sharded Sx for a whole fan of azimuths -> (A, H, W).

        One shard_map program for the entire sweep: the ray halo (width =
        full ray length, multi-hop when rays span blocks) is exchanged
        exactly ONCE and stays device-resident while every azimuth's offset
        scan reduces over it — the reference re-runs compute_sx per azimuth
        from the host (topo.py:760), re-reading the DEM each time. Padding
        rows of the rectangular fan table (NaN distance) are fmax-ignored,
        like :func:`topo_descriptors_tpu.ops.sx_sweep`. ``valid_shape``
        handles ragged NaN-padded grids as in :meth:`sx`.
        """
        from topo_descriptors_tpu.kernels.sx_geometry import sx_sweep_dedupe

        self._check(x.shape)
        offsets, distances = sx_sweep_dedupe(offsets, distances)
        h, w = x.shape
        vh, vw = valid_shape if valid_shape is not None else (h, w)
        with np.errstate(divide="ignore"):  # distance-0 quirk (ops.sx)
            inv_dist = (1.0 / np.asarray(distances)).astype(np.float32)
        pad = int(border)
        key = (
            "sx_sweep",
            x.shape,
            border,
            height,
            offsets.shape,
            (vh, vw),
            hash(np.asarray(offsets).tobytes()),
            hash(inv_dist.tobytes()),
        )
        fn = self._cache.get(key)
        if fn is None:
            offs = jnp.asarray(np.asarray(offsets) + pad, dtype=jnp.int32)
            invs = jnp.asarray(inv_dist)
            lh, lw = h // self.gy, w // self.gx

            def local(block):
                padded = exchange_halo(
                    block, pad, pad, (self.gy, self.gx), fill="nan"
                )
                base = block + jnp.asarray(height, block.dtype)
                neg_inf = _varying(
                    jnp.full(block.shape, -jnp.inf, block.dtype)
                )
                giy = global_index(0, GY, lh, block.shape)
                gix = global_index(1, GX, lw, block.shape)
                interior = (
                    (giy >= pad) & (giy < vh - pad)
                    & (gix >= pad) & (gix < vw - pad)
                )

                def one_azimuth(args):
                    offs_a, invs_a = args

                    def step(carry, inputs):
                        start, inv = inputs
                        shifted = jax.lax.dynamic_slice(
                            padded, (start[0], start[1]), (lh, lw)
                        )
                        return jnp.fmax(carry, (shifted - base) * inv), None

                    max_ratio, _ = jax.lax.scan(step, neg_inf, (offs_a, invs_a))
                    out = jnp.degrees(jnp.arctan(max_ratio))
                    out = jnp.where(jnp.isneginf(max_ratio), jnp.nan, out)
                    return jnp.where(interior, out, 0.0).astype(block.dtype)

                return jax.lax.map(one_azimuth, (offs, invs))

            fn = jax.jit(
                shard_map(
                    local,
                    mesh=self.mesh,
                    in_specs=(SPATIAL,),
                    out_specs=P(None, GY, GX),
                )
            )
            self._cache[key] = fn
        return fn(x)


def _slice_axis(x, axis, start, stop):
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(start, stop)
    return x[tuple(sl)]
