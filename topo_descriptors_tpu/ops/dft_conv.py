"""Windowed convolution as partial-DFT matmuls.

The frequency-domain convolution the valley/ridge descriptor needs
(reference topo.py:443: one 'same'-mode convolution per rotated kernel,
180 angles x 3 flats per scale) has two kinds of built-in waste when done
with literal FFTs:

* the *forward* transform of a kernel canvas zero-pads a (ky, kx) support
  to the full (fh, fw) linear-convolution shape — most butterfly inputs are
  zeros;
* the *inverse* transform produces all fh x fw outputs of the full linear
  convolution, of which only the (h, w) 'same' window is kept.

Both prunings are exact when the DFT is written as a dense matrix product:
the forward only multiplies the ky support rows / kx support columns, and
the inverse only evaluates the output rows/columns actually read, so the
transform becomes deep-contraction matmuls instead of an FFT.

The complex arithmetic is spelled out over separate (re, im) float32
arrays, so every product is a real float32 matmul whose precision is
pinned by :func:`dot_precision`. All DFT phases are computed host-side in
float64 (f32 phase accumulation at these matrix extents would cost ~1e-4
of relative accuracy).

Cost model: the matmul formulation does ``O(fh*ky*nb)`` work where the FFT
does ``O(fh*fw*log)``; it wins while the kernel is not too large a fraction
of the padded shape *and* the padded shape is not astronomically large. At
the reference's 100 km scale (kernel 4717^2 on a 900x1440 field) the two
are about even; :func:`prefer_dft_matmul` routes by calibrated estimates.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# Cost-model constants of prefer_dft_matmul, from valley/ridge timings on
# an NVIDIA H100 80GB HBM3 (700 W limit), Basodino tile 900 x 1440, 180
# angles x 3 flats: the matmul engine at dot_precision() sustains
# 1.86e13 / 1.88e13 / 1.64e13 MAC/s at 1 / 2 / 20 km, the XLA-FFT route
# costs 1.9e-11 / 1.7e-11 / 4.5e-11 s per transformed point. The 20 km
# (streamed-path) values are kept: that is the path that consults them.
_MM_MACS_PER_SEC = 1.64e13
_FFT_SEC_PER_PT = 4.5e-11


def dot_precision():
    """Precision of every float32 product on the valley/ridge path.

    A float32 product without one may run in TF32 on a GPU, which keeps
    about three decimal digits, and the direction argmax keeps the first
    angle on ties, so a lost digit can flip a direction. HIGHEST is exact
    float32 on every backend.
    """
    return jax.lax.Precision.HIGHEST


def _phases(rows: np.ndarray, cols: np.ndarray, n: int, sign: float,
            scale: float = 1.0, fold: np.ndarray = None):
    """cos/sin float32 matrices of ``sign * 2*pi * rows x cols / n`` with
    float64 phase math."""
    ang = (sign * 2.0 * np.pi / n) * np.outer(rows, cols)
    c, s = np.cos(ang) * scale, np.sin(ang) * scale
    if fold is not None:
        c, s = c * fold, s * fold
    return c.astype(np.float32), s.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_mats(
    h_in: int, w_in: int, ky: int, kx: int, oh: int, ow: int, sy: int,
    sx: int, fh: int, fw: int
) -> Tuple[np.ndarray, ...]:
    """Host-side partial-(r)DFT matrices for one conv signature:

    ``Cxf/Sxf (kx, nb)``  forward rDFT of kernel columns,
    ``Cyf/Syf (fh, ky)``  forward DFT of kernel rows,
    ``Cyi/Syi (oh, fh)``  partial inverse DFT over output rows,
    ``Cxi/Sxi (nb, ow)``  partial inverse rDFT (conjugate-fold + 1/(fh*fw)
    normalization baked in) over output columns,
    ``Cxw/Sxw (w_in, nb)`` / ``Cyh/Syh (fh, h_in)``  field forward,

    with ``(fh, fw)`` the (possibly aliased-shortened, see DftConvPlan)
    circular lengths and ``nb = fw//2 + 1``. No 5-smooth rounding: matmul
    cost has no preferred radices, and kernel/field rows beyond the
    circular length simply carry the wrapped phase (the alias-free window
    condition is enforced by the plan).
    """
    nb = fw // 2 + 1
    cxf, sxf = _phases(np.arange(kx), np.arange(nb), fw, -1.0)
    cyf, syf = _phases(np.arange(fh), np.arange(ky), fh, -1.0)
    cyi, syi = _phases(np.arange(sy, sy + oh), np.arange(fh), fh, 1.0,
                       scale=1.0 / fh)
    # real-FFT conjugate fold: bins 1..nb-2 count twice (last once iff fw even)
    fold = np.full((nb, 1), 2.0)
    fold[0] = 1.0
    if fw % 2 == 0:
        fold[-1] = 1.0
    cxi, sxi = _phases(np.arange(nb), np.arange(sx, sx + ow), fw, 1.0,
                       scale=1.0 / fw, fold=fold)
    cxw, sxw = _phases(np.arange(w_in), np.arange(nb), fw, -1.0)
    cyh, syh = _phases(np.arange(fh), np.arange(h_in), fh, -1.0)
    return tuple(
        m.astype(np.float32)
        for m in (cxf, sxf, cyf, syf, cyi, syi, cxi, sxi, cxw, sxw, cyh, syh)
    )


class DftConvPlan:
    """Shapes + device-resident DFT matrices for one conv signature.

    ``mode='same'`` reproduces ``scipy.signal.convolve(mode='same')`` with
    the ``(k-1)//2`` crop anchor (conv.py:_same_pads); ``mode='valid'``
    gives the VALID true convolution used on halo-extended sharded blocks.
    The matrices are plain device arrays handed to the jitted kernels as
    *arguments* — never closure constants (GB-scale constants would be
    baked into and fetched with every executable, conv.py:612-618). Use
    :func:`get_plan` for the per-signature cached instance.
    """

    def __init__(self, h_in: int, w_in: int, ky: int, kx: int,
                 mode: str = "same"):
        if mode == "same":
            oh, ow = h_in, w_in
            sy, sx = (ky - 1) // 2, (kx - 1) // 2
        elif mode == "valid":
            oh, ow = h_in - ky + 1, w_in - kx + 1
            sy, sx = ky - 1, kx - 1
        else:
            raise ValueError(mode)
        self.shape = (h_in, w_in)
        self.kshape = (ky, kx)
        self.oshape = (oh, ow)
        # Aliased (shortened) transform lengths — exact: a circular conv of
        # length L aliases output row r with rows r±L; the window [sy,
        # sy+oh) reads alias-free iff L >= h_in+ky-1-sy (no wrap from
        # above) and L >= sy+oh (no wrap from below). For 'same' that is
        # ~h+k/2 instead of the full h+k-1 (27% fewer MACs at 20 km); for
        # 'valid' it collapses to exactly h_in.
        self.fh = max(h_in + ky - 1 - sy, sy + oh)
        self.fw = max(w_in + kx - 1 - sx, sx + ow)
        self.nb = self.fw // 2 + 1
        mats = _dft_mats(h_in, w_in, ky, kx, oh, ow, sy, sx, self.fh, self.fw)
        self._np_mats = mats[:8]
        self._np_field_mats = mats[8:]
        self._dev_mats = None
        self._dev_field_mats = None

    @staticmethod
    def _tracing() -> bool:
        try:
            from jax._src.core import trace_state_clean

            return not trace_state_clean()
        except Exception:  # pragma: no cover - jax internals moved
            # There is no supported probe — jnp ops on constants
            # return concrete arrays even inside an active trace, so an
            # isinstance(..., Tracer) check is always False and would
            # silently report "not tracing". Fail CONSERVATIVE instead:
            # claiming "tracing" makes callers use the host arrays (always
            # correct — they fold into the surrounding program as
            # constants), merely skipping the device-cache fast path.
            return True

    @property
    def mats(self):
        """The 8 conv matrices. Outside a trace: device-resident, uploaded
        once per plan (a call inside someone else's jit gets the host
        arrays instead — they fold into that program as constants; caching
        device arrays created during a trace would leak tracers)."""
        if self._tracing():
            return self._np_mats
        if self._dev_mats is None:
            self._dev_mats = tuple(jnp.asarray(m) for m in self._np_mats)
        return self._dev_mats

    @property
    def field_mats(self):
        if self._tracing():
            return self._np_field_mats
        if self._dev_field_mats is None:
            self._dev_field_mats = tuple(
                jnp.asarray(m) for m in self._np_field_mats
            )
        return self._dev_field_mats

    def macs_per_kernel(self) -> int:
        ky, kx = self.kshape
        oh, ow = self.oshape
        return (
            ky * kx * self.nb * 2
            + self.fh * ky * self.nb * 4
            + oh * self.fh * self.nb * 4
            + oh * self.nb * ow * 2
        )


@functools.lru_cache(maxsize=8)
def get_plan(h_in: int, w_in: int, ky: int, kx: int,
             mode: str = "same") -> DftConvPlan:
    """Cached plan: the device matrices (tens of MB at 20 km scales) are
    uploaded once per signature, not once per descriptor call."""
    return DftConvPlan(h_in, w_in, ky, kx, mode)


def field_spectrum(x: Array, plan: DftConvPlan) -> Tuple[Array, Array]:
    """(re, im) spectrum of the field at the plan's (fh, fw) padding.

    Matmul-based too: the exact (aliased) fh/fw are generally not
    5-smooth, and the matrices are shared with the kernel side. One-time
    cost per scale.
    """
    return _field_spectrum_jit(x, *plan.field_mats)


@jax.jit
def _field_spectrum_jit(x, cxw, sxw, cyh, syh):
    P = dot_precision()
    s1r = jnp.dot(x, cxw, precision=P)
    s1i = jnp.dot(x, sxw, precision=P)
    fdr = jnp.dot(cyh, s1r, precision=P) - jnp.dot(syh, s1i, precision=P)
    fdi = jnp.dot(cyh, s1i, precision=P) + jnp.dot(syh, s1r, precision=P)
    return fdr, fdi


def conv_bank(kernels: Array, fdr: Array, fdi: Array,
              plan: DftConvPlan) -> Array:
    """Convolve the planned field spectrum with a (B, ky, kx) kernel bank
    -> (B, oh, ow). True convolution: frequency multiplication convolves,
    so the kernel is fed *unflipped*."""
    return conv_bank_mats(kernels, fdr, fdi, *plan.mats)


def conv_bank_mats(kernels, fdr, fdi, cxf, sxf, cyf, syf, cyi, syi,
                   cxi, sxi) -> Array:
    """Jit-safe core of :func:`conv_bank` (matrices as explicit args so
    callers can embed it in larger jitted programs, e.g. the valley/ridge
    angle scan)."""
    P = dot_precision()
    d = functools.partial(jnp.einsum, "bij,jk->bik", precision=P)
    dl = functools.partial(jnp.einsum, "uj,bjk->buk", precision=P)
    s1r, s1i = d(kernels, cxf), d(kernels, sxf)  # (B, ky, nb)
    fkr = dl(cyf, s1r) - dl(syf, s1i)  # (B, fh, nb)
    fki = dl(cyf, s1i) + dl(syf, s1r)
    pr = fkr * fdr - fki * fdi
    pi = fkr * fdi + fki * fdr
    s2r = dl(cyi, pr) - dl(syi, pi)  # (B, oh, nb)
    s2i = dl(cyi, pi) + dl(syi, pr)
    return d(s2r, cxi) - d(s2i, sxi)  # (B, oh, ow)


def prefer_dft_matmul(h_in: int, w_in: int, ky: int, kx: int) -> bool:
    """Route between the matmul-DFT and XLA-FFT conv formulations by the
    calibrated cost model (module constants). The matmul side charges
    its MACs at the measured sustained rate; the FFT side charges ~2
    full-size transforms per kernel (3 forward + 3 inverse per 3-kernel
    angle) at the measured per-point rate on the 5-smooth padded shape."""
    from topo_descriptors_tpu.ops.conv import _fft_shape

    sy, sx = (ky - 1) // 2, (kx - 1) // 2
    ph = float(max(h_in + ky - 1 - sy, sy + h_in))  # aliased lengths
    pw = float(max(w_in + kx - 1 - sx, sx + w_in))
    nb = pw // 2 + 1
    macs = ky * kx * nb * 2 + ph * ky * nb * 4 + h_in * ph * nb * 4 \
        + h_in * nb * w_in * 2
    t_mm = macs / _MM_MACS_PER_SEC
    fh, fw = _fft_shape(h_in + ky - 1), _fft_shape(w_in + kx - 1)
    t_fft = 2 * fh * fw * _FFT_SEC_PER_PT
    return t_mm <= t_fft
