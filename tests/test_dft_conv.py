"""Partial-DFT matmul convolution engine (ops/dft_conv.py).

The valley/ridge fast paths stand on this engine; these tests pin it
directly against scipy.signal.convolve in float64, including the two
exactness claims that make it fast: support-pruned forward transforms and
aliased (shortened) circular lengths for the windowed inverse.
"""

import numpy as np
import pytest
from scipy import signal

import jax.numpy as jnp

from topo_descriptors_tpu.ops.dft_conv import (
    DftConvPlan,
    conv_bank,
    field_spectrum,
    get_plan,
    prefer_dft_matmul,
)

rng = np.random.default_rng(11)


@pytest.mark.parametrize(
    "shape,kk,mode",
    [
        ((50, 73), 9, "same"),
        ((50, 73), 24, "same"),   # even kernel dims (rotated extents)
        ((41, 37), 15, "valid"),  # halo-extended sharded block form
        ((30, 44), 29, "same"),   # kernel ~ field: aliased lengths bind
    ],
)
def test_scipy_parity(shape, kk, mode):
    x = rng.standard_normal(shape).astype(np.float32)
    ker = rng.standard_normal((3, kk, kk)).astype(np.float32)
    plan = get_plan(*shape, kk, kk, mode)
    fdr, fdi = field_spectrum(jnp.asarray(x), plan)
    out = np.asarray(conv_bank(jnp.asarray(ker), fdr, fdi, plan))
    ref = np.stack(
        [
            signal.convolve(x.astype(np.float64), k.astype(np.float64), mode)
            for k in ker
        ]
    )
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 5e-6, err


def test_aliased_lengths_are_shorter_and_alias_free():
    # 'same': L ~ h + k/2 < h + k - 1; the window [sy, sy+oh) must satisfy
    # the no-wrap conditions L >= h+k-1-sy and L >= sy+oh
    for h, w, kk in ((900, 1440, 943), (900, 1440, 95), (64, 64, 33)):
        plan = DftConvPlan(h, w, kk, kk, "same")
        sy = (kk - 1) // 2
        assert plan.fh < h + kk - 1  # genuinely shortened
        assert plan.fh >= h + kk - 1 - sy
        assert plan.fh >= sy + h
    # 'valid': the circular length collapses to exactly the input height
    plan = DftConvPlan(100, 120, 31, 31, "valid")
    assert plan.fh == 100 and plan.fw == 120
    assert plan.oshape == (70, 90)


def test_plan_cache_and_macs_model():
    a = get_plan(64, 64, 9, 9, "same")
    b = get_plan(64, 64, 9, 9, "same")
    assert a is b  # one upload per signature
    assert a.macs_per_kernel() > 0
    # H100 calibration (dft_conv constants): on the Basodino tile the XLA
    # FFT wins at 2 km and 20 km, while small fields keep the matmuls
    assert not prefer_dft_matmul(900, 1440, 95, 95)
    assert not prefer_dft_matmul(900, 1440, 943, 943)
    assert prefer_dft_matmul(64, 64, 9, 9)


def test_field_spectrum_matches_fft():
    x = rng.standard_normal((40, 56)).astype(np.float32)
    plan = get_plan(40, 56, 13, 13, "same")
    fdr, fdi = field_spectrum(jnp.asarray(x), plan)
    ref = np.fft.rfft2(x.astype(np.float64), s=(plan.fh, plan.fw))
    np.testing.assert_allclose(np.asarray(fdr), ref.real, atol=2e-3)
    np.testing.assert_allclose(np.asarray(fdi), ref.imag, atol=2e-3)
