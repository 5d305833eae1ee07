"""Tests for the host->device transfer plumbing (utils/transfer.py).

``chunked_device_put`` is load-bearing for the streamed valley/ridge path
(GB-scale prefiltered kernel stacks at the reference's 60-100 km scales):
a wrong chunk size would silently break the per-copy size bound.
"""

import numpy as np
import pytest

from topo_descriptors_tpu.utils import transfer
from topo_descriptors_tpu.utils.transfer import PUT_CHUNK_BYTES, chunked_device_put


def test_small_array_single_put_equivalence():
    arr = np.arange(48, dtype=np.float32).reshape(4, 3, 4)
    out = chunked_device_put(arr)
    np.testing.assert_array_equal(np.asarray(out), arr)
    assert out.dtype == arr.dtype
    assert out.shape == arr.shape


def test_large_array_chunks_along_axis0_and_concat_exact():
    # force chunking with a tiny max_bytes: 10 rows x 4 cols f32 = 160 B,
    # max 48 B -> 3 rows per chunk -> 4 chunks
    arr = np.arange(40, dtype=np.float32).reshape(10, 4)
    out = chunked_device_put(arr, max_bytes=48)
    np.testing.assert_array_equal(np.asarray(out), arr)
    assert out.shape == arr.shape and out.dtype == arr.dtype


def test_chunk_count_for_oversize_array(monkeypatch):
    calls = []
    orig = transfer.jnp.asarray

    def counting_asarray(a, *args, **kwargs):
        calls.append(np.asarray(a).shape)
        return orig(a, *args, **kwargs)

    monkeypatch.setattr(transfer.jnp, "asarray", counting_asarray)
    arr = np.zeros((8, 5, 2), np.float32)  # 320 B; chunks of <= 120 B = 3 rows
    out = chunked_device_put(arr, max_bytes=120)
    assert calls == [(3, 5, 2), (3, 5, 2), (2, 5, 2)]
    assert np.asarray(out).shape == arr.shape


def test_default_cliff_constant_and_rowsize_floor():
    # the documented per-copy bound: every individual put stays <= 48 MB
    assert PUT_CHUNK_BYTES == 48 * 1024 * 1024
    # a single row larger than max_bytes still transfers (one row per chunk)
    arr = np.zeros((3, 64), np.float32)  # 256 B/row
    out = chunked_device_put(arr, max_bytes=100)
    assert np.asarray(out).shape == arr.shape


def test_non_contiguous_input_handled():
    base = np.arange(80, dtype=np.float32).reshape(8, 10)
    view = base[:, ::2]  # non-contiguous
    out = chunked_device_put(view, max_bytes=64)
    np.testing.assert_array_equal(np.asarray(out), view)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dtype_preserved(dtype):
    arr = np.ones((6, 4), dtype=dtype)
    out = chunked_device_put(arr, max_bytes=32)
    assert np.asarray(out).dtype == dtype


# --- chunked_fetch (D2H counterpart, round 5) -------------------------------

import jax.numpy as jnp  # noqa: E402


def test_chunked_fetch_roundtrip_2d():
    from topo_descriptors_tpu.utils.transfer import chunked_fetch

    arr = np.arange(8 * 10, dtype=np.float32).reshape(8, 10)
    dev = jnp.asarray(arr)
    out = chunked_fetch(dev, max_bytes=120)  # 3 rows per slice
    np.testing.assert_array_equal(out, arr)
    assert out.flags.writeable


def test_chunked_fetch_recurses_into_oversized_leading_index():
    from topo_descriptors_tpu.utils.transfer import chunked_fetch

    # (A, H, W) sweep stack whose single leading index exceeds the budget:
    # slicing must recurse into the (H, W) planes
    arr = np.arange(2 * 16 * 4, dtype=np.float32).reshape(2, 16, 4)
    dev = jnp.asarray(arr)
    out = chunked_fetch(dev, max_bytes=128)  # plane = 256 B > 128
    np.testing.assert_array_equal(out, arr)
    assert out.flags.writeable


def test_chunked_fetch_small_array_writable_copy():
    from topo_descriptors_tpu.utils.transfer import chunked_fetch

    dev = jnp.asarray(np.ones((4, 4), np.float32))
    out = chunked_fetch(dev)
    out[0, 0] = 7.0  # band sinks mutate (global-border zeroing)
    assert out[0, 0] == 7.0
