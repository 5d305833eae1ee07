"""Host <-> device transfers in bounded pieces."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Largest single host<->device copy. Bounds the pinned staging buffer of
# each copy; whether chunking still pays on the GPU host is ROADMAP D5's
# question, to be settled by measurement.
PUT_CHUNK_BYTES = 48 * 1024 * 1024


def chunked_device_put(arr: np.ndarray, max_bytes: int = PUT_CHUNK_BYTES):
    """device_put a host array in <= ``max_bytes`` pieces along axis 0,
    concatenated on device. A no-op wrapper for small arrays."""
    arr = np.ascontiguousarray(arr)
    if arr.nbytes <= max_bytes or arr.shape[0] < 2:
        return jnp.asarray(arr)
    per_row = max(arr.nbytes // arr.shape[0], 1)
    rows = max(1, int(max_bytes // per_row))
    parts = [
        jnp.asarray(arr[i : i + rows]) for i in range(0, arr.shape[0], rows)
    ]
    return jnp.concatenate(parts, axis=0)


def chunked_fetch(arr, max_bytes: int = PUT_CHUNK_BYTES) -> np.ndarray:
    """Fetch a device array to host in <= ``max_bytes`` row slices.

    The D2H counterpart of :func:`chunked_device_put`: the out-of-core
    band loop (parallel/tiles.py) fetches every output band in bounded
    slices. When a leading index alone exceeds the budget (e.g. the
    (A, H, W) sweep stack), the slicing recurses into that index."""
    nbytes = int(arr.size) * arr.dtype.itemsize
    if nbytes <= max_bytes or arr.ndim == 0:
        # np.array, not asarray: fetched buffers of jax arrays come back
        # read-only, and band sinks mutate (global-border zeroing)
        return np.array(arr)
    per_row = max(nbytes // arr.shape[0], 1)
    if per_row > max_bytes and arr.ndim >= 2:
        out = np.empty(arr.shape, arr.dtype)
        for i in range(arr.shape[0]):
            out[i] = chunked_fetch(arr[i], max_bytes)
        return out
    rows = max(1, int(max_bytes // per_row))
    out = np.empty(arr.shape, arr.dtype)
    for i in range(0, arr.shape[0], rows):
        out[i : i + rows] = np.asarray(arr[i : i + rows])
    return out
