"""Configuration for topo_descriptors_tpu.

The reference loads two knobs from ``config/topo_descriptors.conf`` via
``yaconfigobject`` (reference __init__.py:15, config/topo_descriptors.conf:1-5):

* ``min_elevation = -100`` — elevations <= this are masked to NaN at ingest
  (reference helpers.py:31)
* ``scale_std = 4`` — number of Gaussian standard deviations per unit scale,
  i.e. ``sigma = scale_pxl / 4`` (reference topo.py:49,573; helpers.py:131)

We keep both knobs with identical defaults, add the engine settings the
reference has no analogue for (mesh layout, conv routing, memory budgets),
and load overrides from a simple ``key: value`` conf file or environment
variables.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # --- reference-compatible knobs (config/topo_descriptors.conf:1-5) ---
    min_elevation: float = -100.0
    scale_std: float = 4.0

    # --- engine knobs (no reference analogue) ---
    # Preferred 2-D device mesh layout (gy, gx); None = auto square-ish.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Compute dtype for descriptor math on device.
    compute_dtype: str = "float32"
    # Use FFT convolution when the kernel area exceeds this many taps
    # (mirrors scipy.signal.convolve's method='auto' switch). Not yet
    # re-measured on the GPU (ROADMAP S4).
    fft_conv_min_taps: int = 1024
    # Below this tap count, direct convs unroll into shifted fused
    # multiply-adds instead of conv_general_dilated.
    shift_acc_max_taps: int = 1024
    # 1-D correlations (separable Gaussian) switch from shifted FMAs to
    # per-axis FFT above this tap count (ROADMAP S4: not yet re-measured on
    # the GPU).
    fft_correlate1d_min_taps: int = 88
    # {0,1}-valued kernels (disk stencils) of at least this many taps route
    # through the prefix-sum (summed-area) path: ~size row adds + 2 x
    # (distinct run widths) slice adds per pixel, exact and far below both
    # the direct conv's O(size^2) FMAs and the FFT's transpose traffic.
    sat_conv_min_taps: int = 128
    # valley/ridge: largest precomputed rotated-kernel bank to bake into the
    # device program as one static constant. Beyond this (the reference's own
    # 20-100 km example scales reach 17-48 GB) the angle loop streams
    # host-rotated chunks through a fixed-shape jit step instead, bounding
    # peak memory to O(one chunk).
    valley_bank_max_bytes: int = 192 * 1024 * 1024
    # streamed valley/ridge: target device size of one angle chunk's padded
    # kernel stack (the FFT intermediates are a small multiple of this).
    valley_chunk_bytes: int = 128 * 1024 * 1024
    # streamed valley/ridge: largest rotated+folded quadrant canvas stack to
    # keep device-resident per (size, mode, flats) signature. Rotation is an
    # input-independent product that banded/tiled drivers and warm services
    # recompute every call; caching it removes the ~46 gather rotations from
    # all but the first call (20 km stack ~0.5 GB; 100 km would be ~12 GB
    # and keeps the inline per-call rotation).
    valley_canvas_cache_bytes: int = 1024 * 1024 * 1024
    # Reproduce the reference's int32-truncation quirk in the rolling std
    # (reference topo.py:300). Set False for a cleaner float32 variance.
    std_int32_parity: bool = True

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "Config":
        """Parse a minimal ``key: value`` conf file (one pair per line,
        ``#`` comments), the same shape as the reference's
        topo_descriptors.conf."""
        cfg = cls()
        text = Path(path).read_text()
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            if not hasattr(cfg, key):
                continue
            field_type = type(getattr(cfg, key))
            if field_type is bool:
                setattr(cfg, key, value.lower() in ("1", "true", "yes"))
            elif field_type in (int, float):
                setattr(cfg, key, field_type(float(value)))
            else:
                setattr(cfg, key, value)
        return cfg


CHECKOUT = Path(__file__).resolve().parent.parent


def ensure_compilation_cache() -> Optional[str]:
    """Place JAX's persistent compile cache; returns its directory, or
    None when there is none.

    Called by the entry functions (the pipeline and streaming drivers,
    ``cli.main``, chip_smoke.py, bench.py) before anything compiles, never
    at import. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
    itself and nothing is set here; a directory the caller already set
    with ``jax.config.update`` is left as it is. Otherwise, when the
    package sits in its source checkout, the cache goes to
    ``<checkout>/.jax_cache``: a fixed path, so every later process finds
    what an earlier one compiled. An installed package sets nothing.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    if not (CHECKOUT / "pyproject.toml").is_file():
        return None
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def _load_default() -> Config:
    path = os.environ.get("TOPO_TPU_CONFIG")
    if path and Path(path).exists():
        return Config.from_file(path)
    default = Path(__file__).with_name("topo_descriptors_tpu.conf")
    if default.exists():
        return Config.from_file(default)
    return Config()


CFG = _load_default()
