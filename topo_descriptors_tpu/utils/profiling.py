"""Profiling and roofline observability.

The reference's only instrumentation is the @timer log line
(helpers.py:157-168). Production runs need more: device traces, per-op
throughput, and a roofline model saying how far an op sits from the
hardware ceiling. All host-side and optional — nothing here touches the
compute path.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Dict


from topo_descriptors_tpu.utils.timing import Timings

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace (view with xprof/tensorboard).

    Usage::

        with device_trace("/tmp/trace"):
            result = jax.block_until_ready(op(dem))
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info(f"device trace written to {logdir}")


def throughput_report(pixels: int) -> Dict[str, float]:
    """Mpixel/s per recorded timer label (utils.timing.Timings registry)."""
    report = {}
    for name, samples in Timings.samples.items():
        best = min(samples)
        report[name] = pixels / 1e6 / best if best > 0 else float("inf")
    return report


# --- roofline model ----------------------------------------------------------


@dataclass(frozen=True)
class Roofline:
    """Published per-card peaks (dense rates, no sparsity)."""

    hbm_gbps: float  # device-memory bandwidth
    fp32_tflops: float  # float32 outside the tensor cores
    tf32_tflops: float  # TF32 tensor cores
    source: str

    def sx_light_speed_ms(self, pixels: int, n_offsets: int) -> float:
        """Sx compute floor: subtract, multiply and fmax per (pixel, ray)
        at the float32 rate."""
        return pixels * n_offsets * 3.0 / (self.fp32_tflops * 1e12) * 1e3

    def hbm_light_speed_ms(self, bytes_moved: int) -> float:
        return bytes_moved / (self.hbm_gbps * 1e9) * 1e3


# Keyed by ``jax.devices()[0].device_kind``. A card not listed here is an
# error, never a default: add its data-sheet peaks first.
PEAKS: Dict[str, Roofline] = {
    "NVIDIA H100 80GB HBM3": Roofline(
        hbm_gbps=3350.0, fp32_tflops=67.0, tf32_tflops=495.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5",
    ),
    "NVIDIA H100 PCIe": Roofline(
        hbm_gbps=2000.0, fp32_tflops=51.0, tf32_tflops=378.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, PCIe",
    ),
}


def roofline_for(device_kind: str) -> Roofline:
    """The peak table entry of one card kind; unknown kinds raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak-table entry for device kind {device_kind!r}; add its "
            "data-sheet peaks to utils.profiling.PEAKS"
        ) from None
