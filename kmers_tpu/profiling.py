"""Tracing / profiling / roofline accounting (SURVEY.md §5.1).

The reference ships only criterion wall-clock benches; this package's
observability story:

  * ``trace(logdir)`` -- context manager around ``jax.profiler`` for
    XProf/TensorBoard traces of any pipeline section.
  * ``Timer`` -- dispatch-aware wall timing (block_until_ready fenced).
  * ``roofline`` -- achieved-bandwidth fraction for a measured op given its
    per-element device-memory traffic, against ``PEAK_HBM_GBPS``.
  * ``MetricsAccumulator`` -- host-side aggregation of the pipelines'
    counter dicts (reads, kmers_emitted, windows_skipped, route_overflow,
    route_bytes).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, NamedTuple

import jax


class Peak(NamedTuple):
    gbps: float
    source: str


#: published peak device-memory bandwidth, keyed by jax ``device_kind``
PEAK_HBM_GBPS: Dict[str, Peak] = {
    "NVIDIA H100 80GB HBM3": Peak(
        3350.0, "NVIDIA H100 data sheet, SXM5 80 GB HBM3: 3.35 TB/s"),
    "NVIDIA H100 PCIe": Peak(
        2000.0, "NVIDIA H100 data sheet, PCIe 80 GB HBM2e: 2.0 TB/s"),
    "NVIDIA H100 NVL": Peak(
        3900.0, "NVIDIA H100 data sheet, NVL 94 GB HBM3: 3.9 TB/s"),
}


def device_hbm_gbps(device=None) -> float:
    """Published peak device-memory bandwidth of `device` (GB/s).

    A device whose kind is not in PEAK_HBM_GBPS -- the CPU included --
    raises: a wrong peak makes every roofline fraction fiction."""
    dev = device or jax.devices()[0]
    peak = PEAK_HBM_GBPS.get(dev.device_kind)
    if peak is None:
        raise ValueError(
            f"no published peak bandwidth for device_kind "
            f"{dev.device_kind!r} (platform {dev.platform}); add it to "
            f"profiling.PEAK_HBM_GBPS with its source")
    return peak.gbps


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace of the enclosed block (view with XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timing with async-dispatch fencing.

    Protocol (see bench.py): warm up first, cycle distinct input buffers,
    block once per round on the last output.
    """

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def round(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    def rate(self, items: int) -> float:
        """items/sec at the best round."""
        return items / self.best


def roofline(rate_items_per_s: float, bytes_per_item: float,
             device=None) -> Dict[str, float]:
    """Achieved-vs-peak HBM bandwidth for a measured op."""
    peak = device_hbm_gbps(device) * 1e9
    achieved = rate_items_per_s * bytes_per_item
    return {
        "achieved_gbps": achieved / 1e9,
        "peak_gbps": peak / 1e9,
        "fraction": achieved / peak,
    }


class MetricsAccumulator:
    """Sums the metrics dicts returned by pipeline steps."""

    def __init__(self):
        self.totals: Dict[str, int] = {}
        self.steps = 0

    def update(self, metrics: Dict) -> None:
        for k, v in metrics.items():
            self.totals[k] = self.totals.get(k, 0) + int(v)
        self.steps += 1

    def __getitem__(self, key: str) -> int:
        return self.totals.get(key, 0)

    def summary(self) -> Dict[str, int]:
        return dict(self.totals, steps=self.steps)
