"""What a per-layer metric's reader gets, and the arithmetic readers
share. A reader is a file `metrics/<metric name>.py` with a function
`read(r: Readings) -> float | None`; None means it found nothing to read,
and the metric is left out of the line."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from port_bench.trace import Trace
from port_bench.work import bounds


@dataclass
class Readings:
    config: dict                   # the cell's configuration
    mix: dict                      # the cell's traffic mix
    trace: Optional[Trace]         # the traced sub-window
    units: int                     # frames or steps in it
    unit_ms: float                 # the untraced window's median frame or mean step, ms
    spans: dict = field(default_factory=dict)  # the benchmark's spans, {name: [ms per unit]}
    window: dict = field(default_factory=dict)  # the untraced window's own numbers, by name


def shapes(r: Readings) -> dict:
    """The cell's kernel shapes: batch, source views, the matching
    resolution and planes, rays and samples."""
    c = r.config
    down = 2 ** (1 + c.get("matching_scale", 1))  # the matching features' stride
    return {"B": r.mix["batch"], "K": c["model_num_views"] - 1,
            "H": c["image_height"] // down, "W": c["image_width"] // down,
            "D": c["matching_num_depth_bins"], "N": c.get("num_rays", 0),
            "S": c.get("samples_per_ray", 0)}


def kernel_ms_per_unit(r: Readings, patterns) -> Optional[float]:
    """Device ms a frame or step of the kernels matching the patterns."""
    if r.trace is None or r.units <= 0:
        return None
    us = r.trace.kernel_us(patterns)
    return None if us is None else us / 1e3 / r.units


def roofline_pct(least_ms: float, kernel_ms: Optional[float]) -> Optional[float]:
    """The least time over the device time, in %; None where nothing ran."""
    if kernel_ms is None or kernel_ms <= 0:
        return None
    return 100.0 * least_ms / kernel_ms


def mfu_pct(r: Readings, unit_ms: Optional[float] = None) -> Optional[float]:
    """The cell's fixed FLOPs a frame or step (mix["flops_per_unit"],
    counted once from the f32 reference by port_bench/work/count_flops.py)
    over a unit's time (by default the untraced window's) at the card's
    bf16 peak, in %."""
    flops = r.mix.get("flops_per_unit")
    unit_ms = r.unit_ms if unit_ms is None else unit_ms
    if not flops or not unit_ms or r.trace is None or not r.trace.device:
        return None
    return 100.0 * flops / (unit_ms / 1e3 * bounds.BF16_FLOP_PER_S)


def idle_pct(r: Readings) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    if r.trace is None or not r.trace.device or r.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_us() / r.trace.window_us)
