"""The traced sub-window: a torch.profiler trace (CPU and CUDA activity,
or CUDA alone) of a few steady frames or steps, read into plain event
lists, and the
arithmetic the per-layer metrics share: the device's busy time and idle
gaps, kernel time by name pattern, and the breakdown of the result line.

The profiler writes one Chrome trace file under TMPDIR, which is read and
deleted at once. Times are in microseconds on the trace's clock, which the
host and device events share."""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT_SPAN = "port_bench.unit"  # the benchmark's span around each traced frame or step


@dataclass
class Event:
    name: str
    ts: float
    dur: float
    cat: str = "kernel"
    tid: object = 0

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Trace:
    """Device operations, host operations and the benchmark's unit spans
    of one traced sub-window."""

    device: list = field(default_factory=list)   # Events of DEVICE_CATS
    host: list = field(default_factory=list)     # cpu_op Events
    units: list = field(default_factory=list)    # UNIT_SPAN Events

    @classmethod
    def from_chrome(cls, events: list) -> "Trace":
        out = cls()
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ev = Event(str(e.get("name", "")), float(e["ts"]), float(e["dur"]),
                       str(e.get("cat", "")), e.get("tid", 0))
            if ev.cat in DEVICE_CATS:
                out.device.append(ev)
            elif ev.cat == "user_annotation" and ev.name == UNIT_SPAN:
                out.units.append(ev)
            elif ev.cat == "cpu_op":
                out.host.append(ev)
        return out

    @property
    def window(self) -> tuple:
        """(start, end) of the traced units; without units (a trace of the
        device alone), of its device operations."""
        spans = self.units or self.device
        if not spans:
            return (0.0, 0.0)
        return (min(u.ts for u in spans), max(u.end for u in spans))

    @property
    def window_us(self) -> float:
        a, b = self.window
        return b - a

    def kernels(self) -> list:
        return [e for e in self.device if e.cat == "kernel"]

    def busy_intervals(self) -> list:
        """Merged intervals in which any device operation ran, clipped to
        the window."""
        a, b = self.window
        spans = sorted((max(e.ts, a), min(e.end, b)) for e in self.device
                       if e.end > a and e.ts < b)
        merged: list = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    def busy_us(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def idle_gaps(self) -> list:
        """[(start, length)] of the window's stretches with no device operation."""
        a, b = self.window
        gaps, last = [], a
        for s, t in self.busy_intervals():
            if s > last:
                gaps.append((last, s - last))
            last = max(last, t)
        if b > last:
            gaps.append((last, b - last))
        return gaps

    def kernel_us(self, patterns) -> Optional[float]:
        """Device time of the kernels whose names match any of the regular
        expressions, or None where none ran."""
        rx = [re.compile(p) for p in patterns]
        hits = [e.dur for e in self.kernels() if any(r.search(e.name) for r in rx)]
        return sum(hits) if hits else None

    def host_activity(self, t: float) -> str:
        """The innermost host operation running at time t on the thread of
        the benchmark's spans, or "host idle"."""
        tids = {u.tid for u in self.units}
        best = None
        for e in self.host:
            if e.tid in tids and e.ts <= t < e.end and (best is None or e.dur < best.dur):
                best = e
        return best.name if best is not None else "host idle"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, in seconds."""
        by_name: dict = {}
        a, b = self.window
        for e in self.device:
            if e.end > a and e.ts < b:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:n]
        return {"device_ops": [[name[:160], us / 1e6] for name, us in ops],
                "idle_gaps": [[self.host_activity(s + length / 2)[:160], length / 1e6]
                              for s, length in gaps]}


def capture(run_unit: Callable[[int], None], n: int, host: bool = True) -> Trace:
    """Runs run_unit(0..n-1) under torch.profiler, each in a UNIT_SPAN,
    and returns the trace's events; `host` False traces the device alone
    (no host operations, no spans: a small trace of many units). The
    Chrome trace goes to one file under TMPDIR, deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for i in range(n):
            with record_function(UNIT_SPAN):
                run_unit(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, name = tempfile.mkstemp(prefix="port_bench_trace_", suffix=".json",
                                dir=os.environ.get("TMPDIR") or None)
    os.close(fd)
    path = Path(name)
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    return Trace.from_chrome(events)
