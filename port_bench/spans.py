"""The program's stage spans joined to the device trace of a traced
sub-window: which stage of the program issued each device operation, which
stage the host was in while the device sat idle, and where the host waited
for the device.

The program opens its stages as torch.profiler.record_function ranges
named `idt.*` (implicit_depth_tpu_torch/utils/profiling.py::SPANS, the
contract these names follow). They land in the same Chrome trace, on the
same clock, as the device's kernels, copies and sets and the CUDA runtime
and driver calls that launched them; a launch call and its device
operation share `args.correlation`.

- A program span open at time t: the innermost `idt.` span that contains
  t on the thread of the benchmark's unit spans (trace.UNIT_SPAN).
- A device operation goes to the span open when its launch call started,
  whichever thread made the call (autograd's backward launches from a
  thread of its own while the unit's thread waits in idt.step.backward);
  to OUTSIDE where no program span was open then, and to UNATTRIBUTED
  where no launch call carries its correlation id.
- Each stretch of trace.Trace.idle_gaps() is split exactly among the spans
  open over it, OUTSIDE for the rest.
- A blocking wait is a runtime or driver call that SYNC_CALLS matches; it
  goes to the span open when it started.

SpanTrace is trace.Trace with the program's spans, the launch calls and
each device operation's correlation id besides; `capture` is
trace.capture returning one. Everything trace.Trace reads is unchanged, so
every existing reader gives the same value on either.

METRICS are the per-layer metrics read from the join, as BENCHMARK.json
entries; their readers are `metrics/<name>.py`. `python3
port_bench/stages.py` reads them, and prints the stage table, for a cell's
traced sub-window."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from port_bench.trace import DEVICE_CATS, UNIT_SPAN, Event, Trace

PREFIX = "idt."          # the program's span names (utils/profiling.py::SPANS)
OUTSIDE = "(outside)"
UNATTRIBUTED = "(unattributed)"
CALL_CATS = ("cuda_runtime", "cuda_driver")
# the calls in which the host waits for the device
SYNC_CALLS = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize|cudaEventSynchronize"
                        r"|cudaMemcpy|cu[A-Z]\w*Synchronize)$")

METRICS = [
    {"name": "dispatch_ms.eval", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "host dispatch", "moves": "frame_gpu_ms", "workloads": ["bd_eval_ar"]},
    {"name": "upload_ms.eval", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "entry: upload and readback", "moves": "frame_gpu_ms", "workloads": ["bd_eval_ar"]},
    {"name": "upload_ms.train", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "entry: upload and readback", "moves": "train_step_ms",
     "workloads": ["bd_train_b12"]},
    {"name": "dispatch_idle_ms.train", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "host dispatch", "moves": "train_step_ms", "workloads": ["bd_train_b12"]},
    {"name": "syncs_per_step.train", "unit": "syncs/step", "better": "lower",
     "source": "program_span", "layer": "host dispatch", "moves": "train_step_ms",
     "workloads": ["bd_train_b12"]},
]


@dataclass
class Op(Event):
    """A device operation or a launch call, with its correlation id."""

    corr: Optional[int] = None


def _complete(e: dict) -> bool:
    return e.get("ph") == "X" and "dur" in e


def _corr(e: dict) -> Optional[int]:
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


@dataclass
class SpanTrace(Trace):
    spans: list = field(default_factory=list)    # the program's idt. spans, Events
    calls: list = field(default_factory=list)    # runtime and driver calls, Ops

    @classmethod
    def from_chrome(cls, events: list) -> "SpanTrace":
        base = Trace.from_chrome(events)
        raw = [e for e in events if _complete(e) and str(e.get("cat", "")) in DEVICE_CATS]
        out = cls(device=[Op(**vars(ev), corr=_corr(e)) for ev, e in zip(base.device, raw)],
                  host=base.host, units=base.units)
        for e in events:
            if not _complete(e):
                continue
            name, cat = str(e.get("name", "")), str(e.get("cat", ""))
            ts, dur, tid = float(e["ts"]), float(e["dur"]), e.get("tid", 0)
            if cat == "user_annotation" and name.startswith(PREFIX):
                out.spans.append(Event(name, ts, dur, cat, tid))
            elif cat in CALL_CATS:
                out.calls.append(Op(name, ts, dur, cat, tid, _corr(e)))
        return out


def capture(run_unit: Callable[[int], None], n: int, host: bool = True) -> SpanTrace:
    """trace.capture, keeping the program's spans and the launch calls:
    run_unit(0..n-1) under torch.profiler, each in a UNIT_SPAN."""
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
    return SpanTrace.from_chrome(events)


@dataclass
class Stage:
    """One line of the stage table, summed over the traced units."""

    host_us: float = 0.0    # the span's own ranges, inclusive
    device_us: float = 0.0  # the device operations put down to it
    launches: int = 0       # its kernels
    idle_us: float = 0.0    # device idle time while it was the innermost span
    waits: int = 0          # blocking waits that started in it
    ops: dict = field(default_factory=dict)  # device us by operation name

    def per_unit(self, n: int, top: int = 3) -> dict:
        """The line per unit, with its `top` device operations by time."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        return {"host_ms": self.host_us / 1e3 / n, "device_ms": self.device_us / 1e3 / n,
                "launches": self.launches / n, "idle_ms": self.idle_us / 1e3 / n,
                "waits": self.waits / n, "top_ops": [[k[:120], us / 1e3 / n] for k, us in ops]}


def program_spans(t: Trace) -> list:
    """The idt. spans on the units' thread, by start (outer first)."""
    tids = {u.tid for u in t.units}
    return sorted((s for s in getattr(t, "spans", []) if s.tid in tids),
                  key=lambda s: (s.ts, -s.dur))


class Join:
    """The innermost program span over the traced window as stretches,
    and what falls in each."""

    def __init__(self, t: SpanTrace):
        self.t = t
        self.spans = program_spans(t)
        a, b = t.window
        cuts = sorted({a, b, *(s.ts for s in self.spans), *(s.end for s in self.spans)})
        cuts = [c for c in cuts if a <= c <= b]
        self.starts, self.stretches = [], []       # [(start, end, label)]
        for lo, hi in zip(cuts, cuts[1:]):
            self.starts.append(lo)
            self.stretches.append((lo, hi, self._innermost((lo + hi) / 2)))

    def _innermost(self, t: float) -> str:
        best = None
        for s in self.spans:
            if s.ts > t:
                break
            if t < s.end:
                best = s                           # later starts nest deeper
        return best.name if best is not None else OUTSIDE

    def label(self, t: float) -> str:
        """The program span open at time t, or OUTSIDE."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t >= self.stretches[i][1]:
            return OUTSIDE
        return self.stretches[i][2]

    def idle_split(self) -> dict:
        """{label: idle us}: each idle gap split among the spans open over it."""
        out: dict = {}
        for start, length in self.t.idle_gaps():
            end, covered = start + length, 0.0
            i = max(bisect.bisect_right(self.starts, start) - 1, 0)
            while i < len(self.stretches) and self.stretches[i][0] < end:
                lo, hi, label = self.stretches[i]
                part = min(hi, end) - max(lo, start)
                if part > 0:
                    out[label] = out.get(label, 0.0) + part
                    covered += part
                i += 1
            if length - covered > 0:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + length - covered
        return out

    def op_labels(self) -> list:
        """[(device op, label)]: each op put down to the span open at its launch."""
        launch = {c.corr: c.ts for c in self.t.calls if c.corr is not None}
        return [(op, self.label(launch[op.corr]) if getattr(op, "corr", None) in launch
                 else UNATTRIBUTED) for op in self.t.device]

    def waits(self) -> list:
        """The blocking waits' calls, by start."""
        return sorted((c for c in self.t.calls if SYNC_CALLS.match(c.name)), key=lambda c: c.ts)

    def table(self) -> dict:
        """{label: Stage} over the traced units, each program span name in
        the order it first opened, then OUTSIDE and UNATTRIBUTED."""
        stages: dict = {s.name: Stage() for s in self.spans}
        stages.update({OUTSIDE: Stage(), UNATTRIBUTED: Stage()})
        a, b = self.t.window
        for s in self.spans:
            stages[s.name].host_us += s.dur
        tops, last = 0.0, a
        for s in self.spans:                       # outermost spans' union
            lo, hi = max(s.ts, last), min(s.end, b)
            if hi > lo:
                tops += hi - lo
                last = hi
        stages[OUTSIDE].host_us = (b - a) - tops
        for op, label in self.op_labels():
            st = stages[label]
            st.device_us += op.dur
            st.launches += op.cat == "kernel"
            st.ops[op.name] = st.ops.get(op.name, 0.0) + op.dur
        for label, us in self.idle_split().items():
            stages[label].idle_us += us
        for c in self.waits():
            stages[self.label(c.ts)].waits += 1
        return stages

    # ---- for the metrics ----
    def intervals(self, name: str) -> list:
        """[(start, end)] of the spans named `name`."""
        return [(s.ts, s.end) for s in self.spans if s.name == name]

    def host_ms_per_unit(self, name: str) -> list:
        """Host ms inside the spans named `name`, for each traced unit."""
        return [sum(min(e, u.end) - max(s, u.ts) for s, e in self.intervals(name)
                    if s < u.end and e > u.ts) / 1e3 for u in self.t.units]

    def idle_ms_inside(self, name: str) -> float:
        """Device idle ms over the traced window while a span named `name`
        was open, at any depth."""
        spans = self.intervals(name)
        return sum(max(0.0, min(e, g + n) - max(s, g)) for g, n in self.t.idle_gaps()
                   for s, e in spans) / 1e3

    def waits_inside(self, name: str) -> int:
        """Blocking waits that started while a span named `name` was open."""
        spans = self.intervals(name)
        return sum(any(s <= c.ts < e for s, e in spans) for c in self.waits())


def join(t: Optional[Trace]) -> Optional[Join]:
    """The join of a traced sub-window, or None where the trace holds no
    program span (a trace.Trace, or a program without spans)."""
    if t is None or not t.units or not program_spans(t):
        return None
    return Join(t)


def median_host_ms(r, name: str) -> Optional[float]:
    """The median over the traced units of the host ms inside `name`."""
    j = join(r.trace)
    if j is None or not j.intervals(name):
        return None
    return float(np.median(j.host_ms_per_unit(name)))


def device_join(r, name: str) -> Optional[Join]:
    """The join where the trace holds device operations and a span named
    `name`, else None."""
    j = join(r.trace)
    if j is None or not r.trace.device or not j.intervals(name) or r.units <= 0:
        return None
    return j


def format_table(stages: dict, n: int, unit: str) -> list:
    """The stage table's lines, per frame or step."""
    lines = []
    for label, s in stages.items():
        v = s.per_unit(n)
        lines.append(f"stage {label}: host_ms {v['host_ms']:.3f}, device_ms {v['device_ms']:.3f}, "
                     f"launches {v['launches']:.1f}, idle_ms {v['idle_ms']:.3f}, "
                     f"waits {v['waits']:.1f} (per {unit})")
    return lines
