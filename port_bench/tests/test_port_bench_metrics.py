"""The metric arithmetic on synthetic event lists and windows: percentiles
over all frames, busy and idle shares, idle gaps by host activity, kernel
time by the metrics' name patterns, roofline and mfu shares."""

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.readers import Readings, idle_pct, mfu_pct, roofline_pct, shapes
from port_bench.trace import UNIT_SPAN, Event, Trace
from port_bench.work import bounds

CELL = harness.Cell("bd_train_b12")
EVAL = harness.Cell("bd_eval_ar")


def span(ts, dur):
    return Event(UNIT_SPAN, ts, dur, "user_annotation", 7)


def synthetic_trace():
    """Two units of 100 us each; kernels busy 0-20, 30-50 (overlapping
    10-20 twice), a copy at 150-170; host ops on the spans' thread."""
    t = Trace()
    t.units = [span(0, 100), span(100, 100)]
    t.device = [Event("fused_volume_bwd_bf16_kernel", 0, 20), Event("elementwise", 10, 10),
                Event("void (anonymous namespace)::ray_head_bwd_bf16_kernel(...)", 30, 20),
                Event("Memcpy HtoD", 150, 20, "gpu_memcpy"), Event("outside", 400, 10)]
    t.host = [Event("aten::conv2d", 40, 80, "cpu_op", 7), Event("aten::add", 95, 10, "cpu_op", 7),
              Event("other thread", 50, 100, "cpu_op", 9)]
    return t


def test_chrome_events_are_sorted_into_kinds():
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 5, "dur": 2},
              {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 9, "dur": 1},
              {"ph": "X", "cat": "user_annotation", "name": UNIT_SPAN, "ts": 0, "dur": 20, "tid": 3},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 3, "tid": 3},
              {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1}]
    t = Trace.from_chrome(events)
    assert [e.name for e in t.device] == ["k", "m"] and len(t.kernels()) == 1
    assert t.window == (0.0, 20.0) and t.host[0].tid == 3


def test_busy_idle_and_gaps():
    t = synthetic_trace()
    assert t.window_us == 200
    assert t.busy_us() == pytest.approx(20 + 20 + 20)          # 0-20, 30-50, 150-170
    assert idle_pct(Readings({}, {}, t, 2, 1.0)) == pytest.approx(70.0)
    gaps = t.idle_gaps()
    assert [g for g in gaps] == [(20, 10), (50, 100), (170, 30)]
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["aten::add", 100e-6]         # innermost op at 100 us
    assert b["device_ops"][0][0] == "fused_volume_bwd_bf16_kernel"
    assert len(b["device_ops"]) == 4                           # "outside" left out


def test_kernel_time_by_pattern_and_roofline_share():
    t = synthetic_trace()
    r = Readings(CELL.config, CELL.mix, t, 2, 400.0)
    ray = CELL.metric_reader("ray_head_roofline")
    vol = CELL.metric_reader("volume_bwd_roofline")
    assert t.kernel_us(ray.PATTERNS) == 20 and t.kernel_us(vol.PATTERNS) == 20
    assert t.kernel_us(("nothing_like_this",)) is None
    s = shapes(r)
    assert (s["B"], s["K"], s["H"], s["W"], s["D"], s["N"], s["S"]) == (12, 7, 96, 128, 64, 4096, 64)
    least, _ = bounds.volume_bwd(12, 7, 96, 128, 64)
    assert vol.read(r) == pytest.approx(100 * least / (20e-3 / 2))
    assert roofline_pct(1.0, 4.0) == 25.0 and roofline_pct(1.0, None) is None


def test_mfu_share():
    r = Readings(CELL.config, CELL.mix, synthetic_trace(), 2, 500.0)
    want = 100 * CELL.mix["flops_per_unit"] / (0.5 * 989e12)
    assert mfu_pct(r) == pytest.approx(want)
    assert CELL.metric_reader("mfu_pct.train").read(r) == pytest.approx(want)
    assert mfu_pct(Readings(CELL.config, CELL.mix, Trace(), 2, 500.0)) is None


def test_known_bounds():
    """The frozen formulas give the bounds of ops/bounds.py at these shapes."""
    assert bounds.volume_fwd(1, 7, 96, 128, 64) == (pytest.approx(0.0576, abs=1e-4), "operations")
    assert bounds.volume_bwd(12, 7, 96, 128, 64)[0] == pytest.approx(1.9860, abs=1e-4)
    fwd, bwd = bounds.ray_head(12, 4096, 64)
    assert fwd + bwd == pytest.approx(0.887, abs=1e-3)
    assert bounds.warp(112, 96, 128, 64) == (pytest.approx(0.8545, abs=1e-4),) * 2


def test_eval_window_reports_percentiles_of_every_frame(monkeypatch):
    drv = EVAL.driver().Driver(EVAL, 1, torch.device("cpu"))
    drv.ring = [None] * 3
    now = [0.0]

    def frame(i):                                              # frame i takes i + 1 ms
        now[0] += (i + 1) * 1e-3
        return np.zeros(2)

    monkeypatch.setattr("time.perf_counter", lambda: now[0])
    drv.frame = frame
    res = drv.window(0.21)
    assert res["attempted"] == 20                             # 1 + 2 + ... + 20 ms = 0.21 s
    assert res["metrics"]["latency_ms_p50.eval"] == pytest.approx(10.5)
    assert res["metrics"]["latency_ms_p95.eval"] == pytest.approx(19.05)
    assert "frame_gpu_ms" not in res["metrics"]                # no device on the CPU


def test_transfer_and_launch_readers():
    t = synthetic_trace()
    r = Readings(EVAL.config, EVAL.mix, t, 2, 70.0, {"upload": [3.0, 5.0], "readback": [1.0, 1.0]})
    assert EVAL.metric_reader("transfer_ms.eval").read(r) == pytest.approx(5.0)
    assert EVAL.metric_reader("launches_per_frame").read(r) == pytest.approx(2.0)
    assert EVAL.metric_reader("transfer_ms.eval").read(Readings({}, {}, None, 0, 1.0)) is None


def test_a_device_only_trace_spans_its_device_operations():
    """Without the benchmark's spans (a trace of the device alone) the
    window runs from the first device operation to the last."""
    t = synthetic_trace()
    t.units, t.host = [], []
    assert t.window == (0.0, 410.0)
    assert t.busy_us() == pytest.approx(20 + 20 + 20 + 10)


def test_eval_readers_take_the_window_numbers():
    window = {"latency_ms_p50.eval": 50.0, "latency_ms_p95.eval": 60.0, "frame_gpu_ms": 15.0}
    r = Readings(EVAL.config, EVAL.mix, synthetic_trace(), 2, 50.0, {}, window)
    assert EVAL.metric_reader("latency_ms_p50.eval").read(r) == 50.0
    assert EVAL.metric_reader("latency_ms_p95.eval").read(r) == 60.0
    want = 100 * EVAL.mix["flops_per_unit"] / (15e-3 * 989e12)
    assert EVAL.metric_reader("mfu_pct.eval").read(r) == pytest.approx(want)
    empty = Readings(EVAL.config, EVAL.mix, synthetic_trace(), 2, 50.0)
    assert EVAL.metric_reader("mfu_pct.eval").read(empty) is None
    assert EVAL.metric_reader("latency_ms_p50.eval").read(empty) is None
