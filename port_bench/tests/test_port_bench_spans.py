"""The join of the program's stage spans with the device trace
(port_bench/spans.py) on a hand-made Chrome trace, the five span metrics'
readers, the existing readers unchanged by spans and launch calls, and the
stage tool (port_bench/stages.py) end to end on the CPU at a tiny size."""

import argparse
import re

import pytest
import torch

from port_bench import harness, spans, stages
from port_bench.readers import Readings
from port_bench.trace import UNIT_SPAN, Trace

TRAIN = harness.Cell("bd_train_b12")
EVAL = harness.Cell("bd_eval_ar")
BENCH = harness.load_benchmark()
UNIT_TID, AUTOGRAD_TID = 7, 9


def x(name, cat, ts, dur, tid=UNIT_TID, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def train_events(with_program=True) -> list:
    """One step, 0-200 us, on thread 7: the upload 0-10, then idt.step
    10-190 (forward 12-80 with the encoder 12-40, loss 80-90, backward
    90-150, optimizer 150-185). Device: the upload's copy 3-9, an encoder
    kernel 20-30, #2 105-140 launched from autograd's thread 9 during the
    backward, a kernel with no launch call 150-160, one launched after the
    step 193-196. Waits: a stream sync at 85 (in the step), a device sync at
    197 (after it). `with_program` False leaves out the idt. spans and the
    runtime and driver calls."""
    program = [
        x("idt.upload", "user_annotation", 0, 10), x("idt.step", "user_annotation", 10, 180),
        x("idt.forward", "user_annotation", 12, 68),
        x("idt.trunk.encoder", "user_annotation", 12, 28),
        x("idt.step.loss", "user_annotation", 80, 10),
        x("idt.step.backward", "user_annotation", 90, 60),
        x("idt.step.optimizer", "user_annotation", 150, 35),
        x("idt.heads", "user_annotation", 100, 20, tid=AUTOGRAD_TID),  # not the units' thread
        x("cudaMemcpyAsync", "cuda_runtime", 2, 1, corr=2),
        x("cudaLaunchKernel", "cuda_runtime", 15, 1, corr=1),
        x("cudaLaunchKernel", "cuda_runtime", 100, 1, tid=AUTOGRAD_TID, corr=3),
        x("cuLaunchKernel", "cuda_driver", 192, 1, corr=5),
        x("cudaStreamSynchronize", "cuda_runtime", 85, 3),
        x("cudaDeviceSynchronize", "cuda_runtime", 197, 1)]
    rest = [
        x(UNIT_SPAN, "user_annotation", 0, 200),
        x("aten::conv2d", "cpu_op", 12, 28), x("aten::item", "cpu_op", 84, 5),
        x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 3, 6, tid=20, corr=2),
        x("k_encoder", "kernel", 20, 10, tid=20, corr=1),
        x("fused_volume_bwd_bf16_kernel", "kernel", 105, 35, tid=20, corr=3),
        x("k_lost", "kernel", 150, 10, tid=20, corr=4),
        x("k_after", "kernel", 193, 3, tid=20, corr=5),
        x("idt.step", "gpu_user_annotation", 10, 180, tid=20)]
    return rest + (program if with_program else [])


def eval_trace() -> spans.SpanTrace:
    """Two frames, 0-100 and 100-200 us, with idt.forward_val 5-90 and
    105-200 and idt.upload 0-5 and 100-103; one kernel each."""
    return spans.SpanTrace.from_chrome([
        x(UNIT_SPAN, "user_annotation", 0, 100), x(UNIT_SPAN, "user_annotation", 100, 100),
        x("idt.upload", "user_annotation", 0, 5), x("idt.upload", "user_annotation", 100, 3),
        x("idt.forward_val", "user_annotation", 5, 85),
        x("idt.forward_val", "user_annotation", 105, 95),
        x("cudaLaunchKernel", "cuda_runtime", 10, 1, corr=1),
        x("cudaLaunchKernel", "cuda_runtime", 110, 1, corr=2),
        x("k", "kernel", 20, 10, tid=20, corr=1), x("k", "kernel", 120, 10, tid=20, corr=2)])


def test_gpu_annotations_stay_out_of_the_device_operations():
    for cls in (Trace, spans.SpanTrace):
        t = cls.from_chrome(train_events())
        assert [e.name for e in t.device] == ["Memcpy HtoD (Pageable -> Device)", "k_encoder",
                                              "fused_volume_bwd_bf16_kernel", "k_lost", "k_after"]
        assert t.busy_us() == pytest.approx(6 + 10 + 35 + 10 + 3)


def test_the_trace_keeps_spans_calls_and_correlation():
    t = spans.SpanTrace.from_chrome(train_events())
    assert [op.corr for op in t.device] == [2, 1, 3, 4, 5]
    assert len(t.spans) == 8 and len(t.calls) == 6
    assert [s.name for s in spans.program_spans(t)][:3] == ["idt.upload", "idt.step",
                                                            "idt.forward"]
    assert "idt.heads" not in {s.name for s in spans.program_spans(t)}
    assert [c.name for c in spans.Join(t).waits()] == ["cudaStreamSynchronize",
                                                       "cudaDeviceSynchronize"]
    for name in ("cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cudaEventSynchronize"):
        assert spans.SYNC_CALLS.match(name), name
    for name in ("cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamWaitEvent"):
        assert not spans.SYNC_CALLS.match(name), name


def test_the_join():
    """Ops by their launch (the backward's from another thread), the one
    with no call counted apart; each idle gap split exactly; waits by
    their start."""
    t = spans.SpanTrace.from_chrome(train_events())
    table = spans.Join(t).table()
    assert list(table) == ["idt.upload", "idt.step", "idt.forward", "idt.trunk.encoder",
                           "idt.step.loss", "idt.step.backward", "idt.step.optimizer",
                           spans.OUTSIDE, spans.UNATTRIBUTED]
    got = {k: (s.host_us, s.device_us, s.launches, s.idle_us, s.waits) for k, s in table.items()}
    assert got == {
        "idt.upload": (10, 6, 0, pytest.approx(4), 0),
        "idt.step": (180, 0, 0, pytest.approx(7), 0),
        "idt.forward": (68, 0, 0, pytest.approx(40), 0),
        "idt.trunk.encoder": (28, 10, 1, pytest.approx(18), 0),
        "idt.step.loss": (10, 0, 0, pytest.approx(10), 1),
        "idt.step.backward": (60, 35, 1, pytest.approx(25), 0),
        "idt.step.optimizer": (35, 0, 0, pytest.approx(25), 0),
        spans.OUTSIDE: (10, 3, 1, pytest.approx(7), 1),
        spans.UNATTRIBUTED: (0, 10, 1, 0, 0)}
    assert table["idt.step.backward"].per_unit(1)["top_ops"] == [
        ["fused_volume_bwd_bf16_kernel", pytest.approx(0.035)]]
    idle = sum(s.idle_us for s in table.values())
    assert idle == pytest.approx(t.window_us - t.busy_us())
    lines = spans.format_table(table, 1, "step")
    assert len(lines) == len(table) and lines[-1].startswith("stage (unattributed): host_ms")


def test_the_span_metrics():
    t = spans.SpanTrace.from_chrome(train_events())
    r = Readings(TRAIN.config, TRAIN.mix, t, 1, 400.0)
    read = {name: TRAIN.metric_reader(name).read(r) for name in
            ("upload_ms.train", "dispatch_idle_ms.train", "syncs_per_step.train")}
    assert read == {"upload_ms.train": pytest.approx(0.010),
                    "dispatch_idle_ms.train": pytest.approx(0.125),  # all idle but upload, after
                    "syncs_per_step.train": 1.0}
    e = Readings(EVAL.config, EVAL.mix, eval_trace(), 2, 50.0)
    assert EVAL.metric_reader("dispatch_ms.eval").read(e) == pytest.approx((0.085 + 0.095) / 2)
    assert EVAL.metric_reader("upload_ms.eval").read(e) == pytest.approx(0.004)
    # a trace without the program's spans (trace.Trace, or a program
    # without them) gives none of them
    plain = Readings(TRAIN.config, TRAIN.mix, Trace.from_chrome(train_events()), 1, 400.0)
    bare = Readings(TRAIN.config, TRAIN.mix,
                    spans.SpanTrace.from_chrome(train_events(with_program=False)), 1, 400.0)
    for m in spans.METRICS:
        for rr in (plain, bare, Readings({}, {}, None, 0, 1.0)):
            assert harness.load_module(
                harness.BENCH_DIR / "metrics" / f"{m['name']}.py").read(rr) is None


@pytest.mark.parametrize("cell", [EVAL, TRAIN], ids=["eval", "train"])
def test_existing_readers_are_unchanged_by_spans_and_calls(cell):
    window = {"latency_ms_p50.eval": 50.0, "latency_ms_p95.eval": 60.0, "frame_gpu_ms": 15.0}
    bench_spans = {"upload": [3.0], "readback": [1.0]}
    traces = [Trace.from_chrome(train_events(with_program=False)),
              Trace.from_chrome(train_events()), spans.SpanTrace.from_chrome(train_events())]
    got = []
    for t in traces:
        r = Readings(cell.config, cell.mix, t, 1, 400.0, bench_spans, window)
        got.append(({m["name"]: cell.metric_reader(m["name"]).read(r) for m in cell.per_layer},
                    t.breakdown(), t.window, t.busy_us(), t.idle_gaps()))
    assert got[0] == got[1] == got[2]
    assert any(v is not None for v in got[0][0].values())


def test_the_span_metrics_follow_the_benchmarks_rules():
    """spans.METRICS as per-layer entries: names and units by BENCHMARK.json's
    rules, a layer it names, an end-to-end metric their cells report, and
    a reader each."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    names = {m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]}
    for m in spans.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", m["name"])
        assert m["name"] not in names and re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
        assert m["source"] == "program_span" and m["layer"] in layers
        for name in m["workloads"]:
            assert m["moves"] in {e["name"] for e in harness.Cell(name).end_to_end}
        assert callable(harness.Cell(m["workloads"][0]).metric_reader(m["name"]).read)


SMALL = dict(image_height=64, image_width=96, num_rays=32, samples_per_ray=8, precision=32)
MIXES = {"bd_eval_ar": dict(ring=2, warmup_rings=0), "bd_train_b12": dict(batch=2, ring=3)}
# the spans each cell's traced units open, and the metrics a CPU run reads
# (host time only: the CPU has no device operations)
OPENED = {"bd_eval_ar": {"idt.upload", "idt.forward_val", "idt.heads"},
          "bd_train_b12": {"idt.upload", "idt.step", "idt.forward", "idt.heads", "idt.step.loss",
                           "idt.step.backward", "idt.step.optimizer"}}
CPU_METRICS = {"bd_eval_ar": {"dispatch_ms.eval", "upload_ms.eval"},
               "bd_train_b12": {"upload_ms.train"}}


@pytest.mark.parametrize("name", sorted(MIXES))
def test_the_stage_tool_on_the_cpu(name):
    cell = harness.Cell(name, config_overrides=SMALL, mix_overrides=MIXES[name])
    args = argparse.Namespace(workload=name, seed=2**31 + 11, seconds=0.0)
    out, lines = stages.run(args, device=torch.device("cpu"), cell=cell)
    trunk = {f"idt.trunk.{s}" for s in ("encoder", "matching", "volume", "cv_encoder", "decoder")}
    assert set(out["stages"]) == OPENED[name] | trunk | {spans.OUTSIDE, spans.UNATTRIBUTED}
    assert len(lines) == len(out["stages"]) and out["units"] == len(out["unit_host_ms"])
    got = {m for m in out["metrics"] if m in {s["name"] for s in spans.METRICS}}
    assert got == CPU_METRICS[name]
    top = "idt.forward_val" if name == "bd_eval_ar" else "idt.step"
    assert out["stages"][top]["host_ms"] <= out["window_ms_per_unit"]
