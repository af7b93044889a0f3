"""The `reg_train_b16` cell on the CPU: at a small size through its own
driver (drivers/reg_train_step.py) a sound run is correct and each fault
planted under the training step makes `correct` false: faults.py's, #6
giving gradients twice too large, and the port's loss cocktail with each
term doubled; its records hold every loss term and each element's first
log-L1 on both sides; its four readers read a hand-made trace of a step
and give None where the trace holds neither their kernels nor their
spans."""

import argparse
import contextlib
import json

import numpy as np
import pytest
import torch

from port_bench import faults, harness, spans
from port_bench.readers import Readings
from port_bench.trace import UNIT_SPAN
from port_bench.work import bounds
import port_bench.run as run

NAME = "reg_train_b16"
SMALL = dict(image_height=64, image_width=96, precision=32)
MIX = dict(batch=2, ring=3)
CELL = harness.Cell(NAME)
READERS = ("warp_fwd_roofline", "warp_bwd_roofline", "volume_ms.reg", "dispatch_idle_ms.train")
SPAN_READERS = ("volume_ms.reg", "dispatch_idle_ms.train")
TERMS = ("ms_loss", "grad_loss", "normals_loss", "mv_loss")


def warp_bwd_doubled():
    """Kernel #6 (the warp's backward) gives gradients twice too large."""
    return faults._scaled_cotangent("implicit_depth_tpu_torch.ops.warp_kernel",
                                    "warp_planes_bwd", 2.0)


@contextlib.contextmanager
def loss_terms_doubled():
    """The port's regression_losses gives each term of the cocktail twice
    too large, and the loss as their sum: the step descends the doubled
    loss."""
    from implicit_depth_tpu_torch.train import losses

    original = losses.regression_losses

    def doubled(*args, **kwargs):
        out = dict(original(*args, **kwargs))
        out.update({k: 2.0 * out[k] for k in TERMS})
        out["loss"] = out["ms_loss"] + out["grad_loss"] + out["normals_loss"] + 0.2 * out["mv_loss"]
        return out

    losses.regression_losses = doubled
    try:
        yield
    finally:
        losses.regression_losses = original


def cpu_run(trace: int = 0, seed: int = 2**31 + 21) -> dict:
    cell = harness.Cell(NAME, config_overrides=SMALL, mix_overrides=MIX)
    args = argparse.Namespace(workload=NAME, seed=seed, seconds=0.0, trace=trace)
    line, checks = run.run(args, device=torch.device("cpu"), cell=cell)
    out = json.loads(line)
    assert list(out)[-1] == "checks" and len(checks) == len(out["checks"])
    return out


def test_a_sound_run_is_correct():
    out = cpu_run()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(CELL.mix["limits"])
    assert set(out["metrics"]) == {"setup_s", "train_step_ms"}


PLANTED = {"half_batch": faults.half_batch, "frozen_state": faults.frozen_state,
           "altered_answer": faults.altered_answer, "warp_bwd_doubled": warp_bwd_doubled,
           "loss_terms_doubled": loss_terms_doubled}
# the number that each fault fails by construction
FAILS = {"half_batch": "elem_l1_gap", "frozen_state": "change_gap_median",
         "altered_answer": "loss1_net_grad_gap", "warp_bwd_doubled": "src_share_gap",
         "loss_terms_doubled": "grad1_gap"}


@pytest.mark.parametrize("fault", list(PLANTED))
def test_a_planted_fault_makes_correct_false(fault):
    with PLANTED[fault]():
        out = cpu_run()
    assert out["correct"] is False, (fault, out["checks"])
    check = out["checks"][FAILS[fault]]
    assert not check["value"] <= check["limit"], (fault, out["checks"])


def test_records_hold_every_term_and_each_element():
    """Program and reference record the same loss terms of each checked
    step and one first log-L1 an element; in f32 on the CPU they agree to
    rounding, and the gaps name each term of the cocktail."""
    cell = harness.Cell(NAME, config_overrides=SMALL, mix_overrides=MIX)
    drv = cell.driver().Driver(cell, 2**31 + 5, torch.device("cpu"))
    drv.setup()
    drv.release()
    ref = drv.reference_answers()
    got = drv.record
    steps = cell.driver().CHECKED_STEPS
    assert len(got.terms) == len(ref.terms) == steps
    assert sorted(got.terms[0]) == sorted(ref.terms[0])
    assert {"ms_loss", "grad_loss", "normals_loss", "mv_loss"} <= set(got.terms[0])
    assert got.elements.shape == ref.elements.shape == (MIX["batch"],)
    np.testing.assert_allclose(got.elements, ref.elements, rtol=1e-5)
    gaps = drv.numbers(ref)
    for term in ("ms", "grad", "normals", "mv"):
        assert gaps[f"{term}1_gap"] < 1e-4, gaps
    assert gaps["loss1_net_grad_gap"] < 1e-5
    assert gaps["matching_grad_gap"] < 1e-3 and gaps["src_share_gap"] < 1e-4, gaps
    assert gaps["elem_l1_gap"] < 1e-5
    half = type(got)(got, got.terms, got.elements[:1], (got.src_grad, got.cur_grad))
    assert drv.gaps(half, ref)["elem_l1_gap"] == float("inf")


def x(name, cat, ts, dur, tid=7, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def step_trace(with_program=True) -> spans.SpanTrace:
    """One step, 0-200 us: idt.step 10-190 with the forward 12-80, its
    volume 30-60 holding the warp 32-40; #5 runs 35-45 (launched at 33, in
    the warp), an MLP kernel 52-62 (launched at 50, in the volume) and #6
    110-130 (launched at 100 from autograd's thread, in the backward)."""
    program = [
        x("idt.step", "user_annotation", 10, 180), x("idt.forward", "user_annotation", 12, 68),
        x("idt.trunk.volume", "user_annotation", 30, 30),
        x("idt.trunk.warp", "user_annotation", 32, 8),
        x("idt.step.backward", "user_annotation", 90, 60),
        x("cudaLaunchKernel", "cuda_runtime", 33, 1, corr=1),
        x("cudaLaunchKernel", "cuda_runtime", 50, 1, corr=2),
        x("cudaLaunchKernel", "cuda_runtime", 100, 1, tid=9, corr=3)]
    device = [
        x(UNIT_SPAN, "user_annotation", 0, 200),
        x("void warp_planes_kernel<__nv_bfloat16>(...)", "kernel", 35, 10, tid=20, corr=1),
        x("gemm_for_the_mlp", "kernel", 52, 10, tid=20, corr=2),
        x("void bwd::warp_planes_bwd_kernel<__nv_bfloat16>(...)", "kernel", 110, 20, tid=20,
          corr=3)]
    return spans.SpanTrace.from_chrome(device + (program if with_program else []))


def readings(trace) -> Readings:
    return Readings(CELL.config, CELL.mix, trace, 1, 500.0)


def test_readers_on_a_step():
    r = readings(step_trace())
    fwd, bwd = bounds.warp(16 * 7, 96, 128, 64)
    read = {name: CELL.metric_reader(name).read(r) for name in READERS}
    assert read["warp_fwd_roofline"] == pytest.approx(100 * fwd / 10e-3)
    assert read["warp_bwd_roofline"] == pytest.approx(100 * bwd / 20e-3)
    assert read["volume_ms.reg"] == pytest.approx(20e-3)       # #5 and the MLP, not #6
    # idle inside idt.step (10-190): 10-35, 45-52, 62-110, 130-190
    assert read["dispatch_idle_ms.train"] == pytest.approx((25 + 7 + 48 + 60) / 1e3)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_to_read(name):
    """No metric where the trace lacks the reader's kernels or spans (a
    trace of other kernels and spans, no trace), and for the span readers
    a trace without the program's spans, as the parent's DepthNet gives:
    None, never 0."""
    reader = CELL.metric_reader(name)
    other = step_trace()
    other.device = [op for op in other.device if "warp_planes" not in op.name]
    other.spans = [s for s in other.spans if s.name == "idt.forward"]
    traces = [other, None] + ([step_trace(with_program=False)] if name in SPAN_READERS else [])
    for t in traces:
        assert reader.read(readings(t)) is None, t


def test_the_cell_is_in_the_benchmark():
    bench = harness.load_benchmark()
    cell = harness.Cell(NAME)
    assert cell.workload["chips"] == 1 and cell.config["kind"] == "regression"
    assert cell.mix["driver"] == "reg_train_step" and cell.mix["batch"] == 16
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms", "peak_mem_gib", "setup_s"}
    assert set(READERS) | {"mfu_pct.train", "device_idle_pct.train",
                           "optimizer_ms.train"} == {m["name"] for m in cell.per_layer}
    assert next(c for c in bench["configs"] if c["name"] == "regression")["reduced"] == []
