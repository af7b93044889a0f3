"""Whole runs of the harness: without a card it prints no result and
exits non-zero; without the program likewise; on the CPU at a tiny size
(the card's look skipped) a sound run is correct and each fault planted
under the timed path makes `correct` false; and a per-layer metric is
added by files and entries alone."""

import argparse
import json
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import faults, harness
import port_bench.run as run

SMALL = dict(image_height=64, image_width=96, num_rays=32, samples_per_ray=8, precision=32)
MIXES = {"bd_eval_ar": dict(ring=2, warmup_rings=0), "bd_train_b12": dict(batch=2, ring=3)}
# the faults each cell's comparison catches (PERF.md section 2): a training
# cell's answers are its loss and its state
# the end-to-end metrics a run on the CPU reports: the device's readings
# (frame_gpu_ms from a device trace, peak_mem_gib) need the card, where
# test_port_bench_cuda.py holds them
CPU_METRICS = {"bd_eval_ar": {"setup_s"}, "bd_train_b12": {"setup_s", "train_step_ms"}}
FAULTS = {"bd_eval_ar": ["altered_answer"],
          "bd_train_b12": ["frozen_state", "half_batch", "altered_answer", "volume_bwd_doubled",
                           "ray_head_bwd_doubled"]}


def cpu_run(name: str, root=harness.ROOT, trace: int = 0, seed: int = 2**31 + 11) -> dict:
    cell = harness.Cell(name, root=root, config_overrides=SMALL, mix_overrides=MIXES[name])
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.0, trace=trace)
    line, checks = run.run(args, device=torch.device("cpu"), cell=cell)
    out = json.loads(line)
    assert list(out)[-1] == "checks" and len(checks) == len(out["checks"])
    return out


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "bd_eval_ar",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import argparse, sys, torch; sys.path.insert(0, '.'); import port_bench.run as run; "
            "run.run(argparse.Namespace(workload='bd_eval_ar', seed=1, seconds=0.0, trace=0), "
            "device=torch.device('cpu')); print('{}')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "implicit_depth_tpu_torch" in proc.stderr


@pytest.mark.parametrize("name", sorted(MIXES))
def test_a_sound_run_is_correct(name):
    out = cpu_run(name)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == CPU_METRICS[name] and out["device"]["platform"] == "cpu"
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(MIXES) for f in FAULTS[n]])
def test_a_planted_fault_makes_correct_false(name, fault):
    with getattr(faults, fault)():
        out = cpu_run(name)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("fault,module,name", [
    ("volume_bwd_doubled", "fused_volume", "fused_metadata_volume_bwd"),
    ("ray_head_bwd_doubled", "ray_head", "ray_head_bwd")])
def test_a_kernel_fault_keeps_the_launch_counters_and_is_undone(fault, module, name):
    """On the card the kernel wrappers bump their own launch counters by
    name, so the planted wrapper carries them; the original is back after."""
    import importlib

    mod = importlib.import_module(f"implicit_depth_tpu_torch.ops.{module}")
    original = getattr(mod, name)
    with getattr(faults, fault)():
        planted = getattr(mod, name)
        assert planted is not original
        planted.launches += 1
    assert getattr(mod, name) is original


def test_a_metric_is_added_by_files_alone(tmp_path):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(harness.ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench["per_layer"].append({"name": "dummy_units", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "host dispatch",
                               "moves": "frame_gpu_ms", "workloads": ["bd_eval_ar"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "port_bench" / "metrics" / "dummy_units.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    out = cpu_run("bd_eval_ar", root=tmp_path, trace=1)
    assert out["metrics"]["dummy_units"] == {"value": 5.0, "unit": "frames"}
    assert "breakdown" in out and out["device"]["window_s"] > 0
