"""What every run of the benchmark shares: the cell's files found by name,
the caches kept inside the checkout, the seeded weights, the guard against
JAX, and the result line.

Nothing here imports the program at module level; the drivers do, inside
their functions.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that no run may hold: JAX, its libraries and the
# JAX package the port was made from (compared whole: the port's own name
# begins with the last one)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "implicit_depth_tpu")


class BenchError(RuntimeError):
    """A run that cannot report: it prints no result and exits non-zero."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    if not path.exists():
        raise BenchError(f"missing benchmark file {path}")
    return json.loads(path.read_text())


def load_module(path: Path):
    """A benchmark file loaded by path (its name may hold dots)."""
    if not path.exists():
        raise BenchError(f"missing benchmark file {path}")
    name = "port_bench_dyn_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of BENCHMARK.json with its configuration, its traffic
    mix, its driver and its metrics, each found by name."""

    def __init__(self, name: str, root: Path = ROOT, config_overrides: Optional[dict] = None,
                 mix_overrides: Optional[dict] = None):
        """`*_overrides` replace keys of the configuration or the mix: the
        CPU tests run a cell at a small size with them."""
        bench = load_benchmark(root)
        self.bench_dir = root / BENCH_DIR.name
        self.workload = find(bench["workloads"], name, "workload")
        self.name = name
        cfg_entry = find(bench["configs"], self.workload["config"], "configuration")
        self.config = dict(load_json(root / cfg_entry["file"]), **(config_overrides or {}))
        self.mix = dict(load_json(self.bench_dir / "mixes" / f"{self.workload['traffic']}.json"),
                        **(mix_overrides or {}))
        self.driver_path = self.bench_dir / "drivers" / f"{self.mix['driver']}.py"
        self.end_to_end = [m for m in bench["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self.reports(m)]

    def reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def driver(self):
        return load_module(self.driver_path)

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py")


def cache_env(root: Path = ROOT) -> dict:
    """Fixed cache directories inside the checkout, for every compiler that
    the program or PyTorch may start: only a checkout's first run builds."""
    base = root / ".port_bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
            "CUDA_CACHE_PATH": str(base / "nv_compute")}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names that sys.modules holds."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def weight_plan(net) -> dict:
    """{name: ("normal", std) | ("fill", value)} for every parameter and
    buffer of a port or reference net: flax's defaults, as the port's
    weights.init_params sets them (lecun-normal kernels truncated at two
    deviations, zero biases, unit batch-norm scale and variance)."""
    import torch.nn as nn

    plan: dict = {}
    for mname, m in net.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            plan[pre + "weight"] = ("normal", _lecun_std(m.weight[0].numel()))
            if m.bias is not None:
                plan[pre + "bias"] = ("fill", 0.0)
        elif hasattr(m, "running_mean") and hasattr(m, "running_var"):
            plan.update({pre + "weight": ("fill", 1.0), pre + "bias": ("fill", 0.0),
                         pre + "running_mean": ("fill", 0.0), pre + "running_var": ("fill", 1.0)})
        elif hasattr(m, "fc0_kernel"):
            plan[pre + "fc0_kernel"] = ("normal", _lecun_std(m.fc0_kernel.shape[0]))
            plan[pre + "fc0_bias"] = ("fill", 0.0)
    return plan


def _lecun_std(fan_in: int) -> float:
    # the std of a unit normal truncated at +-2 is 0.8796: flax rescales
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978


def init_weights(net, seed: int) -> None:
    """Writes seeded weights into `net` on its own device: one truncated
    normal draw for all kernels, from a generator on that device, then a
    scaled slice of it per kernel, in the order of their sorted names. Two
    nets with the same names and shapes get the same values."""
    import torch
    import torch.nn as nn

    state = dict(net.named_parameters())
    state.update(dict(net.named_buffers()))
    plan = weight_plan(net)
    if set(plan) != set(state):
        raise BenchError(f"no initialiser for {sorted(set(state) - set(plan))[:5]}, or none "
                         f"of the net's own for {sorted(set(plan) - set(state))[:5]}")
    device = next(iter(state.values())).device
    normals = sorted(k for k, (kind, _) in plan.items() if kind == "normal")
    total = sum(state[k].numel() for k in normals)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        flat = torch.empty(total, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
        offset = 0
        for k in normals:
            t = state[k]
            n = t.numel()
            t.copy_(flat[offset: offset + n].view(t.shape) * plan[k][1])
            offset += n
        for k, (kind, value) in plan.items():
            if kind == "fill":
                state[k].fill_(value)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    """The run's last line: the fixed keys of the result, then the numbers
    compared beside their limits under their own key, last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
