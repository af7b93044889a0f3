"""Profiling and tracing helpers, counterpart of
implicit_depth_tpu/utils/profiling.py.

- force_sync: waits for the card (torch.cuda.synchronize on the device of
  the first CUDA tensor in a tree); CPU tensors need no wait.
- StepTimer: per-step wall time after that wait, with warm-up steps
  dropped, and its mean / p50 / p95.
- trace: a torch.profiler trace (CPU and, where there is a card, CUDA
  activity) written as a Chrome trace file, which chrome://tracing or
  Perfetto opens without a TensorBoard plugin.
- compile_log: the first call's wall time and what the call computes and
  moves (FLOPs and bytes of the aten operations it dispatches).
- card_name_and_limit: the card's name and power limit as nvidia-smi
  prints them, to stand beside every number a tool prints.
- span: a named stage of the program (SPANS) as a
  torch.profiler.record_function range while a profiler records, so that
  the stage lands in the same trace, on the same clock, as the device's
  kernels, copies and launch calls (`trace` above, or the benchmark's);
  without a profiler it costs one check. To see the stages, run a loop
  inside `trace(dir)` and open dir/trace.json in Perfetto.
- UPLOAD_BYTES: the bytes the batch upload has moved, by the path it took.
- BN_EVAL_AFFINE: the eval batch norms' cached scale and shift, by hits
  and rebuilds.
- CONV_LAYOUT: the half-precision conv stacks' inputs, by whether they came
  channels_last or had to be copied into it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _first_cuda_tensor(tree) -> Optional[torch.Tensor]:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf
    return None


def force_sync(tree) -> None:
    """Waits until the card has finished the work behind a tree (dicts,
    lists, tuples) of tensors: synchronises the device of its first CUDA
    tensor. A tree of CPU tensors is already computed."""
    t = _first_cuda_tensor(tree)
    if t is not None:
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Running per-step wall-time stats, each step ended by force_sync on
    its outputs; the first `warmup` steps are not kept."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        if outputs is not None:
            force_sync(outputs)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.times) * 1000.0) if self.times else float("nan")

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self.times, 50) * 1000.0) if self.times else float("nan")

    @property
    def p95_ms(self) -> float:
        return float(np.percentile(self.times, 95) * 1000.0) if self.times else float("nan")

    def summary(self) -> dict:
        return {"mean_ms": self.mean_ms, "p50_ms": self.p50_ms,
                "p95_ms": self.p95_ms, "steps": len(self.times)}


TRACE_FILE = "trace.json"

# The program's stage spans, by name: the contract that trace readers (the
# benchmark's port_bench/spans.py) match, as kernel names are for kernels.
SPANS = {
    "idt.upload": "utils/device.py::batch_to_device, the host-to-device upload of a batch "
                  "(training, validation, the eval loops, the AR app)",
    "idt.forward_val": "BDNet.forward_val: the trunk and the query-plane head passes",
    "idt.forward": "the training forward: BDNet.forward; DepthNet.forward (train and eval)",
    "idt.trunk.encoder": "BDNet.trunk, DepthNet.forward: the pose products and the image encoder",
    "idt.trunk.matching": "BDNet.trunk, DepthNet.forward: the matching encoder on every view",
    "idt.trunk.volume": "the cost volume and its lowest-cost depth: BDNet.trunk's (#1), "
                        "DepthNet.forward's (idt.trunk.warp, then the unfused metadata MLP)",
    "idt.trunk.warp": "DepthNet.forward inside idt.trunk.volume: build_warped_views (#5)",
    "idt.trunk.cv_encoder": "BDNet.trunk, DepthNet.forward: the volume's flip back, the CV encoder",
    "idt.trunk.decoder": "BDNet.trunk: the decoder and the features' flip back; DepthNet.forward: "
                         "the decoder and the log-depth heads' cast, flip back and exp",
    "idt.heads": "the query heads: forward_val's scale-0 passes, run_mlp_train (#3)",
    "idt.step": "the train step after the upload: make_bd_train_step's (edge mask to "
                "scheduler), make_regression_train_step's (GT normals to scheduler)",
    "idt.step.loss": "the BD step's binary_losses; the regression step's predicted normals "
                     "and regression_losses",
    "idt.step.backward": "the step's loss.backward()",
    "idt.step.optimizer": "zero_grad, the gradients' fill and average, AdamW and scheduler",
}

# Bytes that utils/device.py::batch_to_device has uploaded, by path: "pinned"
# (staged through pinned host memory, copied asynchronously: on CUDA) and
# "pageable" (the plain copy: any other device). The pinned share of the
# whole says how often the staged path engages.
UPLOAD_BYTES = {"pinned": 0, "pageable": 0}

# Calls of models/matching.py::BatchNorm in eval mode with grad disabled,
# by whether the per-channel scale and shift came from its cache ("hits")
# or were rebuilt ("misses"). In a steady loop of frames every call is a
# hit; each miss after the first frame is a weights version or an input
# dtype the cache had not seen. Calls with grad enabled count neither.
BN_EVAL_AFFINE = {"hits": 0, "misses": 0}

# Inputs of the half-precision conv stacks at models/blocks.py::stack_input,
# by whether they already had the channels_last layout ("channels_last") or
# were copied into it with their cast ("converted"). A forward or a train
# step takes the image channels_last and converts two: the matching images,
# concatenated NCHW, and the cost volume, which the volume stage writes
# (b, d, h, w); any other copy is a layout leak.
CONV_LAYOUT = {"channels_last": 0, "converted": 0}

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The stage `name` (one of SPANS) as a `with` context: a
    torch.profiler.record_function range while a profiler records, else
    one shared null context. The check comes first: record_function
    outside a profiler costs ~12 us an entry on the CPU, the check ~1 us."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU activity, and CUDA activity where
    there is a card); on exit writes `log_dir`/trace.json, a Chrome trace.
    Yields the profiler (key_averages() for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# aten operations that move no bytes: they allocate or alias
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense")


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums, over the aten operations dispatched inside it, the bytes of
    each operation's tensor inputs and outputs (an in-place operation's
    tensor counts as read and written). Views and allocations move
    nothing and are not counted. Eager PyTorch fuses nothing, so this is
    the traffic its kernels move, each input read once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def compile_log(fn, *args, name: str = "fn") -> dict:
    """Calls fn(*args) once and reports {"name", "first_call_s", "flops",
    "bytes_accessed"}.

    Eager PyTorch has no lower and compile step: `first_call_s` is the wall
    time of the first call, synchronised, which on a cold build cache
    includes the nvcc build of the kernels the call reaches first, and the
    counters' own overhead. `flops` comes from
    torch.utils.flop_counter.FlopCounterMode (matrix products and
    convolutions, 2 per multiply-add), `bytes_accessed` from ByteCounter.
    The port's kernels are bound through ctypes and launched outside the
    aten dispatcher, so neither counter sees them, as XLA's cost analysis
    does not see inside a pallas_call: cli/roofline.py adds their work by
    hand from their launch counts (ops/bounds.py)."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    counter = ByteCounter()
    t0 = time.perf_counter()
    with flops, counter:
        out = fn(*args)
    force_sync(out)
    return {"name": name, "first_call_s": time.perf_counter() - t0,
            "flops": float(flops.get_total_flops()), "bytes_accessed": float(counter.bytes)}


def card_name_and_limit(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card that `device`
    names (a torch.device or its string), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip()
