"""Driver kind `train_step`: the training step as a trainer runs it. Each
step uploads its host batch (program.batch_to_device) and runs the port's
step (program.train_step: forward, loss, backward, AdamW), with the flip
augmentation drawn from the seed by the benchmark. The steps cycle a ring
of the mix's host batches, all different.

Set-up builds the one step object and drives it through its first
CHECKED_STEPS steps, recording each loss, the first step's gradient norm
of every parameter (worked out from AdamW's first moment after one step)
and every parameter's and batch-norm running statistic's change after the
checked steps; the window goes on
with the same object. Correct: after the window the reference
(port_bench/reference, f32) takes the same first steps from the same
weights on the same batches and flips, and the records are compared
(compare.train_gaps)."""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from port_bench import compare, program, traffic
from port_bench.reference.steps import TrainRecord, norms, running_stats
from port_bench.trace import capture

CHECKED_STEPS = 3
TRACED_STEPS = 2
MAX_STEPS = 100000


class Driver:
    unit = "step"

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.mix = cell.config, cell.mix
        self.record = None

    def setup(self) -> None:
        from port_bench import harness

        self.batches = traffic.make_ring(self.seed, self.mix, self.config)
        self.flips = traffic.step_flips(self.seed, MAX_STEPS)
        net = program.build_net(self.config).to(self.device)
        harness.init_weights(net, self.seed)
        self.net = net
        self.step, self.opt = program.train_step(net, self.config, self.seed)
        self.losses: list = []
        self.i = 0
        params = dict(net.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        stats0 = {k: b.clone() for k, b in running_stats(net).items()}
        grad_norms = {}
        for i in range(CHECKED_STEPS):
            self.run_step()
            if i == 0:  # a parameter that AdamW has not stepped has no moment: 0
                beta1 = self.opt.param_groups[0]["betas"][0]
                moments = {k: self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                           for k, p in params.items()}
                grad_norms = {k: v / (1.0 - beta1) for k, v in norms(moments).items()}
        change = norms({k: p.detach() - start[k] for k, p in params.items()})
        stats = norms({k: b - stats0[k] for k, b in running_stats(net).items()})
        del start, stats0
        self.record = TrainRecord([float(v) for v in self.losses], grad_norms, change, stats)
        for _ in range(self.mix.get("warmup_steps", 1)):
            self.run_step()

    def run_step(self) -> None:
        batch = program.batch_to_device(self.batches[self.i % len(self.batches)], self.device)
        self.losses.append(self.step(batch, self.flips[self.i])["loss"])
        self.i += 1

    def window(self, seconds: float) -> dict:
        """Steps until `seconds` have passed (at least one); the step time
        is the whole window over the steps completed in it."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        first = self.i
        sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or self.i == first:
            self.run_step()
        sync()
        elapsed = time.perf_counter() - t0
        n = self.i - first
        losses = torch.stack([v.float() for v in self.losses[first:]]).cpu().numpy()
        metrics = {"train_step_ms": elapsed * 1e3 / n}
        if self.device.type == "cuda":
            metrics["peak_mem_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
        return {"attempted": n, "failed": int((~np.isfinite(losses)).sum()),
                "unit_ms": elapsed * 1e3 / n, "metrics": metrics}

    def traced(self) -> tuple:
        return capture(lambda i: self.run_step(), TRACED_STEPS), {}

    def release(self) -> None:
        self.net = self.step = self.opt = None
        self.losses = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_answers(self, fp8: bool = False) -> TrainRecord:
        """The reference's record of the checked steps, in f32 (fp8 is the
        control: bf16 autocast, its products in fp8)."""
        from port_bench import harness
        from port_bench.reference.fp8 import Fp8Products, bf16_autocast
        from port_bench.reference.nets import build_reference
        from port_bench.reference.steps import run_steps

        ref = build_reference(self.config).to(self.device)
        harness.init_weights(ref, self.seed)
        batches = [tuple({k: torch.as_tensor(v).to(self.device) for k, v in d.items()}
                         for d in self.batches[i % len(self.batches)])
                   for i in range(CHECKED_STEPS)]
        with Fp8Products() if fp8 else contextlib.nullcontext():
            record = run_steps(ref, batches, self.flips[:CHECKED_STEPS], self.config,
                               bf16_autocast(self.device) if fp8 else contextlib.nullcontext)
        del ref, batches
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return record

    def gaps(self, got: TrainRecord, reference: TrainRecord) -> dict:
        """The numbers compared, over the mix's groups of leaves."""
        return compare.train_gaps(got, reference, self.mix.get("groups"))

    def numbers(self, reference: TrainRecord) -> dict:
        return self.gaps(self.record, reference)
