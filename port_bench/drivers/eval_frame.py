"""Driver kind `eval_frame`: a closed loop of single frames, as an AR app
or an eval harness runs the model. Each frame uploads its host tuple
(program.batch_to_device), runs the eval forward (program.eval_forward)
and reads its answer back to the host; the next frame starts when the
answer is there. The frames cycle a ring of the mix's host tuples.

The window's numbers: the frame latency on the host clock over every
frame (`latency_ms_p50.eval`, `latency_ms_p95.eval`), and the device's
time a frame (`frame_gpu_ms`): once the window has closed, the mix's
`gpu_frames` more frames of the same loop run under a trace of the device
alone, and their busy time (kernels, copies and sets, overlaps merged) is
divided by their count. The frame is host-bound, so its latency follows
the host's speed; its device time does not.

Correct: after the window, the reference (port_bench/reference, f32) runs
the same forward on every ring tuple, and the last answer the window gave
for each is held to it (compare.eval_gaps)."""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from port_bench import compare, program, traffic
from port_bench.trace import capture

TRACED_FRAMES = 5


class Driver:
    unit = "frame"
    gaps = staticmethod(compare.eval_gaps)  # (answers, reference answers) -> numbers

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.mix = cell.config, cell.mix
        self.answers: dict = {}

    def setup(self) -> None:
        from port_bench import harness

        self.ring = traffic.make_ring(self.seed, self.mix, self.config)
        net = program.build_net(self.config).to(self.device)
        harness.init_weights(net, self.seed)
        self.net = net.eval().cast_to_compute_dtype()
        self.forward = program.eval_forward(self.net, self.config)
        for i in range(len(self.ring) * self.mix.get("warmup_rings", 1)):
            self.frame(i)

    def frame(self, i: int, keep: bool = True) -> np.ndarray:
        slot = i % len(self.ring)
        with torch.inference_mode():
            cur, src = program.batch_to_device(self.ring[slot], self.device)
            answer = self.forward(cur, src).float().cpu().numpy()
        if keep:
            self.answers[slot] = answer
        return answer

    def window(self, seconds: float) -> dict:
        """Frames until `seconds` have passed, and at least one ring."""
        times, failed = [], 0
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds or i < len(self.ring):
            ts = time.perf_counter()
            answer = self.frame(i)
            times.append(time.perf_counter() - ts)
            failed += not np.isfinite(answer).all()
            i += 1
        ms = np.asarray(times) * 1e3
        metrics = {"latency_ms_p50.eval": float(np.percentile(ms, 50)),
                   "latency_ms_p95.eval": float(np.percentile(ms, 95))}
        if self.device.type == "cuda":
            metrics["frame_gpu_ms"] = self.gpu_ms(self.mix["gpu_frames"])
        return {"attempted": len(times), "failed": failed, "unit_ms": float(np.median(ms)),
                "metrics": metrics}

    def gpu_ms(self, n: int) -> float:
        """The device's busy ms a frame over n frames traced on the device
        alone; their answers are not kept (the window's are compared)."""
        trace = capture(lambda i: self.frame(i, keep=False), n, host=False)
        if not trace.device:
            raise RuntimeError("the device trace of the frames holds no operation")
        return trace.busy_us() / 1e3 / n

    def traced(self) -> tuple:
        """(Trace, spans) of TRACED_FRAMES frames: the benchmark's spans
        time each frame's upload (to its end on the device) and readback."""
        spans = {"upload": [], "readback": []}
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)

        def run(i):
            slot = i % len(self.ring)
            with torch.inference_mode():
                t0 = time.perf_counter()
                cur, src = program.batch_to_device(self.ring[slot], self.device)
                sync()
                t1 = time.perf_counter()
                out = self.forward(cur, src)
                sync()
                t2 = time.perf_counter()
                out.float().cpu().numpy()
                t3 = time.perf_counter()
            spans["upload"].append((t1 - t0) * 1e3)
            spans["readback"].append((t3 - t2) * 1e3)

        return capture(run, TRACED_FRAMES), spans

    def release(self) -> None:
        self.net = self.forward = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_answers(self, fp8: bool = False) -> list:
        """The reference's answer for every ring tuple, in f32 (fp8 is the
        control: bf16 autocast, its products in fp8)."""
        from port_bench import harness
        from port_bench.reference.fp8 import Fp8Products, bf16_autocast
        from port_bench.reference.nets import build_reference

        ref = build_reference(self.config).to(self.device)
        harness.init_weights(ref, self.seed)
        ref.eval()
        out = []
        low = (Fp8Products(), bf16_autocast(self.device)()) if fp8 else ()
        with torch.no_grad(), contextlib.ExitStack() as stack:
            for ctx in low:
                stack.enter_context(ctx)
            for cur_np, src_np in self.ring:
                cur, src = ({k: torch.as_tensor(v).to(self.device) for k, v in d.items()}
                            for d in (cur_np, src_np))
                if self.config["kind"] == "bd":
                    logits = ref.forward_val(cur, src)["pred_0"]
                    answer = torch.sigmoid(self.config.get("bd_sigmoid_multiplier", 1.0) * logits)
                else:
                    answer = ref(cur, src)["depth_pred_0"]
                out.append(answer.float().cpu().numpy())
        del ref
        gc.collect()
        return out

    def numbers(self, reference: list) -> dict:
        return self.gaps([self.answers[i] for i in range(len(self.ring))], reference)

