"""Per-section roofline of the dense eval forward and of the BD train step
on the card (counterpart of scripts/roofline.py).

    python -m implicit_depth_tpu_torch.cli.roofline [--batch 1] [--iters 20] \
        [--train] [--json] [--device cuda]

Eval mode (default): the cumulative probes of cli/profile_eval.py (the
flagship BDNet in eval at bf16, b=1); each section is the delta of two
probes, forward_val the whole forward. Train mode (--train; b=12 and 8
rounds unless given): the probes full, zero_volume and trunk_zero of
cli/profile_train.py, and the sections conv stacks (the trunk, forward and
backward) = trunk_zero, ray head + loss = zero_volume - trunk_zero, volume
block = full - zero_volume, full step = full.

Timing: --iters rounds, each one synchronised call of every probe in turn;
a section's ms is the median over the rounds of its per-round sum of
differences. Taking turns puts a drift in the host's speed on every probe
alike, and the differences cancel it: the eval forward waits on the host
most of the time, and two runs of the same probe minutes apart differ by
more than a small section takes.

Per section: ms; GFLOP and GB; TFLOP/s and GB/s; the share of the card's
bf16 tensor-core peak and of its HBM rate; and the wall it sits against
(compute where its FLOP per byte exceeds the card's ridge, else HBM). The
peaks are ops/bounds.py's, by torch.cuda.get_device_name(); a card it does
not list gets no shares and no wall.

Counting. Each probe's first call runs under utils/profiling.compile_log:
FlopCounterMode counts the aten matrix products and convolutions, and
ByteCounter the bytes each aten operation reads and writes (eager PyTorch
fuses nothing). Kernels #1-#4 are ctypes calls that neither counter sees.
Their work is added by hand: each kernel's functional work per launch
(ops/bounds.py::launch_flops, the same count as chip_smoke.py's bounds)
times the launches the wrappers' counters recorded in that call. On the
CPU the plain versions run through aten instead, the counters see them,
and no launch is recorded, so nothing is counted twice. The kernels' own
bytes are not added (at the flagship's shapes a few MB a launch, against
the GB of aten traffic around them). The ray head's rows per scale come
from the step's sampled depths, through models/bd_net.py::
prior_noise_shapes (scale s takes every (s+1)-th ray).

The JAX script's volume_kernel_handcount is not ported: it counted the
TPU kernel's one-hot gather matmuls, plane groups and padding, the costs of
that design rather than the function's work. The device defaults to
cuda; --device cpu runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from implicit_depth_tpu_torch.cli import profile_eval, profile_train
from implicit_depth_tpu_torch.models.bd_net import prior_noise_shapes
from implicit_depth_tpu_torch.ops.bounds import (card_peaks, kernel_flops, launch_counts,
                                                 launch_flops, reset_launch_counts)
from implicit_depth_tpu_torch.utils.profiling import card_name_and_limit, compile_log, force_sync

TRAIN_PROBES = ("full", "zero_volume", "trunk_zero")


def peaks_of(device):
    device = torch.device(device)
    return card_peaks(torch.cuda.get_device_name(device)) if device.type == "cuda" else None


def work_of(net, cur: dict, src: dict) -> dict:
    """ops/bounds.py::launch_flops on this batch: the volume's (b, d, v, u)
    points at the matching resolution, the source views and, with
    sampled depths in the batch, the ray head's rows per scale."""
    b, h, w = cur["image"].shape[:3]
    scale = 2 ** (net.matching_scale + 1)
    rays = cur.get("sampled_depths")
    rows = [] if rays is None else [b_ * n * s for b_, n, s in prior_noise_shapes(rays.shape)]
    return launch_flops(b * net.num_depth_bins * (h // scale) * (w // scale),
                        src["image"].shape[1], rows)


def counted(fn, args: tuple, name: str, per_launch: dict) -> dict:
    """fn(*args) once under compile_log: aten FLOPs and bytes, the kernel
    launches it recorded and their hand-counted FLOPs (#1-#4)."""
    reset_launch_counts()
    info = compile_log(fn, *args, name=name)
    launches = launch_counts()
    return {"flops": info["flops"], "bytes": info["bytes_accessed"],
            "first_call_s": info["first_call_s"], "launches": launches,
            "kernel_flops": kernel_flops(launches, per_launch)}


def section_row(name: str, ms: float, flops: float, kernel_flops_: float, nbytes: float,
                peaks) -> dict:
    """One section's roofline: `flops` (aten and kernels together) and
    `nbytes` over `ms`, against `peaks` (None: no shares, no wall)."""
    s = ms / 1e3
    tflops = flops / s / 1e12 if s > 0 else 0.0
    gbs = nbytes / s / 1e9 if s > 0 else 0.0
    row = dict(section=name, ms=ms, gflop=flops / 1e9, kernel_gflop=kernel_flops_ / 1e9,
               gb=nbytes / 1e9, tflops=tflops, gbs=gbs, bf16_pct=float("nan"),
               hbm_pct=float("nan"), bound="-")
    if peaks:
        row["bf16_pct"] = 100.0 * tflops * 1e12 / peaks["bf16"]
        row["hbm_pct"] = 100.0 * gbs * 1e9 / peaks["hbm"]
        if nbytes > 0:
            row["bound"] = "compute" if flops / nbytes > peaks["bf16"] / peaks["hbm"] else "HBM"
    return row


def timed_rounds(fns: dict, args: tuple, rounds: int) -> dict:
    """{probe: [ms of one synchronised call, a round each]}: the probes in
    turn, round after round, so that a drift in the host's speed (the eval
    forward waits on the host most of the time) falls on every probe alike
    and cancels in the sections' differences."""
    ms = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            force_sync(fn(*args))
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return ms


def _rows(sections: list, probes: dict, peaks) -> list:
    """sections: [(name, {probe: sign})] -> rows of the signed sums; a
    section's ms is the median over rounds of its per-round sum."""
    rows = []
    for name, terms in sections:
        def total(key):
            return sum(sign * probes[p][key] for p, sign in terms.items())
        ms = float(np.median(np.sum([sign * np.asarray(probes[p]["round_ms"])
                                     for p, sign in terms.items()], axis=0)))
        kf = sum(sign * sum(probes[p]["kernel_flops"]) for p, sign in terms.items())
        rows.append(section_row(name, ms, total("flops") + kf, kf, total("bytes"), peaks))
    return rows


def eval_roofline(net, cur: dict, src: dict, rounds: int, peaks) -> dict:
    """{"rows", "probes": {probe: counted(...) with "round_ms"}, "work"} of
    the eval probes on an eval-mode net."""
    work = work_of(net, cur, src)
    fns = dict(profile_eval.probes(net))
    with torch.inference_mode():
        probes = {name: counted(fn, (cur, src), name, work) for name, fn in fns.items()}
        for name, ms in timed_rounds(fns, (cur, src), rounds).items():
            probes[name]["round_ms"] = ms
    names = list(fns)
    sections = [(names[0], {names[0]: 1})]
    sections += [(name, {name: 1, prev: -1}) for prev, name in zip(names[:-2], names[1:-1])]
    sections.append(("forward_val", {"forward_val": 1}))
    return {"rows": _rows(sections, probes, peaks), "probes": probes, "work": work}


def train_roofline(batch: tuple, rounds: int, build_net, peaks) -> dict:
    """The same for cli/profile_train.py's full, zero_volume and trunk_zero
    probes, each on a fresh net from build_net(feature_volume_type) and a
    fresh AdamW; the three live together so that their steps can take
    turns."""
    steps = {name: profile_train.make_probe(name, build_net) for name in TRAIN_PROBES}
    work = work_of(steps["full"][0], *batch)
    fns = {name: step for name, (_, step) in steps.items()}
    probes = {name: counted(fn, (batch,), name, work) for name, fn in fns.items()}
    for name, ms in timed_rounds(fns, (batch,), rounds).items():
        probes[name]["round_ms"] = ms
    del steps, fns
    if batch[0]["image"].is_cuda:
        torch.cuda.empty_cache()
    sections = [("conv stacks f+b (trunk)", {"trunk_zero": 1}),
                ("ray head + loss f+b", {"zero_volume": 1, "trunk_zero": -1}),
                ("volume block f+b", {"full": 1, "zero_volume": -1}),
                ("full step", {"full": 1})]
    return {"rows": _rows(sections, probes, peaks), "probes": probes, "work": work}


def _print(res: dict, card: str, peaks) -> None:
    print(f"card: {card}")
    if peaks:
        print(f"peaks: {peaks['bf16'] / 1e12:.0f} bf16 TFLOP/s, {peaks['hbm'] / 1e9:.0f} GB/s HBM")
    print(f"{'section':>24} {'ms':>8} {'GFLOP':>9} {'kern.':>8} {'GB':>8} {'TFLOP/s':>8} "
          f"{'GB/s':>7} {'bf16%':>6} {'HBM%':>6}  wall")
    for r in res["rows"]:
        print(f"{r['section']:>24} {r['ms']:>8.2f} {r['gflop']:>9.2f} {r['kernel_gflop']:>8.2f} "
              f"{r['gb']:>8.3f} {r['tflops']:>8.2f} {r['gbs']:>7.1f} {r['bf16_pct']:>6.1f} "
              f"{r['hbm_pct']:>6.1f}  {r['bound']}")
    print("kernel launches #1-#6 in each probe's counted call: " + ", ".join(
        f"{name} {p['launches']}" for name, p in res["probes"].items()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None, help="1 (eval) or 12 (--train)")
    ap.add_argument("--iters", type=int, default=None,
                    help="rounds of one call of each probe: 20 (eval) or 8 (--train)")
    ap.add_argument("--train", action="store_true",
                    help="roofline the training step's ablation sections")
    ap.add_argument("--json", action="store_true", help="also print a JSON line")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    batch_size = args.batch or (12 if args.train else 1)
    iters = args.iters or (8 if args.train else 20)

    peaks = peaks_of(args.device)
    card = card_name_and_limit(args.device)
    if args.train:
        batch = profile_eval.synthetic_batch(batch_size, args.device, with_train_keys=True)
        res = train_roofline(batch, iters, lambda v: profile_eval.flagship_net(args.device, v),
                             peaks)
    else:
        net = profile_eval.flagship_net(args.device).eval().cast_to_compute_dtype()
        cur, src = profile_eval.synthetic_batch(batch_size, args.device, with_train_keys=False)
        res = eval_roofline(net, cur, src, iters, peaks)
    print(f"batch={batch_size} rounds={iters} {'train' if args.train else 'eval'}")
    _print(res, card, peaks)
    res.update(batch=batch_size, train=args.train, card=card)
    if args.json:
        print(json.dumps({"batch": batch_size, "train": args.train, "card": card,
                          "rows": res["rows"]}))
    return res


if __name__ == "__main__":
    main()
