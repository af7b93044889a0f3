"""Runs one cell of the benchmark once and prints its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the program,
`implicit_depth_tpu_torch`. In order: the program's kernels are built (or
found built inside the checkout), the cell's driver makes its host inputs
and seeded weights and warms up its own shapes (set-up, `setup_s`), then
the window measures for --seconds. With --trace 1 a short traced
sub-window follows and the per-layer metrics are read from it. Then the
program's state is freed and its outputs are held to the f32 reference.
The last line of standard output is one JSON object; the numbers compared
stand beside their limits as the last lines of standard error.

A run without a CUDA card, with fewer cards than the cell asks for, or in
which JAX or the JAX package was loaded, prints no result and exits
non-zero."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(chips: int):
    """The run's device; raises without enough CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise harness.BenchError("no CUDA card: the benchmark measures the port on the card "
                                 "and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise harness.BenchError(f"the cell asks for {chips} cards, "
                                 f"{torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def run(args, device=None, cell=None, t0: float = T0) -> tuple:
    """One run of a cell: (result line, check lines). `device` None looks
    for the card; the CPU tests pass the CPU and a cell at a small size."""
    os.environ.update(harness.cache_env())
    import torch

    from port_bench import compare, program
    from port_bench.readers import Readings

    cell = cell if cell is not None else harness.Cell(args.workload)
    seed = args.seed % 2**63
    marks = [("imports", time.perf_counter())]
    if device is None:
        device = card(cell.workload["chips"])
        program.build_kernels()
        marks.append(("card and kernels", time.perf_counter()))
    driver = cell.driver().Driver(cell, seed, device)
    driver.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("inputs, net and warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    last = t0
    for what, at in marks:
        print(f"set-up: {what} {at - last:.3f} s", file=sys.stderr)
        last = at
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    res = driver.window(args.seconds)
    metrics, breakdown, dev = {}, None, {}
    if args.trace:
        trace, spans = driver.traced()
        n = len(trace.units)
        readings = Readings(cell.config, cell.mix, trace, n, res["unit_ms"], spans,
                            res["metrics"])
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = trace.breakdown()
        dev = {"busy_s": trace.busy_us() / 1e6, "window_s": trace.window_us / 1e6}
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.workload["chips"] if cuda else 0,
                   "memory_peak_bytes": int(peak), **dev}

    driver.release()
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is true f32
    torch.backends.cudnn.allow_tf32 = False
    numbers = driver.numbers(driver.reference_answers())
    correct, checks = compare.judge(numbers, cell.mix["limits"])
    correct = correct and res["failed"] == 0
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    line = harness.result_line(correct, res["attempted"], res["failed"], metrics, device_info,
                               checks, breakdown)
    return line, lines


def main(argv=None) -> int:
    args = parse(argv)
    try:
        line, checks = run(args)
    except harness.BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_loaded()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
