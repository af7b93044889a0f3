"""Runs one cell's traced sub-window with the program's stage spans joined
to the device trace, and prints the stage table and the span metrics.

    python3 port_bench/stages.py --workload <name> --seed <n> [--seconds <s>]

From the root of a checkout, as run.py: the program's kernels are built
(or found built), the cell's driver sets up and runs a window of --seconds
(to settle; nothing of it is read), then the driver's own traced
sub-window (its `traced`, as run.py --trace 1 runs it) is captured with
spans.capture, which keeps the program's spans and the launch calls. No
reference check runs.

Standard error: one `stage` line per program span, then `(outside)` and
`(unattributed)`, per frame or step (port_bench/spans.py): the span's host
ms (inclusive), the device ms and kernels it launched, the device's idle ms
while it was the innermost span, and the blocking waits that started in it.
The last line of standard output is one JSON object: the same table with
each line's three longest device operations, the blocking waits by span
and call, the longest idle gaps with the span open and the host operation
running at their middle, the metrics of spans.METRICS that the cell
reports, every per-layer metric BENCHMARK.json gives the cell, each traced
unit's host ms, and the card."""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness, spans  # noqa: E402

GAPS = 10  # the longest idle gaps listed


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    return p.parse_args(argv)


def run(args, device=None, cell=None) -> tuple:
    """(result, stage lines) of one cell's traced sub-window. `device` None
    looks for the card; the CPU tests pass the CPU and a small cell."""
    os.environ.update(harness.cache_env())
    import torch

    from port_bench import program
    from port_bench.readers import Readings
    from port_bench.run import card

    cell = cell if cell is not None else harness.Cell(args.workload)
    if device is None:
        device = card(cell.workload["chips"])
        program.build_kernels()
    module = cell.driver()
    driver = module.Driver(cell, args.seed % 2**63, device)
    driver.setup()
    res = driver.window(args.seconds)
    module.capture = spans.capture           # the driver's traced() keeps spans and calls
    trace, bench_spans = driver.traced()
    n = len(trace.units)
    r = Readings(cell.config, cell.mix, trace, n, res["unit_ms"], bench_spans, res["metrics"])
    metrics = {}
    for m in cell.per_layer + [m for m in spans.METRICS if cell.name in m["workloads"]]:
        value = cell.metric_reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = float(value)
    j = spans.join(trace)
    table = j.table() if j is not None else {}
    waits = Counter((j.label(c.ts), c.name) for c in j.waits()) if j is not None else Counter()
    gaps = sorted(trace.idle_gaps(), key=lambda g: -g[1])[:GAPS]
    cuda = device.type == "cuda"
    out = {"workload": cell.name, "seed": args.seed, "unit": driver.unit, "units": n,
           "window_ms_per_unit": trace.window_us / 1e3 / n,
           "busy_ms_per_unit": trace.busy_us() / 1e3 / n,
           "unit_host_ms": [u.dur / 1e3 for u in trace.units],
           "stages": {label: s.per_unit(n) for label, s in table.items()},
           "waits": [[label, call, k / n] for (label, call), k in waits.most_common()],
           "idle_gaps": [[j.label(g + length / 2) if j is not None else spans.OUTSIDE,
                          trace.host_activity(g + length / 2)[:120], length / 1e3]
                         for g, length in gaps],
           "metrics": metrics,
           "card": torch.cuda.get_device_name(device) if cuda else "cpu"}
    return out, spans.format_table(table, n, driver.unit)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        out, lines = run(args)
    except harness.BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
