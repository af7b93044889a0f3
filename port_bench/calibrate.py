"""The readings that the limits of `correct` are set from, for one cell,
on the card, in one process: for each seed the program's numbers against
the f32 reference (a sound run: set-up, a short window, the check), and on
the first seeds the control's (the reference in fp8 in the program's
place) and each named fault's (faults.py, planted under the program). One
JSON line a reading on standard output, and a summary of each number's
largest sound reading and smallest control and fault reading. With
--dump, a training cell's records (each step's loss and every leaf's
norms) go to a JSON-lines file, one a reading, the reference's included.

    python3 port_bench/calibrate.py <workload> --seeds 12 --control-seeds 4 \\
        [--faults half_batch,volume_bwd_doubled] [--first N] [--dump FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def reading(cell, seed: int, device, fault=None, window_s: float = 2.0) -> tuple:
    import torch

    from port_bench import faults

    ctx = getattr(faults, fault)() if fault else None
    driver = cell.driver().Driver(cell, seed, device)
    t0 = time.perf_counter()
    if ctx is not None:
        with ctx:
            driver.setup()
            driver.window(window_s)
    else:
        driver.setup()
        driver.window(window_s)
    driver.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = driver.reference_answers()
    t1 = time.perf_counter()
    out = {"seed": seed, "kind": fault or "program", "numbers": driver.numbers(ref),
           "seconds": t1 - t0}
    return out, driver, ref


def _record(rec) -> dict:
    return {"losses": rec.losses, "grad_norms": rec.grad_norms,
            "change_norms": rec.change_norms, "stat_norms": rec.stat_norms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workload")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=4)
    p.add_argument("--faults", default=None,
                   help="comma-separated faults.py names (default: half_batch on a "
                        "training cell, none on an eval cell)")
    p.add_argument("--first", type=int, default=2**31 + 101)
    p.add_argument("--dump", default=None)
    args = p.parse_args(argv)
    from port_bench import harness
    os.environ.update(harness.cache_env())
    import torch

    from port_bench import program

    device = torch.device("cuda", 0)
    program.build_kernels()
    cell = harness.Cell(args.workload)
    train = cell.mix["driver"] == "train_step"
    if args.faults is None:
        fault_names = ["half_batch"] if train else []
    else:
        fault_names = [f for f in args.faults.split(",") if f]
    dump = open(args.dump, "w") if args.dump and train else None

    def keep(row, rec=None):
        rows.append(row)
        print(json.dumps(row), flush=True)
        if dump is not None and rec is not None:
            dump.write(json.dumps({"seed": row["seed"], "kind": row["kind"],
                                   "record": _record(rec)}) + "\n")
            dump.flush()

    rows = []
    for i in range(args.seeds):
        seed = args.first + i
        row, driver, ref = reading(cell, seed, device)
        keep(row, driver.record if train else None)
        if dump is not None:
            dump.write(json.dumps({"seed": seed, "kind": "reference",
                                   "record": _record(ref)}) + "\n")
        if i < args.control_seeds:
            t0 = time.perf_counter()
            ctl = driver.reference_answers(fp8=True)
            keep({"seed": seed, "kind": "control", "numbers": driver.gaps(ctl, ref),
                  "seconds": time.perf_counter() - t0}, ctl if train else None)
            for fault in fault_names:
                row, fdriver, _ = reading(cell, seed, device, fault=fault)
                keep(row, fdriver.record if train else None)
        torch.cuda.empty_cache()
    if dump is not None:
        dump.close()
    summary = {}
    for kind in ["program", "control"] + fault_names:
        sel = [r["numbers"] for r in rows if r["kind"] == kind]
        if sel:
            agg = max if kind == "program" else min
            summary[kind] = {k: agg(s[k] for s in sel) for k in sel[0]}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "card": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
