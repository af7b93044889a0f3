"""Counts the FLOPs of a cell's frame or step once, from the f32
reference at the cell's shapes on fake tensors (no memory, no time),
with torch.utils.flop_counter.FlopCounterMode: convolutions and matrix
products, forward and, for a training cell, backward; not the optimizer,
not recomputation, not elementwise work. The count is stored in the cell's
mix file as `flops_per_unit`, so that no change to the program moves the
`mfu` metrics' yardstick.

    python3 port_bench/work/count_flops.py <workload> [--write]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def count(cell) -> float:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench import traffic
    from port_bench.reference.nets import build_reference

    host = traffic.make_ring(0, dict(cell.mix, ring=1), cell.config)[0]
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        ref = build_reference(cell.config)
        cur, src = ({k: fake.from_tensor(torch.as_tensor(v)) for k, v in d.items()} for d in host)
        return _count(cell, ref, cur, src)


def _count(cell, ref, cur, src) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.steps import LOSSES

    with FlopCounterMode(display=False) as counter:
        if cell.mix["driver"] == "train_step":
            LOSSES[cell.config["kind"]](ref, (cur, src), False, cell.config).backward()
        else:
            ref.eval()
            with torch.no_grad():
                if cell.config["kind"] == "bd":
                    ref.forward_val(cur, src)
                else:
                    ref(cur, src)
    return float(counter.get_total_flops())


def main(argv=None) -> int:
    from port_bench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workload")
    p.add_argument("--write", action="store_true", help="store the count in the mix file")
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    flops = count(cell)
    print(f"{args.workload}: {flops:.6e} FLOPs a {cell.mix['driver'].split('_')[-1]}")
    if args.write:
        path = cell.bench_dir / "mixes" / f"{cell.workload['traffic']}.json"
        mix = json.loads(path.read_text())
        mix["flops_per_unit"] = flops
        path.write_text(json.dumps(mix, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
