"""ray_head_roofline: kernels #3 and #4 (ops/ray_head.py, the BD
query head's forward and backward over the four scales), the least time
of their work a step (work/bounds.py at the cell's rays and samples) over
their summed device time a step.

PATTERNS is the contract: the kernels that compute #3's and #4's
functions keep names that these match, and no others do."""

from port_bench.readers import kernel_ms_per_unit, roofline_pct, shapes
from port_bench.work import bounds

PATTERNS = (r"ray_head_(fwd|bwd)(_bf16)?_kernel",
            r"sum_slabs_kernel\(float const\*, int, long long, float\*\)")


def read(r):
    s = shapes(r)
    fwd, bwd = bounds.ray_head(s["B"], s["N"], s["S"])
    return roofline_pct(fwd + bwd, kernel_ms_per_unit(r, PATTERNS))
