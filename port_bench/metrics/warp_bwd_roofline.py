"""warp_bwd_roofline: kernel #6 (ops/warp_kernel.py::warp_planes_bwd, the
warp's transpose, which carries the warped views' cotangent back to the
source views' matching features in the regression step's backward), the
least time of its work a step (work/bounds.py::warp at K' = batch x source
views) over its device time a step.

PATTERNS is the contract: the kernels that compute #6's function keep
names that these match, and no others do."""

from port_bench.readers import kernel_ms_per_unit, roofline_pct, shapes
from port_bench.work import bounds

PATTERNS = (r"warp_planes_bwd_kernel",)


def read(r):
    s = shapes(r)
    _, least = bounds.warp(s["B"] * s["K"], s["H"], s["W"], s["D"])
    return roofline_pct(least, kernel_ms_per_unit(r, PATTERNS))
