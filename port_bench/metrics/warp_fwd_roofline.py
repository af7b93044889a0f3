"""warp_fwd_roofline: kernel #5 (ops/warp_kernel.py::warp_planes, the
plane-sweep warp of the source views' matching features that
volumes/cost_volume.py::build_warped_views runs in DepthNet's forward),
the least time of its work a step (work/bounds.py::warp at K' = batch x
source views) over its device time a step.

PATTERNS is the contract: the kernels that compute #5's function keep
names that these match, and no others do (#6 is warp_planes_bwd_kernel)."""

from port_bench.readers import kernel_ms_per_unit, roofline_pct, shapes
from port_bench.work import bounds

PATTERNS = (r"warp_planes_kernel",)


def read(r):
    s = shapes(r)
    least, _ = bounds.warp(s["B"] * s["K"], s["H"], s["W"], s["D"])
    return roofline_pct(least, kernel_ms_per_unit(r, PATTERNS))
