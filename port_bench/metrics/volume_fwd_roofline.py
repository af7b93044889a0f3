"""volume_fwd_roofline: kernel #1 (ops/fused_volume.py, the fused
metadata volume's forward), the least time of its work a frame (one launch
at the cell's shapes, work/bounds.py) over its device time a frame.

PATTERNS is the contract: the kernels that compute #1's function keep
names that these match, and no others do."""

from port_bench.readers import kernel_ms_per_unit, roofline_pct, shapes
from port_bench.work import bounds

PATTERNS = (r"fused_volume(_bf16)?_kernel",)


def read(r):
    s = shapes(r)
    least, _ = bounds.volume_fwd(s["B"], s["K"], s["H"], s["W"], s["D"])
    return roofline_pct(least, kernel_ms_per_unit(r, PATTERNS))
