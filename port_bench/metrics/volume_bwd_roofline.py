"""volume_bwd_roofline: kernel #2 (ops/fused_volume.py, the fused
metadata volume's backward), the least time of its work a step (one launch
at the cell's shapes, work/bounds.py) over its device time a step: the
main kernel and its slab reduction.

PATTERNS is the contract: the kernels that compute #2's function keep
names that these match, and no others do. (#4's slab reduction has the
same name and one argument fewer.)"""

from port_bench.readers import kernel_ms_per_unit, roofline_pct, shapes
from port_bench.work import bounds

PATTERNS = (r"fused_volume_bwd_(bf16|f32)_kernel",
            r"sum_slabs_kernel\(float const\*, int, long long, int, float\*\)")


def read(r):
    s = shapes(r)
    least, _ = bounds.volume_bwd(s["B"], s["K"], s["H"], s["W"], s["D"])
    return roofline_pct(least, kernel_ms_per_unit(r, PATTERNS))
