"""optimizer_ms.train: device ms a step of the optimizer's kernels.

PATTERNS is the contract: a kernel that does AdamW's update keeps a name
that one of these matches (PyTorch's foreach and fused AdamW run as
multi_tensor_apply_kernel; a hand-written one has "adam" in its name)."""

from port_bench.readers import kernel_ms_per_unit

PATTERNS = (r"multi_tensor_apply_kernel", r"(?i)adam")


def read(r):
    return kernel_ms_per_unit(r, PATTERNS)
