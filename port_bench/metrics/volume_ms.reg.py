"""volume_ms.reg: the device ms a step of the operations launched while
the program's span idt.trunk.volume was open, at any depth (DepthNet's
cost volume in the forward: the warp (#5) in idt.trunk.warp, the unfused
metadata MLP over the warped views and the lowest-cost depth), over the
traced steps (port_bench/spans.py). The volume's backward is launched in
idt.step.backward and is not counted here."""

from port_bench.spans import device_join

SPANS = ("idt.trunk.volume", "idt.trunk.warp")


def read(r):
    j = device_join(r, SPANS[0])
    if j is None:
        return None
    return sum(op.dur for op, label in j.op_labels() if label in SPANS) / 1e3 / r.units
