"""syncs_per_step.train: blocking waits a step (runtime or driver calls
that spans.SYNC_CALLS matches: stream, device and event synchronisations,
the non-async cudaMemcpy) that started while the units' thread was inside
the program's span idt.step (port_bench/spans.py)."""

from port_bench.spans import device_join


def read(r):
    j = device_join(r, "idt.step")
    return None if j is None else j.waits_inside("idt.step") / r.units
