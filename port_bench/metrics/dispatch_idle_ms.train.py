"""dispatch_idle_ms.train: the device's idle ms a step while the units'
thread is inside the program's span idt.step (make_bd_train_step's step
after the upload: forward, loss, backward, optimizer): idle time that the
step's own host work causes, the upload not counted (port_bench/spans.py)."""

from port_bench.spans import device_join


def read(r):
    j = device_join(r, "idt.step")
    return None if j is None else j.idle_ms_inside("idt.step") / r.units
