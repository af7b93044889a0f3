"""device_idle_pct.eval: the share of the traced frames' time in which no
operation (kernel, copy or set) ran on the device."""

from port_bench.readers import idle_pct


def read(r):
    return idle_pct(r)
