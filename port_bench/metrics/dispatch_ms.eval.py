"""dispatch_ms.eval: the host's ms a frame inside the program's span
idt.forward_val (BDNet.forward_val: the trunk and the query-plane head
passes), median over the traced frames: the time to issue the eval
forward, which bounds the frame while the device waits on the host
(port_bench/spans.py)."""

from port_bench.spans import median_host_ms


def read(r):
    return median_host_ms(r, "idt.forward_val")
