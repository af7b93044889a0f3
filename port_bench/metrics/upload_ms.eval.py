"""upload_ms.eval: the host's ms a frame inside the program's span
idt.upload (train/loop.py::batch_to_device, the pageable host-to-device
copy of the frame's tuple), median over the traced frames: the program's
own counterpart of the upload half of transfer_ms.eval
(port_bench/spans.py)."""

from port_bench.spans import median_host_ms


def read(r):
    return median_host_ms(r, "idt.upload")
