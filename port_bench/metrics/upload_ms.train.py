"""upload_ms.train: the host's ms a step inside the program's span
idt.upload (train/loop.py::batch_to_device, the pageable host-to-device
copy of the step's batch), median over the traced steps
(port_bench/spans.py)."""

from port_bench.spans import median_host_ms


def read(r):
    return median_host_ms(r, "idt.upload")
