"""transfer_ms.eval: the host's time a frame to upload its tuple
(program.batch_to_device, to its end on the device) and to read its
answer back, median over the traced frames (the benchmark's own spans)."""

import numpy as np


def read(r):
    up, back = r.spans.get("upload"), r.spans.get("readback")
    if not up or not back or r.trace is None or not r.trace.device:
        return None
    return float(np.median(np.asarray(up) + np.asarray(back)))
