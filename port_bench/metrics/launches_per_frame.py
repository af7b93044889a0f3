"""launches_per_frame: device kernels a frame in the trace (copies and
sets not counted): the host dispatch's count of work."""


def read(r):
    if r.trace is None or r.units <= 0:
        return None
    n = len(r.trace.kernels())
    return n / r.units if n else None
