"""latency_ms_p95.eval: the 95th percentile of the frame's latency on the
host clock, from its host tuple to its answer on the host, over every
frame of the untraced window: what the AR app waits (host-bound, so it
follows the host's speed, and stands per layer)."""


def read(r):
    return r.window.get("latency_ms_p95.eval")
