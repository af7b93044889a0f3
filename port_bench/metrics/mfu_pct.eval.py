"""mfu_pct.eval: the eval frame's fixed FLOPs over (the device's time a
frame x the card's bf16 peak), the device's time being the window's
`frame_gpu_ms`: the whole frame's share of the peak while the device
works, which bounds the rooflines of the frame's kernels."""

from port_bench.readers import mfu_pct


def read(r):
    gpu_ms = r.window.get("frame_gpu_ms")
    return mfu_pct(r, gpu_ms) if gpu_ms else None
