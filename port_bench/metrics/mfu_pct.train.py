"""mfu_pct.train: the training step's fixed FLOPs (forward and backward,
no optimizer, no recomputation) over (step time x the card's bf16 peak),
the step time being the untraced window's."""

from port_bench.readers import mfu_pct


def read(r):
    return mfu_pct(r)
