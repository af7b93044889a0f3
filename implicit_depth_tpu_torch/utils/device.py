"""The batch upload, through which every caller moves a host batch to the
net's device: training, validation, the eval loops and the AR app."""

from __future__ import annotations

import torch

from implicit_depth_tpu_torch.utils.profiling import UPLOAD_BYTES, span


def _to_device(v, device: torch.device) -> torch.Tensor:
    """One host array as a tensor on `device`, with the same dtype, shape,
    strides and values as torch.as_tensor(v).to(device). On CUDA by pinned
    staging and an asynchronous copy: the array is copied into a pinned
    block of torch's caching host allocator (torch's parallel CPU copy),
    and the block's copy to the card is issued on the current stream
    without a wait. The allocator records an event on that stream for the
    copy and hands the block out again only once the copy has finished, so
    the caller may overwrite `v` as soon as this returns. Elsewhere the
    plain copy. UPLOAD_BYTES counts the bytes under the path taken."""
    t = torch.as_tensor(v)
    if device.type != "cuda":
        UPLOAD_BYTES["pageable"] += t.nbytes
        return t.to(device)
    pinned = torch.empty_like(t, pin_memory=True)
    pinned.copy_(t)
    UPLOAD_BYTES["pinned"] += t.nbytes
    return pinned.to(device, non_blocking=True)


def batch_to_device(batch, device: torch.device) -> tuple[dict, dict]:
    """A collated numpy (cur, src) batch as tensors on `device`, without
    "frame_id_string": on CUDA by pinned staging and asynchronous copies,
    each key's copy issued as soon as it is staged, so the host stages the
    next key while the card copies this one (_to_device). Returns once
    every array has been read; the copies may still be running, in stream
    order before the work that reads them."""
    with span("idt.upload"):
        return tuple({k: _to_device(v, device) for k, v in d.items()
                      if k != "frame_id_string"} for d in batch)
