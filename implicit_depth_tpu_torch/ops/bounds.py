"""The six kernels' launch counters, the work each launch does, and the
card's peaks: the one place that chip_smoke.py's bounds and
cli/roofline.py's hand count read, so that both count the same work.

Work is the kernels' functional work, not what a design spends: a bound
is the larger of the bytes a call must move (each input read once, each
output written once) over the card's memory rate and its operations over
the peak rate for their type (least_ms). Multiply-adds per point:
- #1 (fused volume forward) per (b, d, v, u): fc0 over the K (C + 6) live
  inputs, fc1, fc2 (volume_fwd_macs);
- #2 (its backward): the forward again, dh1 and dW_fc1T, dvis and dW_visT,
  dW_metaT, ddot, fc2 (volume_bwd_macs);
- #3 (ray head forward) per (ray, sample) row: fc1 and the fc0 / fc2 terms
  (ray_head_fwd_macs); #4 (its backward): ray_head_bwd_macs.
"""

from __future__ import annotations

from typing import Optional

# the card's published peaks (H100 SXM data sheet, 700 W): HBM bytes/s,
# dense bf16 tensor-core FLOP/s, and f32 FLOP/s on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
# torch.cuda.get_device_name() -> those peaks; a card not listed has none
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": dict(bf16=BF16_FLOP_PER_S, f32=F32_FLOP_PER_S,
                                           hbm=HBM_BYTES_PER_S)}

MATCHING_DIM, HIDDEN = 16, 128  # C and F of kernels #1-#4


def card_peaks(name: str) -> Optional[dict]:
    """{"bf16", "f32", "hbm"} of the card named `name`, or None."""
    return CARD_PEAKS.get(name)


def least_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> tuple:
    """(least ms, "bytes" or "operations") for the given work on this card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def volume_fwd_macs(K: int, C: int = MATCHING_DIM, F: int = HIDDEN) -> int:
    """Multiply-adds per (b, d, v, u) point of kernel #1."""
    return K * (C + 6) * F + F * F + F


def volume_bwd_macs(K: int, C: int = MATCHING_DIM, F: int = HIDDEN) -> int:
    """Multiply-adds per point of kernel #2."""
    return volume_fwd_macs(K, C, F) + 2 * F * F + 2 * K * C * F + 7 * K * F + F


def ray_head_fwd_macs(F: int = HIDDEN) -> int:
    """Multiply-adds per (ray, sample) row of kernel #3."""
    return F * F + 3 * F


def ray_head_bwd_macs(F: int = HIDDEN) -> int:
    """Multiply-adds per row of kernel #4."""
    return 3 * F * F + 8 * F


def launch_flops(volume_points: int, num_views: int, ray_rows=()) -> dict:
    """FLOPs of one launch of kernels #1-#4 on a run's shapes: {1: #1 over
    `volume_points` (b, d, v, u) points of `num_views` views, 2: #2 on the
    same, 3: [#3 at each scale s over ray_rows[s] (ray, sample) rows],
    4: [#4 likewise]}."""
    return {1: 2.0 * volume_points * volume_fwd_macs(num_views),
            2: 2.0 * volume_points * volume_bwd_macs(num_views),
            3: [2.0 * rows * ray_head_fwd_macs() for rows in ray_rows],
            4: [2.0 * rows * ray_head_bwd_macs() for rows in ray_rows]}


def kernel_flops(launches, per_launch: dict) -> tuple:
    """The FLOPs of kernels #1-#4 over a run in which they launched
    `launches` times (launch_counts(), recorded in that run), each launch
    doing per_launch's work (launch_flops); the ray head's launches walk the
    scales in turn. A kernel that did not launch counts nothing: on the CPU
    the plain versions run instead, through aten, and are counted there."""
    out = [launches[0] * per_launch[1], launches[1] * per_launch[2]]
    for i in (3, 4):
        n, scales = launches[i - 1], per_launch[i]
        if n and (not scales or n % len(scales)):
            raise ValueError(f"{n} launches of #{i} are not whole rounds of {len(scales)} scales")
        out.append(n // len(scales) * sum(scales) if n else 0.0)
    return tuple(out)


def wrappers() -> tuple:
    """The six kernel wrappers, #1 to #6; each counts its kernel's launches
    in its `launches` attribute, and nothing else."""
    from implicit_depth_tpu_torch.ops import fused_volume as fvm
    from implicit_depth_tpu_torch.ops import ray_head as rh
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    return (fvm.fused_metadata_volume, fvm.fused_metadata_volume_bwd, rh.ray_head_fwd,
            rh.ray_head_bwd, wk.warp_planes, wk.warp_planes_bwd)


def launch_counts() -> tuple:
    return tuple(fn.launches for fn in wrappers())


def reset_launch_counts() -> None:
    for fn in wrappers():
        fn.launches = 0
        if hasattr(fn, "prior_launches"):
            fn.prior_launches = 0
