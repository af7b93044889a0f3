"""The functional work of the port's six kernels at a cell's shapes, and
the card's published peaks: a frozen copy of
implicit_depth_tpu_torch/ops/bounds.py's formulas (#1-#4), with #5 and #6
counted as chip_smoke.py counts them (`_warp_timings`: bytes of the inputs
read once and the output written once; 16 FLOPs of coordinates and 4 taps
x 16 channels of multiply-adds a point, on the f32 CUDA cores).

Work is what the function needs, whatever implements it: the least time is
the larger of bytes over the memory rate and operations over the peak for
their type, and a kernel's roofline share is that least time over its
device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

MATCHING_DIM, HIDDEN = 16, 128   # C and F of kernels #1-#4
WARP_POINT_FLOPS = 16 + 4 * 16 * 2
BF16, F32 = 2, 4                 # bytes


def least_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> tuple:
    """(least ms, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _volume_operand_bytes(B: int, K: int, H: int, W: int, D: int, C: int, F: int) -> int:
    """Kernel #1's operands read once: the bf16 features of the current and
    source views, the f32 geometry (A, b, origins, invK, planes), the f32
    base map (B, H, F, W) and the weights."""
    feats = B * (K + 1) * H * W * C * BF16
    geometry = (B * K * (9 + 3 + 3) + B * 9 + D) * F32
    base = B * H * F * W * F32
    weights = (F * K * C + F) * BF16 + (F * K * 8 + F + F + 1 + 1) * F32 + F * F * BF16
    return feats + geometry + base + weights


def volume_fwd(B: int, K: int, H: int, W: int, D: int, C: int = MATCHING_DIM,
               F: int = HIDDEN) -> tuple:
    """(least ms, bound) of one launch of #1: the (B, D, H, W) f32 volume."""
    points = B * D * H * W
    nbytes = _volume_operand_bytes(B, K, H, W, D, C, F) + points * F32
    return least_ms(nbytes, 2.0 * points * volume_fwd_macs(K, C, F))


def volume_bwd(B: int, K: int, H: int, W: int, D: int, C: int = MATCHING_DIM,
               F: int = HIDDEN) -> tuple:
    """(least ms, bound) of one launch of #2: the f32 cotangent and the
    forward's operands read, a cotangent of each operand written."""
    points = B * D * H * W
    operands = _volume_operand_bytes(B, K, H, W, D, C, F)
    nbytes = points * F32 + operands + 2 * operands
    return least_ms(nbytes, 2.0 * points * volume_bwd_macs(K, C, F))


def ray_rows(b: int, n: int, s: int, scales: int = 4) -> list:
    """(ray, sample) rows of the query head at each scale: scale k takes
    every (k+1)-th of the n rays."""
    return [b * -(-n // (k + 1)) * s for k in range(scales)]


def ray_head(b: int, n: int, s: int) -> tuple:
    """(least ms of #3 over the four scales, least ms of #4 over them) of
    one training step. Bytes per row: #3 reads the bf16 depth and writes
    the bf16 logit, per ray the bf16 features (128); #4 reads those and the
    cotangent and writes the depth's and the features' cotangents."""
    fwd_ms = bwd_ms = 0.0
    for rows in ray_rows(b, n, s):
        rays = rows // s
        fb = rows * 2 * BF16 + rays * HIDDEN * BF16
        bb = rows * 3 * BF16 + rows * F32 + rays * HIDDEN * (BF16 + F32)
        fwd_ms += least_ms(fb, 2.0 * rows * ray_head_fwd_macs())[0]
        bwd_ms += least_ms(bb, 2.0 * rows * ray_head_bwd_macs())[0]
    return fwd_ms, bwd_ms


def warp(Kp: int, H: int, W: int, D: int, C: int = MATCHING_DIM) -> tuple:
    """(least ms of #5, least ms of #6) at K' = batch x views: bf16
    features in, (K', D, H, W, C) bf16 out (#5); that cotangent in and the
    source's cotangent out (#6); f32 geometry besides."""
    points = Kp * D * H * W
    src = Kp * H * W * C * BF16
    planes_out = points * C * BF16
    geometry = (Kp * 12 + D) * F32
    flops = points * WARP_POINT_FLOPS
    fwd = least_ms(src + geometry + planes_out, flops, F32_FLOP_PER_S)[0]
    bwd = least_ms(planes_out + geometry + src, flops, F32_FLOP_PER_S)[0]
    return fwd, bwd
