"""Image-space ops (NHWC). Counterpart of implicit_depth_tpu/ops/image.py;
only the dilation the boundary mask needs is ported."""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def max_pool_dilate(x_bhwc: Tensor, window: int) -> Tensor:
    """F.max_pool2d(window, stride=1, padding=window//2) on NHWC."""
    y = F.max_pool2d(x_bhwc.permute(0, 3, 1, 2), window, 1, padding=window // 2)
    return y.permute(0, 2, 3, 1)
