"""Image-space ops (NHWC). Counterpart of implicit_depth_tpu/ops/image.py:
the dilation the boundary mask needs, and the normalised sobel gradient and
edge mask of the training step's sharpness regulariser. The gaussian blur,
blur pool, pyramid and normals come with the regression slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def max_pool_dilate(x_bhwc: Tensor, window: int) -> Tensor:
    """F.max_pool2d(window, stride=1, padding=window//2) on NHWC."""
    y = F.max_pool2d(x_bhwc.permute(0, 3, 1, 2), window, 1, padding=window // 2)
    return y.permute(0, 2, 3, 1)


def spatial_gradient(x_bhwc: Tensor) -> tuple[Tensor, Tensor]:
    """Normalised sobel dx, dy (kernel / 8) with replicate padding."""
    c = x_bhwc.shape[-1]
    kx = torch.tensor(_SOBEL_X, dtype=x_bhwc.dtype, device=x_bhwc.device) / 8.0
    kernel = torch.stack([kx, kx.t()])[:, None].repeat(c, 1, 1, 1)  # (2c, 1, 3, 3)
    x = F.pad(x_bhwc.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    g = F.conv2d(x, kernel, groups=c)  # channel 2i = dx of input i, 2i+1 = dy
    gx = g[:, 0::2].permute(0, 2, 3, 1)
    gy = g[:, 1::2].permute(0, 2, 3, 1)
    return gx, gy


def sobel_magnitude(x_bhwc: Tensor, eps: float = 1e-6) -> Tensor:
    gx, gy = spatial_gradient(x_bhwc)
    return torch.sqrt(gx * gx + gy * gy + eps)


def get_edge_mask(depth_bhw1: Tensor, threshold: float = 0.95, dilate: bool = True) -> Tensor:
    """Edge mask on inverse depth: sobel(1/d) above its per-image
    nanquantile (linear interpolation), optionally dilated 5x5. The
    quantile is taken per batch row: torch.nanquantile refuses inputs of
    more than 2^24 elements."""
    edge = sobel_magnitude(1.0 / depth_bhw1)
    b = edge.shape[0]
    flat = edge.reshape(b, -1)
    thr = torch.stack([torch.nanquantile(row, threshold) for row in flat]).reshape(b, 1, 1, 1)
    mask = (edge > thr).to(depth_bhw1.dtype)
    if dilate:
        mask = max_pool_dilate(mask, 5)
    return mask
