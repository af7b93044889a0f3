"""Image-space ops (NHWC). Counterpart of implicit_depth_tpu/ops/image.py:
the dilation the boundary mask needs, the normalised sobel gradient and edge
mask of the BD step's sharpness regulariser, and the gaussian blur, blur
pool, pyramid and depth normals of the regression losses. Padding follows
the JAX package: replicate for the sobel, reflect for the blurs."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from implicit_depth_tpu_torch.core import geometry

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


def _depthwise(x_bhwc: Tensor, kernel_hw: np.ndarray, pad_mode: str) -> Tensor:
    """The same (kh, kw) kernel on every channel, "same" size with
    `pad_mode` padding ("reflect" or "replicate")."""
    kh, kw = kernel_hw.shape
    c = x_bhwc.shape[-1]
    k = torch.tensor(kernel_hw, dtype=x_bhwc.dtype, device=x_bhwc.device)
    x = F.pad(x_bhwc.permute(0, 3, 1, 2), (kw // 2, kw // 2, kh // 2, kh // 2), mode=pad_mode)
    y = F.conv2d(x, k[None, None].expand(c, 1, kh, kw), groups=c)
    return y.permute(0, 2, 3, 1)


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def gaussian_blur(x_bhwc: Tensor, kernel_size: int = 5, sigma: float = 2.0) -> Tensor:
    """Separable gaussian blur, reflect padding: along W, then along H."""
    k1 = _gaussian_kernel1d(kernel_size, sigma)
    return _depthwise(_depthwise(x_bhwc, k1[None, :], "reflect"), k1[:, None], "reflect")


_BINOMIAL3 = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0


def blur_pool(x_bhwc: Tensor) -> Tensor:
    """3x3 binomial blur (reflect padding), then every second row and
    column."""
    return _depthwise(x_bhwc, _BINOMIAL3, "reflect")[:, ::2, ::2]


def pyrdown(x_bhwc: Tensor, num_scales: int = 4) -> list:
    """[x, blur_pool(x), blur_pool(blur_pool(x)), ...], num_scales levels."""
    out = [x_bhwc]
    for _ in range(num_scales - 1):
        out.append(blur_pool(out[-1]))
    return out


def normals_from_depth(depth_bhw1: Tensor, invK_b44: Tensor) -> Tensor:
    """Surface normals (b, h, w, 3) of a depth map: gaussian blur (5, 2.0),
    backprojection, sobel gradients of the points, their cross product,
    normalised."""
    depth_s = gaussian_blur(depth_bhw1, 5, 2.0)
    pts = geometry.backproject_depth(depth_s[..., 0], invK_b44)[..., :3]
    gx, gy = spatial_gradient(pts)
    n = torch.cross(gx, gy, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
