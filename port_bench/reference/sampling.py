"""Frozen plain copy of implicit_depth_tpu_torch/core/sampling.py for the benchmark's
f32 reference; it imports nothing of the port. Unchanged.

Image sampling with `F.grid_sample` semantics (NHWC, zeros padding).

Counterpart of implicit_depth_tpu/core/sampling.py. Index space: a
coordinate of exactly `i` hits pixel `i`'s centre, so a warp that produces
+0.5-centred pixel coordinates `u` samples at `u - 0.5`; normalised
coordinates follow `align_corners=False`. The JAX package samples one
image at a time under `vmap`; here the batch dimension is written out.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _gather_nhwc(img_nhwc: Tensor, ix: Tensor, iy: Tensor) -> Tensor:
    """Pixels of image n at integer (ix[n, ...], iy[n, ...]), zeros outside.
    img (N, H, W, C); ix/iy (N, *S) integer -> (N, *S, C)."""
    n, h, w, c = img_nhwc.shape
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat_idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    flat_idx = flat_idx.reshape(n, -1, 1).expand(-1, -1, c)
    vals = torch.gather(img_nhwc.reshape(n, h * w, c), 1, flat_idx)
    vals = vals.reshape(ix.shape + (c,))
    return vals * inb[..., None].to(img_nhwc.dtype)


def sample_bilinear_idx(img_nhwc: Tensor, x_idx: Tensor, y_idx: Tensor) -> Tensor:
    """Bilinear sample at index-space coords, zeros padding.
    img (N, H, W, C); x/y (N, *S) float -> (N, *S, C)."""
    x0 = torch.floor(x_idx)
    y0 = torch.floor(y_idx)
    dx = (x_idx - x0).to(img_nhwc.dtype)[..., None]
    dy = (y_idx - y0).to(img_nhwc.dtype)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    v00 = _gather_nhwc(img_nhwc, x0i, y0i)
    v01 = _gather_nhwc(img_nhwc, x0i + 1, y0i)
    v10 = _gather_nhwc(img_nhwc, x0i, y0i + 1)
    v11 = _gather_nhwc(img_nhwc, x0i + 1, y0i + 1)
    top = v00 * (1.0 - dx) + v01 * dx
    bot = v10 * (1.0 - dx) + v11 * dx
    return top * (1.0 - dy) + bot * dy


def sample_nearest_idx(img_nhwc: Tensor, x_idx: Tensor, y_idx: Tensor) -> Tensor:
    """Nearest sample, zeros padding; rounds half to even like torch."""
    return _gather_nhwc(img_nhwc, torch.round(x_idx).long(), torch.round(y_idx).long())


def unnormalize_coords(grid_norm: Tensor, height: int, width: int,
                       align_corners: bool = False) -> tuple[Tensor, Tensor]:
    """(..., 2) normalised (x, y) in [-1, 1] -> index-space (x, y)."""
    gx, gy = grid_norm[..., 0], grid_norm[..., 1]
    if align_corners:
        return (gx + 1.0) * 0.5 * (width - 1), (gy + 1.0) * 0.5 * (height - 1)
    return ((gx + 1.0) * width - 1.0) * 0.5, ((gy + 1.0) * height - 1.0) * 0.5


def grid_sample(image_bhwc: Tensor, grid_norm: Tensor, mode: str = "bilinear",
                align_corners: bool = False) -> Tensor:
    """grid_sample on NHWC images: image (B, H, W, C), grid (B, ..., 2)
    -> (B, ..., C)."""
    h, w = image_bhwc.shape[1], image_bhwc.shape[2]
    x, y = unnormalize_coords(grid_norm, h, w, align_corners)
    fn = sample_bilinear_idx if mode == "bilinear" else sample_nearest_idx
    return fn(image_bhwc, x, y)
