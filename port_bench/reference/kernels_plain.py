"""Frozen plain versions of the port's six kernels, in f32, for the
benchmark's reference: copies of the plain versions that sit beside each
kernel in implicit_depth_tpu_torch/ops/ (`fused_metadata_volume_reference`,
`ray_head_reference`, `warp_planes_reference`) with their bf16 rounding
points taken out. The backward kernels (#2, #4, #6) have no copy here:
autograd differentiates these forwards. Imports nothing of the port."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from port_bench.reference.sampling import sample_bilinear_idx

Tensor = torch.Tensor


def fused_volume(cur: Tensor, src: Tensor, A: Tensor, b: Tensor, origins: Tensor, invK: Tensor,
                 planes: Tensor, base: Tensor, w_visT: Tensor, w_metaT: Tensor, w_plane: Tensor,
                 w_fc1T: Tensor, b_fc1: Tensor, w_fc2: Tensor, b_fc2: Tensor) -> Tensor:
    """Kernel #1's function (and, under autograd, #2's): warp, metadata and
    MLP over the kernel's operands, (B, D, H, W) f32."""
    from port_bench.reference.cost_volume import warped_views_from_components

    cur, src = cur.float(), src.float()
    B, K, H, W, C = src.shape
    D = planes.shape[0]
    no_pose = torch.zeros((B, K, 3), dtype=torch.float32, device=src.device)
    wv = warped_views_from_components(cur, src, A, b, origins, invK, planes, no_pose,
                                      compute_dtype=torch.float32)
    vis = wv.feats.permute(0, 2, 3, 4, 1, 5).reshape(B, D, H, W, K * C)
    zero = torch.zeros_like(wv.depths)
    meta = torch.stack([wv.depths, wv.dot, wv.ray_angle, wv.src_rays[..., 0],
                        wv.src_rays[..., 1], wv.src_rays[..., 2], zero, zero], dim=-1)
    meta = meta.permute(0, 2, 3, 4, 1, 5).reshape(B, D, H, W, K * 8)
    acc = base.permute(0, 1, 3, 2)[:, None]
    acc = acc + planes[None, :, None, None, None] * w_plane[:, 0]
    acc = acc + vis @ w_visT.float().t() + meta @ w_metaT.t()
    h1 = F.leaky_relu(acc, 0.01)
    h2p = h1 @ w_fc1T.float().t() + b_fc1[:, 0]
    return (F.leaky_relu(h2p, 0.01) @ w_fc2 + b_fc2)[..., 0]


def ray_head(fp: Tensor, depths: Tensor, prior: Optional[Tensor], k0d: Tensor,
             k0p: Optional[Tensor], w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """Kernel #3's function (and, under autograd, #4's): the elu-MLP over
    (ray, sample) rows, (b, N, S) logits."""
    z = fp.float()[:, :, None, :] + depths.float()[..., None] * k0d.float()
    if prior is not None:
        z = z + prior.float()[..., None] * k0p.float()
    h2 = F.elu(F.elu(z) @ w1.float() + b1.float())
    return (h2 @ w2.float() + b2.float())[..., 0]


def sample_coords(A: Tensor, b: Tensor, planes: Tensor, H: int, W: int) -> tuple:
    """Index-space sample coordinates (x, y) of every output point of the
    plane-sweep warp, each (K', D, H, W) f32."""
    u = torch.arange(W, dtype=torch.float32, device=A.device) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=A.device) + 0.5

    def row(i):
        p = (A[:, i, 0, None, None] * u[None, None, :] + A[:, i, 1, None, None] * v[None, :, None]
             + A[:, i, 2, None, None])
        return planes[None, :, None, None] * p[:, None] + b[:, i, None, None, None]

    z = torch.clamp(row(2), min=1e-5)
    x = torch.clamp(row(0) / z - 0.5, -2.0 * W, 2.0 * W)
    y = torch.clamp(row(1) / z - 0.5, -2.0 * H, 2.0 * H)
    return x, y


def warp_planes(src: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """Kernel #5's function (and, under autograd, #6's): src (K', H, W, C)
    warped to every plane, (K', D, H, W, C) in src's dtype."""
    H, W = src.shape[1], src.shape[2]
    x, y = sample_coords(A, b, planes, H, W)
    return sample_bilinear_idx(src.float(), x, y).to(src.dtype)


def by_element(fn, *batched: Tensor) -> Tensor:
    """fn over one batch element at a time, concatenated: the reference's
    volume in the memory of one element. Under autograd each element is
    checkpointed (recomputed in the backward), so only the (1, D, H, W)
    results stay saved. On fake tensors (the FLOP count) nothing is stored,
    and nothing is recomputed."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.utils.checkpoint import checkpoint

    keep_memory = torch.is_grad_enabled() and not is_fake(batched[0])
    outs = []
    for i in range(batched[0].shape[0]):
        part = [t[i: i + 1] for t in batched]
        outs.append(checkpoint(fn, *part, use_reentrant=False) if keep_memory
                    else fn(*part))
    return torch.cat(outs)
