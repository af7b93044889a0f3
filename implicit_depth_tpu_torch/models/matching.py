"""Matching feature encoder (torch, NCHW).

Counterpart of implicit_depth_tpu/models/matching.py::ResnetMatchingEncoder:
antialiased ResNet18 stem -> 16-dim features at 1/4 resolution,
  conv7x7/2 (64) -> BN -> ReLU -> [MaxPool(k2, s1, VALID) -> BlurPool(4, s2)]
  -> layer1 (2x BN BasicBlocks) -> 1x1 conv 128 -> InstanceNorm -> LeakyReLU(0.2)
  -> 3x3 conv 16 (replicate pad) -> InstanceNorm.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from implicit_depth_tpu_torch.models.blocks import instance_norm, memory_format_of, replicate_pad
from implicit_depth_tpu_torch.parallel import distributed
from implicit_depth_tpu_torch.utils.profiling import BN_EVAL_AFFINE

Tensor = torch.Tensor


class BatchNorm(nn.Module):
    """Batch norm with flax `nn.BatchNorm(momentum=0.9)` semantics, following
    `self.training`. Eval: running statistics. Train: the batch mean and the
    biased batch variance, statistics and normalisation in f32 whatever the
    input dtype, and the running statistics move as 0.9 old + 0.1 batch,
    with the biased variance (torch.nn.BatchNorm2d would use the unbiased
    one). Parameters weight/bias, buffers running_mean/var.

    In a process group of more than one rank the train-mode statistics are
    those of the global batch, as the JAX package's batch norm sees a batch
    sharded over processes: each rank's count, mean and sum of squared
    deviations are exchanged with one differentiable all-reduce and
    combined (Chan et al.'s pairwise update), so no E[x^2] - E[x]^2
    cancellation enters.

    Eval with grad disabled takes the per-channel scale and shift from a
    one-entry cache (`_eval_affine`, a plain attribute: no state_dict
    entry), the same tensors the uncached path computes, rebuilt whenever
    the parameters, the buffers, eps or the input dtype change; so a warm
    call dispatches only the two operations on the activation.
    BN_EVAL_AFFINE (utils/profiling.py) counts its hits and misses."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self._eval_affine = None  # (key, the keyed tensors, scale, shift)

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            x32 = x.float()
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
            if distributed.data_parallel():
                mean, var = _global_moments(mean, var, x32.numel() // x32.shape[1])
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
            scale = self.weight.float() * torch.rsqrt(var + self.eps)
            y = (x32 - mean[:, None, None]) * scale[:, None, None] + self.bias.float()[:, None, None]
            return y.to(x.dtype)
        if torch.is_grad_enabled():
            scale, shift = self._affine(x.dtype)
        else:
            scale, shift = self._cached_affine(x.dtype)
        return x * scale[:, None, None] + shift[:, None, None]

    def _affine(self, dtype: torch.dtype) -> tuple:
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return scale.to(dtype), shift.to(dtype)

    def _cached_affine(self, dtype: torch.dtype) -> tuple:
        """`_affine(dtype)`, from the cache while its key holds. The key is
        each keyed tensor's storage address, dtype and version counter, eps
        and `dtype`: an optimizer step, load_state_dict and a train-mode
        forward write in place (the version moves); `.to()` and assigned
        parameters bring new storage. The entry keeps the keyed tensors
        alive, so no new tensor can take a keyed address while it stands.
        Inference tensors have no version counter: no cache for them."""
        tensors = (self.weight, self.bias, self.running_mean, self.running_var)
        if any(t.is_inference() for t in tensors):
            return self._affine(dtype)
        key = (self.eps, dtype) + tuple((t.data_ptr(), t.dtype, t._version) for t in tensors)
        entry = self._eval_affine
        if entry is not None and entry[0] == key:
            BN_EVAL_AFFINE["hits"] += 1
            return entry[2], entry[3]
        BN_EVAL_AFFINE["misses"] += 1
        scale, shift = self._affine(dtype)
        self._eval_affine = (key, tuple(t.detach() for t in tensors), scale, shift)
        return scale, shift


def _global_moments(mean: Tensor, var: Tensor, n: int) -> tuple:
    """The mean and biased variance over every rank's batch from each rank's
    (n, mean, biased variance) per channel."""
    rank, world = distributed.process_info()
    mine = torch.stack([torch.full_like(mean, float(n)), mean, var * n])
    rows = [mine if r == rank else torch.zeros_like(mine) for r in range(world)]
    counts, means, m2s = distributed.global_sum(torch.stack(rows)).unbind(1)
    total = counts.sum(0)
    g_mean = (counts * means).sum(0) / total
    g_m2 = (m2s + counts * (means - g_mean) ** 2).sum(0)
    return g_mean, g_m2 / total


def blur_pool(x_nchw: Tensor, filt_size: int = 4, stride: int = 2) -> Tensor:
    """Anti-aliased downsampling: fixed binomial low-pass, depthwise,
    reflect padding (asymmetric for even filters), then stride. It runs in
    NCHW and answers in its input's layout: cuDNN has no channels_last
    kernel for this depthwise filter (on an H100 its grouped direct conv
    took 0.750 ms where torch's NCHW depthwise kernel takes 0.111, at the
    AR frame's (8, 64, 191, 255) bf16)."""
    taps = {3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0], 5: [1.0, 4.0, 6.0, 4.0, 1.0]}
    if filt_size not in taps:
        raise ValueError(filt_size)
    a = np.asarray(taps[filt_size])
    k2 = np.outer(a, a)
    k2 = k2 / k2.sum()
    c = x_nchw.shape[1]
    kernel = torch.as_tensor(k2, dtype=x_nchw.dtype, device=x_nchw.device)
    kernel = kernel[None, None].expand(c, 1, filt_size, filt_size)
    pad_l = (filt_size - 1) // 2
    pad_r = int(np.ceil((filt_size - 1) / 2))
    x = F.pad(x_nchw.contiguous(), (pad_l, pad_r, pad_l, pad_r), mode="reflect")
    out = F.conv2d(x, kernel, stride=stride, groups=c)
    return out.contiguous(memory_format=memory_format_of(x_nchw))


def avg_down(x_nchw: Tensor) -> Tensor:
    """The "-d" shortcut's 2x2 average pool at stride 2 with VALID padding
    (an odd side drops its last row or column), as flax's nn.avg_pool; not
    timm's ceil_mode=True, count_include_pad=False."""
    return F.avg_pool2d(x_nchw, 2, 2)


class ResnetBlockBN(nn.Module):
    """torchvision-style BasicBlock: conv-BN-ReLU-conv-BN + shortcut. With
    avg_down (the "-d" variant) a strided shortcut is avg_down, then the 1x1
    conv at stride 1."""

    def __init__(self, cin: int, features: int, stride: int = 1, avg_down: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample_conv = None
        self.pool_first = avg_down and stride != 1
        if cin != features or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, features, 1, 1 if self.pool_first else stride,
                                             bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: Tensor) -> Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x
        if self.downsample_conv is not None:
            if self.pool_first:
                identity = avg_down(identity)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class ResnetMatchingEncoder(nn.Module):
    def __init__(self, num_ch_out: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1_0 = ResnetBlockBN(64, 64)
        self.layer1_1 = ResnetBlockBN(64, 64)
        self.head_conv1 = nn.Conv2d(64, 128, 1, bias=True)
        self.head_conv2 = nn.Conv2d(128, num_ch_out, 3, padding=0, bias=True)

    def forward(self, image_nchw: Tensor) -> Tensor:
        x = F.relu(self.bn1(self.conv1(image_nchw)))
        x = F.max_pool2d(x, 2, 1)
        x = blur_pool(x, 4, 2)
        x = self.layer1_1(self.layer1_0(x))
        x = F.leaky_relu(instance_norm(self.head_conv1(x)), 0.2)
        x = self.head_conv2(replicate_pad(x, 1))
        return instance_norm(x)
