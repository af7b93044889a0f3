"""Ray-head MLP of the BD training query head, as hand-written CUDA kernels,
forward and backward.

Replaces the TPU kernels implicit_depth_tpu/ops/ray_head.py::_fwd_kernel /
_fwd_kernel_noprior and _bwd_kernel / _bwd_kernel_noprior (wrapper
`ray_head_mlp`, custom VJP). Per (ray, sample) it computes

    pred = fc2(elu(fc1(elu(fp + d * k0d [+ p * k0p]))))

with fp (b, N, 128) the per-ray fc0 term that BinaryMLPNetwork.factored
computes once per ray. The kernels are csrc/ray_head.cu; this module holds

- `ray_head_mlp`: the differentiable entry point with the JAX signature, a
  `torch.autograd.Function` whose forward is `ray_head_fwd` and whose
  backward is `ray_head_bwd`;
- `ray_head_fwd` / `ray_head_bwd`: dispatch wrappers. A CPU tensor goes to
  the plain version; a CUDA tensor launches the kernel or raises. Each has a
  `launches` count of its kernel launches and nothing else;
- `ray_head_reference` / `ray_head_bwd_reference`: the plain versions (the
  backward is autograd of the forward).

Contract: fp (b, N, 128), depths and prior (b, N, S) and the cotangent in
one dtype, f32 or bf16; k0d, k0p, b1 (128,), w1 (128, 128) in (in, out)
layout, w2 (128, 1), b2 (1,) in f32. The math is f32 in both versions; the
output takes fp's dtype. The backward's cotangents are f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from implicit_depth_tpu_torch.ops import cuda_build

Tensor = torch.Tensor

HIDDEN = 128
FWD_THREADS = 256
BWD_THREADS = 128  # rows of a backward tile; a tile holds 128 // S whole rays

_PTR = ctypes.c_void_p
_SIGNATURES = {
    **{name: ([_PTR] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _PTR], ctypes.c_int)
       for name in ("ray_head_fwd_f32", "ray_head_fwd_bf16")},
    **{name: ([_PTR] * 14 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _PTR], ctypes.c_int)
       for name in ("ray_head_bwd_f32", "ray_head_bwd_bf16")},
    "ray_head_slab_len": ([], ctypes.c_longlong),
}


class RayHeadGrads(NamedTuple):
    dfp: Tensor            # (b, N, 128)
    dd: Tensor             # (b, N, S)
    dp: Optional[Tensor]   # (b, N, S) or None without the prior
    dk0d: Tensor           # (128,)
    dk0p: Optional[Tensor]  # (128,) or None without the prior
    dw1: Tensor            # (128, 128)
    db1: Tensor            # (128,)
    dw2: Tensor            # (128, 1)
    db2: Tensor            # (1,)


def _check(fp, depths, prior, k0d, k0p, w1, b1, w2, b2, ct=None) -> tuple:
    """Raises unless the operands have the kernels' shapes, dtypes and
    layout on one device. Returns (b, N, S)."""
    if fp.dim() != 3 or fp.shape[-1] != HIDDEN:
        raise ValueError(f"fp must be (b, N, {HIDDEN}), got {tuple(fp.shape)}")
    b, n, _ = fp.shape
    if depths.dim() != 3 or tuple(depths.shape[:2]) != (b, n):
        raise ValueError(f"depths must be ({b}, {n}, S), got {tuple(depths.shape)}")
    s = depths.shape[2]
    cdt = fp.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fp must be float32 or bfloat16, got {cdt}")
    if (prior is None) != (k0p is None):
        raise ValueError("prior and k0p come together")
    f32 = torch.float32
    spec = {"fp": (fp, (b, n, HIDDEN), cdt), "depths": (depths, (b, n, s), cdt),
            "prior": (prior, (b, n, s), cdt), "ct": (ct, (b, n, s), cdt),
            "k0d": (k0d, (HIDDEN,), f32), "k0p": (k0p, (HIDDEN,), f32),
            "w1": (w1, (HIDDEN, HIDDEN), f32), "b1": (b1, (HIDDEN,), f32),
            "w2": (w2, (HIDDEN, 1), f32), "b2": (b2, (1,), f32)}
    for name, (t, shape, dtype) in spec.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != fp.device:
            raise ValueError(f"{name} is on {t.device}, fp on {fp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, n, s


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def ray_head_fwd(fp: Tensor, depths: Tensor, prior: Optional[Tensor], k0d: Tensor,
                 k0p: Optional[Tensor], w1: Tensor, b1: Tensor, w2: Tensor,
                 b2: Tensor) -> Tensor:
    """Logits (b, N, S) in fp's dtype. CUDA tensors run the kernel; CPU
    tensors run `ray_head_reference`."""
    b, n, s = _check(fp, depths, prior, k0d, k0p, w1, b1, w2, b2)
    if fp.device.type == "cpu":
        return ray_head_reference(fp, depths, prior, k0d, k0p, w1, b1, w2, b2)
    if fp.device.type != "cuda":
        raise ValueError(f"no ray head for device {fp.device}")
    ops = (fp, depths, prior, k0d, k0p, w1, b1, w2, b2)
    cuda_build.check_aligned(ops, "ray_head_fwd")
    out = torch.empty((b, n, s), dtype=fp.dtype, device=fp.device)
    lib = cuda_build.load("ray_head.cu", _SIGNATURES)
    fn = lib.ray_head_fwd_f32 if fp.dtype == torch.float32 else lib.ray_head_fwd_bf16
    grid = max(1, min(-(-(b * n * s) // FWD_THREADS), cuda_build.sm_count(fp.device)))
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    with torch.cuda.device(fp.device):
        err = fn(*(_ptr(t) for t in ops), out.data_ptr(), b * n, s, grid, stream)
    cuda_build.check(err, "ray_head_fwd")
    ray_head_fwd.launches += 1
    return out


ray_head_fwd.launches = 0


def ray_head_reference(fp: Tensor, depths: Tensor, prior: Optional[Tensor], k0d: Tensor,
                       k0p: Optional[Tensor], w1: Tensor, b1: Tensor, w2: Tensor,
                       b2: Tensor) -> Tensor:
    """Plain PyTorch version: the JAX package's XLA chain
    (BinaryMLPNetwork.factored without the kernel), in f32."""
    z = fp.float()[:, :, None, :] + depths.float()[..., None] * k0d.float()
    if prior is not None:
        z = z + prior.float()[..., None] * k0p.float()
    h = F.elu(z)
    h = F.elu(h @ w1.float() + b1.float())
    return (h @ w2.float() + b2.float())[..., 0].to(fp.dtype)


def ray_head_bwd(ct: Tensor, fp: Tensor, depths: Tensor, prior: Optional[Tensor], k0d: Tensor,
                 k0p: Optional[Tensor], w1: Tensor, b1: Tensor, w2: Tensor) -> RayHeadGrads:
    """VJP of `ray_head_fwd` for the (b, N, S) cotangent `ct` (in fp's
    dtype), f32 cotangents. CUDA tensors run the kernel; CPU tensors run
    `ray_head_bwd_reference`."""
    b2 = torch.zeros((1,), dtype=torch.float32, device=fp.device)
    b, n, s = _check(fp, depths, prior, k0d, k0p, w1, b1, w2, b2, ct)
    if fp.device.type == "cpu":
        return ray_head_bwd_reference(ct, fp, depths, prior, k0d, k0p, w1, b1, w2)
    if fp.device.type != "cuda":
        raise ValueError(f"no ray head for device {fp.device}")
    if s > BWD_THREADS:
        raise ValueError(f"the backward kernel takes at most {BWD_THREADS} samples per ray, got {s}")
    ops = (fp, depths, prior, ct, k0d, k0p, w1, b1, w2)
    cuda_build.check_aligned(ops, "ray_head_bwd")
    dev = fp.device
    f32 = torch.float32
    lib = cuda_build.load("ray_head.cu", _SIGNATURES)
    slab = lib.ray_head_slab_len()
    nrays = b * n
    nslabs = max(1, min(-(-nrays // (BWD_THREADS // s)), cuda_build.sm_count(dev)))
    dfp = torch.empty((b, n, HIDDEN), dtype=f32, device=dev)
    dd = torch.empty((b, n, s), dtype=f32, device=dev)
    dp = torch.empty((b, n, s), dtype=f32, device=dev) if prior is not None else None
    slabs = torch.zeros((nslabs, slab), dtype=f32, device=dev)
    grads = torch.empty((slab,), dtype=f32, device=dev)
    fn = lib.ray_head_bwd_f32 if fp.dtype == f32 else lib.ray_head_bwd_bf16
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*(_ptr(t) for t in ops), dfp.data_ptr(), dd.data_ptr(), _ptr(dp),
                 slabs.data_ptr(), grads.data_ptr(), nrays, s, nslabs, stream)
    cuda_build.check(err, "ray_head_bwd")
    ray_head_bwd.launches += 1
    F_ = HIDDEN
    dw1, db1, dw2, dk0d, dk0p, db2 = torch.split(grads[:F_ * F_ + 4 * F_ + 1],
                                                 (F_ * F_, F_, F_, F_, F_, 1))
    return RayHeadGrads(dfp=dfp, dd=dd, dp=dp, dk0d=dk0d,
                        dk0p=dk0p if prior is not None else None, dw1=dw1.view(F_, F_),
                        db1=db1, dw2=dw2.view(F_, 1), db2=db2)


ray_head_bwd.launches = 0


def ray_head_bwd_reference(ct: Tensor, fp: Tensor, depths: Tensor, prior: Optional[Tensor],
                           k0d: Tensor, k0p: Optional[Tensor], w1: Tensor, b1: Tensor,
                           w2: Tensor) -> RayHeadGrads:
    """Plain version of the backward: autograd of `ray_head_reference` in f32."""
    def leaf(t):
        return None if t is None else t.detach().float().requires_grad_(True)

    fp32, d32, p32, kd, kp, w1_, b1_, w2_ = map(leaf, (fp, depths, prior, k0d, k0p, w1, b1, w2))
    b2 = torch.zeros((1,), dtype=torch.float32, device=fp.device, requires_grad=True)
    with torch.enable_grad():
        out = ray_head_reference(fp32, d32, p32, kd, kp, w1_, b1_, w2_, b2)
        leaves = [t for t in (fp32, d32, p32, kd, kp, w1_, b1_, w2_, b2) if t is not None]
        grads = iter(torch.autograd.grad(out, leaves, ct.float()))
    dfp, dd = next(grads), next(grads)
    dp = next(grads) if prior is not None else None
    dk0d = next(grads)
    dk0p = next(grads) if prior is not None else None
    dw1, db1, dw2, db2 = grads
    return RayHeadGrads(dfp, dd, dp, dk0d, dk0p, dw1, db1, dw2, db2)


class _RayHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fp, depths, prior, k0d, k0p, w1, b1, w2, b2):
        ctx.save_for_backward(fp, depths, prior, k0d, k0p, w1, b1, w2)
        with torch.autocast(fp.device.type, enabled=False):  # f32 math, as the kernel's
            return ray_head_fwd(fp, depths, prior, k0d, k0p, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, ct):
        fp, depths, prior, k0d, k0p, w1, b1, w2 = ctx.saved_tensors
        with torch.autocast(fp.device.type, enabled=False):
            g = ray_head_bwd(ct.to(fp.dtype).contiguous(), fp, depths, prior, k0d, k0p, w1, b1,
                             w2)
        return (g.dfp.to(fp.dtype), g.dd.to(depths.dtype),
                None if prior is None else g.dp.to(prior.dtype),
                g.dk0d.to(k0d.dtype), None if k0p is None else g.dk0p.to(k0p.dtype),
                g.dw1.to(w1.dtype), g.db1.to(b1.dtype), g.dw2.to(w2.dtype), g.db2)


def ray_head_mlp(fp: Tensor, depths: Tensor, prior: Optional[Tensor], k0d: Tensor,
                 k0p: Optional[Tensor], w1: Tensor, b1: Tensor, w2: Tensor,
                 b2: Tensor) -> Tensor:
    """The fused elu-MLP over (ray, sample) pairs, differentiable: fp
    (b, N, 128), depths and prior (b, N, S) or prior None, k0d/k0p (128,),
    w1 (128, 128), b1 (128,), w2 (128, 1), b2 (1,). Returns (b, N, S) logits
    in fp's dtype. The forward is kernel #3 and the backward kernel #4 on
    CUDA tensors, their plain versions on CPU tensors."""
    return _RayHead.apply(fp, depths, prior, k0d, k0p, w1, b1, w2, b2)
