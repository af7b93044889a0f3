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
  `launches` count of its kernel launches and nothing else, and a
  `prior_launches` count of those launches that took the prior (the backward
  then returns dp);
- `ray_head_reference` / `ray_head_bwd_reference`: the plain versions, the
  backward written out.

Contract: fp (b, N, 128), depths and prior (b, N, S) and the cotangent in
one dtype, f32 or bf16; k0d, k0p, b1 (128,), w1 (128, 128) in (in, out)
layout, w2 (128, 1), b2 (1,) in f32. The output takes fp's dtype; the
backward's cotangents are f32. In f32 the math is f32 throughout (the JAX
package's XLA chain). In bf16 both versions compute the JAX kernel's chain
(implicit_depth_tpu/ops/ray_head.py, `_CDT`): f32 arithmetic rounded to bf16
at the kernel's rounding points (the operands, W1, w2, k0d, k0p, every
product of two chain values, the ELU outputs and their derivatives, dz2, dh,
dz, dd, dp), with the products' sums and every weight gradient in f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from implicit_depth_tpu_torch.ops import cuda_build

Tensor = torch.Tensor

HIDDEN = 128

_PTR = ctypes.c_void_p
_SIGNATURES = {
    **{name: ([_PTR] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _PTR], ctypes.c_int)
       for name in ("ray_head_fwd_f32", "ray_head_fwd_bf16")},
    **{name: ([_PTR] * 14 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _PTR], ctypes.c_int)
       for name in ("ray_head_bwd_f32", "ray_head_bwd_bf16")},
    "ray_head_slab_len": ([], ctypes.c_longlong),
    "ray_head_fwd_threads": ([ctypes.c_int], ctypes.c_int),
    "ray_head_fwd_smem_bytes": ([ctypes.c_int], ctypes.c_longlong),
    "ray_head_fwd_blocks": ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int], ctypes.c_longlong),
    "ray_head_bwd_threads": ([ctypes.c_int], ctypes.c_int),
    "ray_head_bwd_smem_bytes": ([ctypes.c_int], ctypes.c_longlong),
    "ray_head_bwd_blocks": ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                            ctypes.c_longlong),
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
    low = int(fp.dtype == torch.bfloat16)
    fn = lib.ray_head_fwd_bf16 if low else lib.ray_head_fwd_f32
    grid = lib.ray_head_fwd_blocks(b * n * s, cuda_build.sm_count(fp.device), low)
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    with torch.cuda.device(fp.device):
        err = fn(*(_ptr(t) for t in ops), out.data_ptr(), b * n, s, grid, stream)
    cuda_build.check(err, "ray_head_fwd")
    ray_head_fwd.launches += 1
    ray_head_fwd.prior_launches += prior is not None
    return out


ray_head_fwd.launches = ray_head_fwd.prior_launches = 0


def _rounding(dtype: torch.dtype):
    """Rounding to the JAX kernel's compute type at its rounding points: to
    bf16 for bf16 operands, none in f32."""
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def _elu(z: Tensor, low: bool) -> Tensor:
    # bf16: exp(z) - 1 below 0 in f32, as the JAX kernel (ray_head.py:61-64),
    # with exp correctly rounded through f64: PyTorch's vectorised and scalar
    # CPU exp differ by an f32 ulp, which path an element takes depends on
    # how the threads split the tensor, and that ulp decides a bf16 rounding
    # now and then. f32: the XLA chain's elu.
    return torch.where(z > 0, z, torch.exp(z.double()).float() - 1.0) if low else F.elu(z)


def _delu(h: Tensor, r) -> Tensor:
    """elu'(z) from h = elu(z): 1 where z > 0, else exp(z) = h + 1."""
    return r(torch.where(h > 0, 1.0, h + 1.0))


def _hidden(fp, depths, prior, k0d, k0p, w1, b1) -> tuple:
    """(h, h2) of every (ray, sample) row, (b, N, S, 128) f32, for bf16
    operands rounded where the JAX kernel rounds (ray_head.py:126-139)."""
    low = fp.dtype == torch.bfloat16
    r = _rounding(fp.dtype)
    z = r(fp.float()[:, :, None, :] + r(depths.float()[..., None] * r(k0d.float())))
    if prior is not None:
        z = r(z + r(prior.float()[..., None] * r(k0p.float())))
    h = r(_elu(z, low))
    return h, r(_elu(h @ r(w1.float()) + b1.float(), low))


def ray_head_reference(fp: Tensor, depths: Tensor, prior: Optional[Tensor], k0d: Tensor,
                       k0p: Optional[Tensor], w1: Tensor, b1: Tensor, w2: Tensor,
                       b2: Tensor) -> Tensor:
    """Plain PyTorch version. f32: the JAX package's XLA chain
    (BinaryMLPNetwork.factored without the kernel). bf16: the JAX kernel's
    chain, f32 math rounded to bf16 at the kernel's rounding points."""
    _, h2 = _hidden(fp, depths, prior, k0d, k0p, w1, b1)
    if fp.dtype != torch.bfloat16:
        return (h2 @ w2.float() + b2.float())[..., 0].to(fp.dtype)
    r = _rounding(fp.dtype)
    return (r(h2 * r(w2.float()[:, 0])).sum(-1) + b2.float()).to(fp.dtype)


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
    dev = fp.device
    f32 = torch.float32
    lib = cuda_build.load("ray_head.cu", _SIGNATURES)
    low = int(fp.dtype == torch.bfloat16)
    nrays = b * n
    nslabs = lib.ray_head_bwd_blocks(nrays, s, cuda_build.sm_count(dev), low)
    if nslabs < 0:
        raise ValueError(f"the backward kernel takes at most 128 samples per ray, got {s}")
    if lib.ray_head_bwd_smem_bytes(low) > cuda_build.SMEM_LIMIT:
        raise ValueError("the backward kernel needs more shared memory than a block may have")
    ops = (fp, depths, prior, ct, k0d, k0p, w1, b1, w2)
    cuda_build.check_aligned(ops, "ray_head_bwd")
    slab = lib.ray_head_slab_len()
    dfp = torch.empty((b, n, HIDDEN), dtype=f32, device=dev)
    dd = torch.empty((b, n, s), dtype=f32, device=dev)
    dp = torch.empty((b, n, s), dtype=f32, device=dev) if prior is not None else None
    slabs = torch.zeros((nslabs, slab), dtype=f32, device=dev)
    grads = torch.empty((slab,), dtype=f32, device=dev)
    fn = lib.ray_head_bwd_bf16 if low else lib.ray_head_bwd_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*(_ptr(t) for t in ops), dfp.data_ptr(), dd.data_ptr(), _ptr(dp),
                 slabs.data_ptr(), grads.data_ptr(), nrays, s, nslabs, stream)
    cuda_build.check(err, "ray_head_bwd")
    ray_head_bwd.launches += 1
    ray_head_bwd.prior_launches += prior is not None
    F_ = HIDDEN
    dw1, db1, dw2, dk0d, dk0p, db2 = torch.split(grads[:F_ * F_ + 4 * F_ + 1],
                                                 (F_ * F_, F_, F_, F_, F_, 1))
    return RayHeadGrads(dfp=dfp, dd=dd, dp=dp, dk0d=dk0d,
                        dk0p=dk0p if prior is not None else None, dw1=dw1.view(F_, F_),
                        db1=db1, dw2=dw2.view(F_, 1), db2=db2)


ray_head_bwd.launches = ray_head_bwd.prior_launches = 0


def ray_head_bwd_reference(ct: Tensor, fp: Tensor, depths: Tensor, prior: Optional[Tensor],
                           k0d: Tensor, k0p: Optional[Tensor], w1: Tensor, b1: Tensor,
                           w2: Tensor) -> RayHeadGrads:
    """Plain version of the backward, written out: the VJP of
    `ray_head_reference`, in bf16 rounded where the JAX kernel's backward
    rounds (ray_head.py:184-211): dz2 = bf16(bf16(ct w2) elu'(h2)),
    dh = bf16(dz2 W1^T), dz = bf16(dh elu'(h)), dd = bf16(sum bf16(dz k0d)),
    and every weight-gradient term bf16(x y) summed in f32."""
    r = _rounding(fp.dtype)
    h, h2 = _hidden(fp, depths, prior, k0d, k0p, w1, b1)
    rows = (0, 1, 2)
    c = ct.float()[..., None]
    dz2 = r(r(c * r(w2.float()[:, 0])) * _delu(h2, r))
    dz = r(r(dz2 @ r(w1.float()).t()) * _delu(h, r))
    kd = r(k0d.float())
    dp = dk0p = None
    if prior is not None:
        kp = r(k0p.float())
        dp = r(r(dz * kp).sum(-1))
        dk0p = r(dz * prior.float()[..., None]).sum(rows)
    return RayHeadGrads(
        dfp=dz.sum(2), dd=r(r(dz * kd).sum(-1)), dp=dp,
        dk0d=r(dz * depths.float()[..., None]).sum(rows), dk0p=dk0p,
        dw1=h.reshape(-1, HIDDEN).t() @ dz2.reshape(-1, HIDDEN), db1=dz2.sum(rows),
        dw2=r(h2 * c).sum(rows)[:, None], db2=ct.float().sum().reshape(1))


class _RayHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fp, depths, prior, k0d, k0p, w1, b1, w2, b2):
        ctx.save_for_backward(fp, depths, prior, k0d, k0p, w1, b1, w2)
        with torch.autocast(fp.device.type, enabled=False):  # the operands decide the dtype
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
