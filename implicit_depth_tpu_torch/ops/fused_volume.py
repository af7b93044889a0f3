"""Fused metadata volume: plane-sweep warp + closed-form metadata + the
202 -> 128 -> 128 -> 1 MLP, as hand-written CUDA kernels, forward and
backward.

Replaces the TPU kernels implicit_depth_tpu/ops/fused_volume.py::
_fused_kernel (wrapper `fused_metadata_volume`) and `_fused_bwd_kernel`
(wrapper `fused_metadata_volume_bwd`). The kernels are csrc/fused_volume.cu
and csrc/fused_volume_bwd.cu; this module holds

- `fused_metadata_volume`: the dispatch wrapper. A CPU tensor goes to the
  plain version; a CUDA tensor launches the kernel or raises. Its
  `launches` attribute counts kernel launches, and nothing else.
- `fused_metadata_volume_reference`: the plain PyTorch version on the same
  operands, built from the port's warp (volumes/cost_volume.py) and the
  repacked first-layer weights. The CPU tests and chip_smoke.py compare
  against it.
- `fused_metadata_volume_bwd`: the backward's dispatch wrapper (the VJP
  w.r.t. the tensor operands), with its own `launches` count; by the
  features' dtype it launches the f32 CUDA-core kernel or the bf16
  tensor-core kernel, both in csrc/fused_volume_bwd.cu.
  `fused_metadata_volume_bwd_reference` is its plain version: the JAX
  kernel's backward written out in tensor code.
- `fused_metadata_volume_train`: a `torch.autograd.Function` over the
  operands whose forward is the forward wrapper and whose backward is the
  backward wrapper. Geometry (A, b, origins, invK, planes) gets no
  gradient: it is a constant of the training graph.

Both plain versions compute in f32 and, with bf16 features, round to bf16
where the JAX kernels round their matrix operands (the warped visuals, h1,
dh2p, dacc), as the CUDA kernels do.

Libraries are built by ops/cuda_build.py at the first CUDA call.

Operands (the TPU kernel's contract): cur (B,H,W,C) and src (B,K,H,W,C)
in the compute dtype (f32 or bf16); A (B,K,3,3), b and origins (B,K,3),
invK (B,3,3), planes (D,), base (B,H,F,W), w_metaT (F,K*8), w_plane,
b_fc1, w_fc2 (F,1), b_fc2 (1,) in f32; w_visT (F,K*C) and w_fc1T (F,F) in
the compute dtype. Output (B,D,H,W) f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from implicit_depth_tpu_torch.ops import cuda_build
from implicit_depth_tpu_torch.volumes.cost_volume import warped_views_from_components

Tensor = torch.Tensor

CHANNELS = 16   # matching feature channels the kernels are compiled for
HIDDEN = 128    # MLP width the kernels are compiled for
SMEM_LIMIT = cuda_build.SMEM_LIMIT

_PTR = ctypes.c_void_p
_SIGNATURES = {
    "fused_volume.cu": {
        name: ([_PTR] * 16 + [ctypes.c_int] * 5 + [_PTR], ctypes.c_int)
        for name in ("fused_metadata_volume_f32", "fused_metadata_volume_bf16")},
    "fused_volume_bwd.cu": {
        **{name: ([_PTR] * 20 + [ctypes.c_int] * 6 + [_PTR], ctypes.c_int)
           for name in ("fused_metadata_volume_bwd_f32", "fused_metadata_volume_bwd_bf16")},
        "fused_metadata_volume_bwd_slab_len": ([ctypes.c_int], ctypes.c_longlong),
        "fused_metadata_volume_bwd_tile": ([ctypes.c_int], ctypes.c_int),
        "fused_metadata_volume_bwd_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_longlong)},
}


def _library(source: str):
    return cuda_build.load(source, _SIGNATURES[source])


def _check_operands(cur, src, A, b, origins, invK, planes, base, w_visT, w_metaT,
                    w_plane, w_fc1T, b_fc1, w_fc2, b_fc2):
    """Raises unless the operands have the kernel's shapes, dtypes and
    layout, all on one device. Returns (B, K, H, W, C, D, F)."""
    if src.dim() != 5:
        raise ValueError(f"src must be (B, K, H, W, C), got {tuple(src.shape)}")
    B, K, H, W, C = src.shape
    D = planes.shape[0]
    F_ = base.shape[2] if base.dim() == 4 else -1
    cdt = src.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {cdt}")
    f32 = torch.float32
    spec = {
        "cur": (cur, (B, H, W, C), cdt),
        "A": (A, (B, K, 3, 3), f32),
        "b": (b, (B, K, 3), f32),
        "origins": (origins, (B, K, 3), f32),
        "invK": (invK, (B, 3, 3), f32),
        "planes": (planes, (D,), f32),
        "base": (base, (B, H, F_, W), f32),
        "w_visT": (w_visT, (F_, K * C), cdt),
        "w_metaT": (w_metaT, (F_, K * 8), f32),
        "w_plane": (w_plane, (F_, 1), f32),
        "w_fc1T": (w_fc1T, (F_, F_), cdt),
        "b_fc1": (b_fc1, (F_, 1), f32),
        "w_fc2": (w_fc2, (F_, 1), f32),
        "b_fc2": (b_fc2, (1,), f32),
    }
    for name, (t, shape, dtype) in spec.items():
        if t is None:  # the backward takes no b_fc2
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    return B, K, H, W, C, D, F_


def smem_bytes(num_views: int) -> int:
    """Dynamic shared memory of one forward block: f32 fc0 columns for the
    source visuals and the six metadata rows of every view, fc1, and the
    three F-vectors."""
    return 4 * (num_views * (CHANNELS + 6) * HIDDEN + HIDDEN * HIDDEN + 3 * HIDDEN)


def bwd_smem_bytes(num_views: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one backward block for features of `dtype`,
    as csrc/fused_volume_bwd.cu lays it out (it builds the library)."""
    return _library("fused_volume_bwd.cu").fused_metadata_volume_bwd_smem_bytes(
        num_views, int(dtype == torch.bfloat16))


def _launch(ops: tuple, dims: tuple) -> Tensor:
    B, K, H, W, C, D, F_ = dims
    if C != CHANNELS or F_ != HIDDEN:
        raise ValueError(f"the kernel is compiled for C={CHANNELS}, F={HIDDEN}; got C={C}, F={F_}")
    if smem_bytes(K) > SMEM_LIMIT:
        raise ValueError(f"K={K} source views need {smem_bytes(K)} bytes of shared memory")
    cuda_build.check_aligned(ops, "fused_metadata_volume")
    out = torch.empty((B, D, H, W), dtype=torch.float32, device=ops[0].device)
    lib = _library("fused_volume.cu")
    fn = (lib.fused_metadata_volume_f32 if ops[1].dtype == torch.float32
          else lib.fused_metadata_volume_bf16)
    stream = torch.cuda.current_stream(ops[0].device).cuda_stream
    with torch.cuda.device(ops[0].device):
        err = fn(*(t.data_ptr() for t in ops), out.data_ptr(), B, K, H, W, D, stream)
    cuda_build.check(err, "fused_metadata_volume")
    fused_metadata_volume.launches += 1
    return out


def fused_metadata_volume(cur: Tensor, src: Tensor, A: Tensor, b: Tensor, origins: Tensor,
                          invK: Tensor, planes: Tensor, base: Tensor, w_visT: Tensor,
                          w_metaT: Tensor, w_plane: Tensor, w_fc1T: Tensor, b_fc1: Tensor,
                          w_fc2: Tensor, b_fc2: Tensor) -> Tensor:
    """The metadata feature volume (B, D, H, W) f32. CUDA tensors run the
    kernel; CPU tensors run `fused_metadata_volume_reference`."""
    ops = (cur, src, A, b, origins, invK, planes, base, w_visT, w_metaT, w_plane,
           w_fc1T, b_fc1, w_fc2, b_fc2)
    dims = _check_operands(*ops)
    if src.device.type == "cuda":
        return _launch(ops, dims)
    if src.device.type != "cpu":
        raise ValueError(f"no fused volume for device {src.device}")
    return fused_metadata_volume_reference(*ops)


fused_metadata_volume.launches = 0


def _rounding(dtype):
    """x -> x rounded to bf16 and back to f32 for bf16 features, the
    identity for f32 ones: the operand rounding of the JAX kernels' matrix
    products (f32 accumulation of bf16 operands)."""
    if dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(dtype).float()


class _ForwardParts(NamedTuple):
    feats: Tensor  # (B, K, D, H, W, C) f32 warped source features
    vis: Tensor    # (B, D, H, W, K*C) the same, fc0's operand (rounded)
    meta: Tensor   # (B, D, H, W, K*8) f32 metadata rows
    acc: Tensor    # (B, D, H, W, F) fc0 pre-activation
    h1: Tensor     # (B, D, H, W, F) LeakyReLU(acc), fc1's operand (rounded)
    h2p: Tensor    # (B, D, H, W, F) fc1 pre-activation


def _forward_parts(cur32: Tensor, src32: Tensor, A: Tensor, b: Tensor, origins: Tensor,
                   invK: Tensor, planes: Tensor, base: Tensor, w_visT: Tensor, w_metaT: Tensor,
                   w_plane: Tensor, w_fc1T: Tensor, b_fc1: Tensor, rnd) -> _ForwardParts:
    """The kernels' forward up to fc1's pre-activation, in f32 on f32
    features, with `rnd` at the JAX kernel's two rounding points (the warped
    visuals before fc0, h1 before fc1; implicit_depth_tpu/ops/fused_volume.py
    :207, :239). The dot metadata takes the unrounded warp, as there."""
    B, K, H, W, C = src32.shape
    D = planes.shape[0]
    no_pose = torch.zeros((B, K, 3), dtype=torch.float32, device=src32.device)
    wv = warped_views_from_components(cur32, src32, A, b, origins, invK, planes, no_pose,
                                      compute_dtype=torch.float32)
    vis = rnd(wv.feats.permute(0, 2, 3, 4, 1, 5).reshape(B, D, H, W, K * C))
    zero = torch.zeros_like(wv.depths)
    meta = torch.stack([wv.depths, wv.dot, wv.ray_angle, wv.src_rays[..., 0],
                        wv.src_rays[..., 1], wv.src_rays[..., 2], zero, zero], dim=-1)
    meta = meta.permute(0, 2, 3, 4, 1, 5).reshape(B, D, H, W, K * 8)

    acc = base.permute(0, 1, 3, 2)[:, None]  # (B, 1, H, W, F)
    acc = acc + planes[None, :, None, None, None] * w_plane[:, 0]
    acc = acc + vis @ w_visT.float().t() + meta @ w_metaT.t()
    h1 = rnd(F.leaky_relu(acc, 0.01))
    h2p = h1 @ w_fc1T.float().t() + b_fc1[:, 0]
    return _ForwardParts(wv.feats, vis, meta, acc, h1, h2p)


def fused_metadata_volume_reference(cur: Tensor, src: Tensor, A: Tensor, b: Tensor,
                                    origins: Tensor, invK: Tensor, planes: Tensor,
                                    base: Tensor, w_visT: Tensor, w_metaT: Tensor,
                                    w_plane: Tensor, w_fc1T: Tensor, b_fc1: Tensor,
                                    w_fc2: Tensor, b_fc2: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel on the same operands, in f32:
    the warp and metadata tensors of volumes/cost_volume.py, then the MLP
    with the repacked weights (pose and mask terms are inside `base`). With
    bf16 features the warped visuals and h1 are rounded to bf16 before their
    products, as the JAX kernel rounds them."""
    parts = _forward_parts(cur.float(), src.float(), A, b, origins, invK, planes, base, w_visT,
                           w_metaT, w_plane, w_fc1T, b_fc1, _rounding(src.dtype))
    return (F.leaky_relu(parts.h2p, 0.01) @ w_fc2 + b_fc2)[..., 0]


class FusedVolumeCotangents(NamedTuple):
    """The VJP of `fused_metadata_volume` w.r.t. its tensor operands, all f32
    (the JAX package's bundle of the same name)."""

    dsrc: Tensor     # (B, K, H, W, C)
    dcur: Tensor     # (B, H, W, C), the dot-metadata path only
    dbase: Tensor    # (B, H, F, W)
    dw_visT: Tensor  # (F, K*C)
    dw_metaT: Tensor  # (F, K*8)
    dw_plane: Tensor  # (F, 1)
    dw_fc1T: Tensor  # (F, F)
    db_fc1: Tensor   # (F, 1)
    dw_fc2: Tensor   # (F, 1)
    db_fc2: Tensor   # (1,)


def _launch_bwd(ct: Tensor, ops: tuple, dims: tuple) -> FusedVolumeCotangents:
    B, K, H, W, C, D, F_ = dims
    if C != CHANNELS or F_ != HIDDEN:
        raise ValueError(f"the kernel is compiled for C={CHANNELS}, F={HIDDEN}; got C={C}, F={F_}")
    cdt = ops[1].dtype
    lib = _library("fused_volume_bwd.cu")
    smem = bwd_smem_bytes(K, cdt)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={K} source views need {smem} bytes of shared memory in the backward")
    cuda_build.check_aligned(ops + (ct,), "fused_metadata_volume_bwd")
    dev = ct.device
    slab = lib.fused_metadata_volume_bwd_slab_len(K)
    tile = lib.fused_metadata_volume_bwd_tile(int(cdt == torch.bfloat16))
    nslabs = max(1, min(-(-(B * H * W) // tile), cuda_build.sm_count(dev)))
    f32 = torch.float32
    dbase = torch.zeros((B, H, F_, W), dtype=f32, device=dev)
    dcur = torch.zeros((B, H, W, C), dtype=f32, device=dev)
    dsrc = torch.zeros((B, K, H, W, C), dtype=f32, device=dev)
    slabs = torch.zeros((nslabs, slab), dtype=f32, device=dev)
    grads = torch.empty((slab,), dtype=f32, device=dev)
    fn = lib.fused_metadata_volume_bwd_f32 if cdt == f32 else lib.fused_metadata_volume_bwd_bf16
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in ops), ct.data_ptr(), dbase.data_ptr(),
                 dcur.data_ptr(), dsrc.data_ptr(), slabs.data_ptr(), grads.data_ptr(),
                 nslabs, B, K, H, W, D, stream)
    cuda_build.check(err, "fused_metadata_volume_bwd")
    fused_metadata_volume_bwd.launches += 1
    sizes = (F_ * F_, F_ * K * C, F_ * K * 8, F_, F_, F_, 1)
    fc1, vis, meta, plane, b1, w2, b2 = torch.split(grads[:sum(sizes)], sizes)
    return FusedVolumeCotangents(
        dsrc=dsrc, dcur=dcur, dbase=dbase, dw_visT=vis.view(F_, K * C),
        dw_metaT=meta.view(F_, K * 8), dw_plane=plane.view(F_, 1), dw_fc1T=fc1.view(F_, F_),
        db_fc1=b1.view(F_, 1), dw_fc2=w2.view(F_, 1), db_fc2=b2.view(1))


def fused_metadata_volume_bwd(ct: Tensor, cur: Tensor, src: Tensor, A: Tensor, b: Tensor,
                              origins: Tensor, invK: Tensor, planes: Tensor, base: Tensor,
                              w_visT: Tensor, w_metaT: Tensor, w_plane: Tensor,
                              w_fc1T: Tensor, b_fc1: Tensor,
                              w_fc2: Tensor) -> FusedVolumeCotangents:
    """VJP of `fused_metadata_volume` for the (B, D, H, W) f32 cotangent
    `ct`, w.r.t. its tensor operands (the geometry gets none). CUDA tensors
    run the kernel; CPU tensors run `fused_metadata_volume_bwd_reference`."""
    ops = (cur, src, A, b, origins, invK, planes, base, w_visT, w_metaT, w_plane,
           w_fc1T, b_fc1, w_fc2)
    dims = _check_operands(*ops, None)
    B, K, H, W, C, D, F_ = dims
    if tuple(ct.shape) != (B, D, H, W) or ct.dtype != torch.float32:
        raise ValueError(f"ct must be ({B}, {D}, {H}, {W}) float32, got {tuple(ct.shape)} {ct.dtype}")
    if ct.device != src.device or not ct.is_contiguous():
        raise ValueError("ct must be contiguous and on the operands' device")
    if src.device.type == "cuda":
        return _launch_bwd(ct, ops, dims)
    if src.device.type != "cpu":
        raise ValueError(f"no fused volume backward for device {src.device}")
    return fused_metadata_volume_bwd_reference(ct, *ops)


fused_metadata_volume_bwd.launches = 0


def fused_metadata_volume_bwd_reference(ct: Tensor, cur: Tensor, src: Tensor, A: Tensor,
                                        b: Tensor, origins: Tensor, invK: Tensor,
                                        planes: Tensor, base: Tensor, w_visT: Tensor,
                                        w_metaT: Tensor, w_plane: Tensor, w_fc1T: Tensor,
                                        b_fc1: Tensor, w_fc2: Tensor) -> FusedVolumeCotangents:
    """Plain version of the backward: the JAX kernel's backward
    (`_fused_bwd_kernel`) written out in tensor code, in f32. With bf16
    features it rounds vis, h1, dh2p and dacc to bf16 before the products
    that take them, where that kernel does (implicit_depth_tpu/ops/
    fused_volume.py:487, :522, :534, :539); dW_metaT, ddot, dw_plane and the
    bias and fc2 gradients come from the f32 values, as there. Autograd
    carries only the warped features' cotangent through the gather's
    transpose to dsrc."""
    B, K, H, W, C = src.shape
    F_ = base.shape[2]
    rnd = _rounding(src.dtype)
    ct, A, b, origins, invK, planes, base, w_visT, w_metaT, w_plane, w_fc1T, b_fc1, w_fc2 = (
        x.detach() for x in (ct, A, b, origins, invK, planes, base, w_visT, w_metaT, w_plane,
                             w_fc1T, b_fc1, w_fc2))
    src32 = src.detach().float().requires_grad_(True)
    cur32 = cur.detach().float()
    with torch.enable_grad():
        p = _forward_parts(cur32, src32, A, b, origins, invK, planes, base, w_visT, w_metaT,
                           w_plane, w_fc1T, b_fc1, rnd)
    vis, meta, acc, h1, h2p = (x.detach() for x in p[1:])

    def slope(x):
        return torch.where(x > 0, 1.0, 0.01)

    def rows(x):  # (..., n) -> (points, n)
        return x.reshape(-1, x.shape[-1])

    ctx = ct[..., None]                                  # (B, D, H, W, 1)
    dh2p = w_fc2[:, 0] * ctx * slope(h2p)
    dh2pc = rnd(dh2p)
    dacc = (dh2pc @ w_fc1T.float()) * slope(acc)        # dh1 leaky'(acc)
    daccc = rnd(dacc)
    ddot = dacc @ w_metaT.reshape(F_, K, 8)[:, :, 1]     # (B, D, H, W, K)
    dvis = (daccc @ w_visT.float()).reshape(B, *ddot.shape[1:], C)
    dcur = (vis.reshape(dvis.shape) * ddot[..., None]).sum(dim=(1, 4))
    dwarped = dvis + cur32[:, None, :, :, None] * ddot[..., None]
    dsrc, = torch.autograd.grad(p.feats, src32, dwarped.permute(0, 4, 1, 2, 3, 5))
    return FusedVolumeCotangents(
        dsrc=dsrc, dcur=dcur, dbase=dacc.sum(1).permute(0, 1, 3, 2).contiguous(),
        dw_visT=rows(daccc).t() @ rows(vis), dw_metaT=rows(dacc).t() @ rows(meta),
        dw_plane=rows(dacc * planes[:, None, None, None]).sum(0)[:, None],
        dw_fc1T=rows(dh2pc).t() @ rows(h1), db_fc1=rows(dh2p).sum(0)[:, None],
        dw_fc2=rows(F.leaky_relu(h2p, 0.01) * ctx).sum(0)[:, None], db_fc2=ct.sum().reshape(1))


class _FusedVolumeTrain(torch.autograd.Function):
    """Forward: `fused_metadata_volume`; backward: `fused_metadata_volume_bwd`.
    Gradients flow to the features and the repacked weights; the geometry
    operands get None."""

    @staticmethod
    def forward(ctx, cur, src, A, b, origins, invK, planes, base, w_visT, w_metaT, w_plane,
                w_fc1T, b_fc1, w_fc2, b_fc2):
        # the kernel reads w_visT and w_fc1T in the features' dtype; the
        # gradients go back to them in f32, as the JAX package's do
        ops = (cur, src, A, b, origins, invK, planes, base, w_visT.to(src.dtype), w_metaT,
               w_plane, w_fc1T.to(src.dtype), b_fc1, w_fc2)
        ctx.save_for_backward(*ops)
        return fused_metadata_volume(*ops, b_fc2)

    @staticmethod
    def backward(ctx, ct):
        ops = ctx.saved_tensors
        g = fused_metadata_volume_bwd(ct.float().contiguous(), *ops)
        return (g.dcur.to(ops[0].dtype), g.dsrc.to(ops[1].dtype), None, None, None, None, None,
                g.dbase, g.dw_visT, g.dw_metaT, g.dw_plane, g.dw_fc1T, g.db_fc1, g.dw_fc2,
                g.db_fc2)


def fused_metadata_volume_train(cur: Tensor, src: Tensor, A: Tensor, b: Tensor, origins: Tensor,
                                invK: Tensor, planes: Tensor, base: Tensor, w_visT: Tensor,
                                w_metaT: Tensor, w_plane: Tensor, w_fc1T: Tensor, b_fc1: Tensor,
                                w_fc2: Tensor, b_fc2: Tensor) -> Tensor:
    """The differentiable volume (B, D, H, W) f32: forward kernel #1,
    backward kernel #2 (their plain versions on CPU tensors). The operands
    are `fused_metadata_volume`'s, except that w_visT and w_fc1T may be f32
    (they are cast to the features' dtype for the kernel); every gradient
    but dcur and dsrc is f32."""
    return _FusedVolumeTrain.apply(cur, src, A, b, origins, invK, planes, base, w_visT,
                                   w_metaT, w_plane, w_fc1T, b_fc1, w_fc2, b_fc2)
