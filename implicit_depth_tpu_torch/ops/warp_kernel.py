"""Plane-sweep warp of the source features to every depth plane, and its
transpose, as hand-written CUDA kernels.

Replaces the TPU kernels implicit_depth_tpu/ops/warp_kernel.py::
_warp_kernel (wrapper `warp_planes`) and `_warp_bwd_kernel` (wrapper
`warp_planes_bwd`, the custom VJP of `warp_planes_diff`). The kernels are
csrc/warp_planes.cu; this module holds

- `warp_planes`: the forward's dispatch wrapper. A CPU tensor goes to the
  plain version; a CUDA tensor launches the kernel or raises. Its
  `launches` attribute counts kernel launches, and nothing else.
- `warp_planes_reference`: the plain PyTorch version, the gather sampler
  (core/sampling.py::sample_bilinear_idx) on the same coordinates, f32
  weights and one rounding to the source dtype.
- `warp_planes_bwd` and `warp_planes_bwd_reference`: the transpose's
  wrapper (with its own `launches`) and plain version (autograd of the
  plain forward w.r.t. the source, accumulated in f32).
- `warp_planes_diff`: a `torch.autograd.Function` whose forward is
  `warp_planes` and whose backward is `warp_planes_bwd`. The gradient goes
  to the source features only; the geometry gets None, as in the JAX
  package's custom VJP.

Contract: src (K', H, W, C) in f32 or bf16 (K' = batch x views), A (K', 3, 3)
and b (K', 3) the homography components (geometry.homography_components),
planes (D,), all f32. Sample point of output (k', d, v, u):
r = planes[d] (A[k'] (u+.5, v+.5, 1)) + b[k'], z = max(r2, 1e-5),
(x, y) = (clip(r0/z - .5, +-2W), clip(r1/z - .5, +-2H)) in index space,
bilinear with zeros padding (F.grid_sample, align_corners=False). Output
(K', D, H, W, C) in src's dtype; the transpose returns (K', H, W, C) in the
cotangent's dtype. The kernels take C = 16 (every config's matching width).

Libraries are built by ops/cuda_build.py at the first CUDA call.
"""

from __future__ import annotations

import ctypes

import torch

from implicit_depth_tpu_torch.core.sampling import sample_bilinear_idx
from implicit_depth_tpu_torch.ops import cuda_build

Tensor = torch.Tensor

CHANNELS = 16  # channels the kernels are compiled for

_PTR = ctypes.c_void_p
_SIGNATURES = {
    **{name: ([_PTR] * 5 + [ctypes.c_int] * 5 + [_PTR], ctypes.c_int)
       for name in ("warp_planes_f32", "warp_planes_bf16")},
    **{name: ([_PTR] * 6 + [ctypes.c_int] * 5 + [_PTR], ctypes.c_int)
       for name in ("warp_planes_bwd_f32", "warp_planes_bwd_bf16")},
}


def _check(x: Tensor, A: Tensor, b: Tensor, planes: Tensor, rank: int) -> tuple:
    """Raises unless x (rank 4: src; rank 5: cotangent), A, b and planes have
    the kernels' shapes, dtypes and layout on one device. Returns
    (K', H, W, C, D)."""
    if x.dim() != rank:
        what = "src must be (K', H, W, C)" if rank == 4 else "ct must be (K', D, H, W, C)"
        raise ValueError(f"{what}, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {x.dtype}")
    K, H, W, C = (x.shape[0],) + tuple(x.shape[-3:])
    D = planes.shape[0] if planes.dim() == 1 else -1
    if rank == 5 and x.shape[1] != D:
        raise ValueError(f"ct has {x.shape[1]} planes, planes has {D}")
    for name, t, shape in (("A", A, (K, 3, 3)), ("b", b, (K, 3)), ("planes", planes, (D,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("features", x), ("A", A), ("b", b), ("planes", planes)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the features on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return K, H, W, C, D


def _kernel_ready(x: Tensor, C: int, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {what} for device {x.device}")
    if C != CHANNELS:
        raise ValueError(f"the {what} kernel takes C={CHANNELS} channels, got {C}")


def warp_planes(src: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """(K', D, H, W, C) warped features in src's dtype. CUDA tensors run the
    kernel; CPU tensors run `warp_planes_reference`."""
    K, H, W, C, D = _check(src, A, b, planes, rank=4)
    if src.device.type == "cpu":
        return warp_planes_reference(src, A, b, planes)
    _kernel_ready(src, C, "warp_planes")
    cuda_build.check_aligned((src, A, b, planes), "warp_planes")
    out = torch.empty((K, D, H, W, C), dtype=src.dtype, device=src.device)
    lib = cuda_build.load("warp_planes.cu", _SIGNATURES)
    fn = lib.warp_planes_f32 if src.dtype == torch.float32 else lib.warp_planes_bf16
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), A.data_ptr(), b.data_ptr(), planes.data_ptr(), out.data_ptr(),
                 K, H, W, C, D, stream)
    cuda_build.check(err, "warp_planes")
    warp_planes.launches += 1
    return out


warp_planes.launches = 0


def sample_coords(A: Tensor, b: Tensor, planes: Tensor, H: int, W: int) -> tuple:
    """Index-space sample coordinates (x, y), each (K', D, H, W) f32, of
    every output point. One rounding per operation, in the kernels' order
    (they avoid FMA contraction for this), so the coordinates are the
    kernels' bit for bit: p = (a0 u + a1 v) + a2 per row of A at the pixel
    centre (u, v), r = plane p + b, z = max(r2, 1e-5)."""
    u = torch.arange(W, dtype=torch.float32, device=A.device) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=A.device) + 0.5

    def row(i):
        p = (A[:, i, 0, None, None] * u[None, None, :] + A[:, i, 1, None, None] * v[None, :, None]
             + A[:, i, 2, None, None])                                          # (K', H, W)
        return planes[None, :, None, None] * p[:, None] + b[:, i, None, None, None]

    z = torch.clamp(row(2), min=1e-5)
    x = torch.clamp(row(0) / z - 0.5, -2.0 * W, 2.0 * W)
    y = torch.clamp(row(1) / z - 0.5, -2.0 * H, 2.0 * H)
    return x, y


def warp_planes_reference(src: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """Plain PyTorch version: the gather sampler at the kernels'
    coordinates, f32 weights and sums, one rounding to src's dtype."""
    H, W = src.shape[1], src.shape[2]
    x, y = sample_coords(A, b, planes, H, W)
    return sample_bilinear_idx(src.float(), x, y).to(src.dtype)


def warp_planes_bwd(ct: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """d(warp_planes)/d(src) applied to the cotangent ct (K', D, H, W, C):
    (K', H, W, C) in ct's dtype, summed in f32. CUDA tensors run the kernel;
    CPU tensors run `warp_planes_bwd_reference`."""
    K, H, W, C, D = _check(ct, A, b, planes, rank=5)
    if ct.device.type == "cpu":
        return warp_planes_bwd_reference(ct, A, b, planes)
    _kernel_ready(ct, C, "warp_planes_bwd")
    cuda_build.check_aligned((ct, A, b, planes), "warp_planes_bwd")
    acc = torch.empty((K, H, W, C), dtype=torch.float32, device=ct.device)
    out = acc if ct.dtype == torch.float32 else torch.empty_like(acc, dtype=ct.dtype)
    lib = cuda_build.load("warp_planes.cu", _SIGNATURES)
    fn = lib.warp_planes_bwd_f32 if ct.dtype == torch.float32 else lib.warp_planes_bwd_bf16
    stream = torch.cuda.current_stream(ct.device).cuda_stream
    with torch.cuda.device(ct.device):
        err = fn(ct.data_ptr(), A.data_ptr(), b.data_ptr(), planes.data_ptr(), acc.data_ptr(),
                 out.data_ptr(), K, H, W, C, D, stream)
    cuda_build.check(err, "warp_planes_bwd")
    warp_planes_bwd.launches += 1
    return out


warp_planes_bwd.launches = 0


def warp_planes_bwd_reference(ct: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """Plain version of the transpose: autograd of `warp_planes_reference`
    w.r.t. the source, in f32, cast to ct's dtype."""
    K, _, H, W, C = ct.shape
    src = torch.zeros((K, H, W, C), dtype=torch.float32, device=ct.device, requires_grad=True)
    with torch.enable_grad():
        out = warp_planes_reference(src, A, b, planes)
        (grad,) = torch.autograd.grad(out, src, ct.float())
    return grad.to(ct.dtype)


class _WarpPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, A, b, planes):
        ctx.save_for_backward(A, b, planes)
        return warp_planes(src, A, b, planes)

    @staticmethod
    def backward(ctx, ct):
        A, b, planes = ctx.saved_tensors
        return warp_planes_bwd(ct.contiguous(), A, b, planes), None, None, None


def warp_planes_diff(src: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """Differentiable `warp_planes`: forward kernel #5, backward kernel #6
    (their plain versions on CPU tensors). Gradients flow to src only; the
    poses, intrinsics and planes are constants of the training graph."""
    return _WarpPlanes.apply(src, A, b, planes)
