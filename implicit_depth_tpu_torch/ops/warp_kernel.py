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
- `sample_points` / `sample_coords`: the kernels' sample coordinates, bit
  for bit; `candidate_boxes`: the mirror of the transpose kernel's rule
  for which output pixels may reach a source tile (a gather needs it; the
  CPU tests hold it to every tap).
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
import itertools
import math

import numpy as np
import torch

from implicit_depth_tpu_torch.core.sampling import sample_bilinear_idx
from implicit_depth_tpu_torch.ops import cuda_build

Tensor = torch.Tensor

CHANNELS = 16  # channels the kernels are compiled for

# the transpose's tile (texels wide, high), as the library's
# warp_planes_bwd_tile_width / _height give it (a card test holds the two equal)
BWD_TILE = (16, 16)

_PTR = ctypes.c_void_p
_SIGNATURES = {
    **{name: ([_PTR] * 5 + [ctypes.c_int] * 5 + [_PTR], ctypes.c_int)
       for name in ("warp_planes_f32", "warp_planes_bf16", "warp_planes_bwd_f32",
                    "warp_planes_bwd_bf16")},
    "warp_planes_bwd_tile_width": ([], ctypes.c_int),
    "warp_planes_bwd_tile_height": ([], ctypes.c_int),
    "warp_planes_bwd_smem_bytes": ([ctypes.c_int], ctypes.c_int),
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


def sample_points(A: Tensor, b: Tensor, planes: Tensor, H: int, W: int) -> tuple:
    """Index-space sample coordinates (x, y), each (K', D, H, W) f32, of
    every output point, and where z sits at its clamp (r2 <= 1e-5). One
    rounding per operation, in the kernels' order (they avoid FMA
    contraction for this), so the coordinates are the kernels' bit for bit:
    p = (a0 u + a1 v) + a2 per row of A at the pixel centre (u, v),
    r = plane p + b, z = max(r2, 1e-5)."""
    u = torch.arange(W, dtype=torch.float32, device=A.device) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=A.device) + 0.5

    def row(i):
        p = (A[:, i, 0, None, None] * u[None, None, :] + A[:, i, 1, None, None] * v[None, :, None]
             + A[:, i, 2, None, None])                                          # (K', H, W)
        return planes[None, :, None, None] * p[:, None] + b[:, i, None, None, None]

    r2 = row(2)
    z = torch.clamp(r2, min=1e-5)
    x = torch.clamp(row(0) / z - 0.5, -2.0 * W, 2.0 * W)
    y = torch.clamp(row(1) / z - 0.5, -2.0 * H, 2.0 * H)
    return x, y, ~(r2 > 1e-5)


def sample_coords(A: Tensor, b: Tensor, planes: Tensor, H: int, W: int) -> tuple:
    """(x, y) of `sample_points`."""
    return sample_points(A, b, planes, H, W)[:2]


F32_CLAMP = float(np.float32(1e-5))  # z's clamp as the kernels hold it (f32)


def _clip_polygon(pts: list, h: tuple) -> list:
    """The polygon pts clipped by a u + b v + c >= 0 (Sutherland-Hodgman)."""
    a, b, c = h
    out = []
    for i, (xi, yi) in enumerate(pts):
        xj, yj = pts[(i + 1) % len(pts)]
        si, sj = a * xi + b * yi + c, a * xj + b * yj + c
        if si >= 0.0:
            out.append((xi, yi))
        if (si >= 0.0) != (sj >= 0.0):
            t = si / (si - sj)
            out.append((xi + t * (xj - xi), yi + t * (yj - yi)))
    return out


def _half_planes(R: list, e: list, lo: list, hi: list, clamped: bool) -> list:
    """The five half-planes (a, b, c): a u + b v + c >= 0 of one case, r_i =
    R[i] . (u, v, 1): r2 > 1e-5 and lo r2 <= r_j <= hi r2, or r2 <= 1e-5 and
    lo z <= r_j <= hi z at the clamp z; each loosened by the rounding bounds e."""
    r2 = R[2]
    if clamped:
        hp = [(-r2[0], -r2[1], F32_CLAMP + e[2] - r2[2])]
    else:
        hp = [(r2[0], r2[1], r2[2] - F32_CLAMP + e[2])]
    for j in range(2):
        rj = R[j]
        if clamped:
            hp.append((rj[0], rj[1], rj[2] - lo[j] * F32_CLAMP + e[j]))
            hp.append((-rj[0], -rj[1], hi[j] * F32_CLAMP - rj[2] + e[j]))
        else:
            hp.append((rj[0] - lo[j] * r2[0], rj[1] - lo[j] * r2[1],
                       rj[2] - lo[j] * r2[2] + e[j] + abs(lo[j]) * e[2]))
            hp.append((hi[j] * r2[0] - rj[0], hi[j] * r2[1] - rj[1],
                       hi[j] * r2[2] - rj[2] + e[j] + abs(hi[j]) * e[2]))
    return hp


def _pixel_box(poly: list, H: int, W: int) -> tuple:
    """(u0, u1, v0, v1) of the pixels inside the polygon's bounding box,
    (1, 0, 1, 0) when none."""
    if not poly:
        return (1, 0, 1, 0)
    us, vs = [p[0] for p in poly], [p[1] for p in poly]
    u0, u1 = max(0, math.ceil(min(us) - 1e-6)), min(W - 1, math.floor(max(us) + 1e-6))
    v0, v1 = max(0, math.ceil(min(vs) - 1e-6)), min(H - 1, math.floor(max(vs) + 1e-6))
    return (u0, u1, v0, v1) if u0 <= u1 and v0 <= v1 else (1, 0, 1, 0)


def candidate_boxes(A: Tensor, b: Tensor, planes: Tensor, H: int, W: int,
                    tile: tuple = BWD_TILE) -> np.ndarray:
    """Mirror of the transpose kernel's candidate boxes (warp_planes.cu,
    bwd::candidate_boxes), in f64: for every view, plane and tile of
    tile[0] x tile[1] texels, (u0, u1, v0, v1) of the pixels that may reach
    the tile, [..., 0] with r2 > 1e-5 and [..., 1] with z at its clamp;
    (1, 0, 1, 0) when empty. Returns (K', D, tiles_y, tiles_x, 2, 4) int.

    A tap reaches the tile iff x in [tx0 - 1, tx1 + 1), i.e. r0 / z in
    [tx0 - .5, tx1 + 1.5), and likewise y. r is affine in (u, v), so each
    bound is a half-plane (`_half_planes`), loosened by e_i, a bound on the
    forward's f32 rounding of r_i over the image, and the tile by eps, its
    rounding of the divide. The box is the bounding box of the image
    rectangle clipped by the five half-planes of the case."""
    tw, th = tile
    nty, ntx = -(-H // th), -(-W // tw)
    boxes = np.zeros((A.shape[0], planes.shape[0], nty, ntx, 2, 4), np.int64)
    eps = 0.01 + (W + H) * 2.0 ** -20
    rect = [(0.0, 0.0), (W - 1.0, 0.0), (W - 1.0, H - 1.0), (0.0, H - 1.0)]
    for k, (a, bk) in enumerate(zip(A.double().tolist(), b.double().tolist())):
        for d, dep in enumerate(planes.double().tolist()):
            R = [(dep * a[i][0], dep * a[i][1],
                  dep * (0.5 * a[i][0] + 0.5 * a[i][1] + a[i][2]) + bk[i]) for i in range(3)]
            e = [2.0 ** -22 * (2.0 * abs(dep) * (abs(a[i][0]) * W + abs(a[i][1]) * H
                                                 + abs(a[i][2])) + abs(bk[i])) for i in range(3)]
            for ty, tx, clamped in itertools.product(range(nty), range(ntx), (False, True)):
                t0 = (tx * tw, ty * th)
                t1 = (min(t0[0] + tw, W) - 1, min(t0[1] + th, H) - 1)
                lo = [t0[j] - 0.5 - eps for j in range(2)]
                hi = [t1[j] + 1.5 + eps for j in range(2)]
                poly = rect
                for h in _half_planes(R, e, lo, hi, clamped):
                    poly = _clip_polygon(poly, h) if poly else poly
                boxes[k, d, ty, tx, int(clamped)] = _pixel_box(poly, H, W)
    return boxes


def warp_planes_reference(src: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """Plain PyTorch version: the gather sampler at the kernels'
    coordinates, f32 weights and sums, one rounding to src's dtype."""
    H, W = src.shape[1], src.shape[2]
    x, y = sample_coords(A, b, planes, H, W)
    return sample_bilinear_idx(src.float(), x, y).to(src.dtype)


def warp_planes_bwd(ct: Tensor, A: Tensor, b: Tensor, planes: Tensor) -> Tensor:
    """d(warp_planes)/d(src) applied to the cotangent ct (K', D, H, W, C):
    (K', H, W, C) in ct's dtype, summed in f32. CUDA tensors run the kernel
    (a gather: each source texel summed by one block in a fixed order, so
    two launches give the same bits); CPU tensors run
    `warp_planes_bwd_reference`."""
    K, H, W, C, D = _check(ct, A, b, planes, rank=5)
    if ct.device.type == "cpu":
        return warp_planes_bwd_reference(ct, A, b, planes)
    _kernel_ready(ct, C, "warp_planes_bwd")
    cuda_build.check_aligned((ct, A, b, planes), "warp_planes_bwd")
    out = torch.empty((K, H, W, C), dtype=ct.dtype, device=ct.device)
    lib = cuda_build.load("warp_planes.cu", _SIGNATURES)
    fn = lib.warp_planes_bwd_f32 if ct.dtype == torch.float32 else lib.warp_planes_bwd_bf16
    stream = torch.cuda.current_stream(ct.device).cuda_stream
    with torch.cuda.device(ct.device):
        err = fn(ct.data_ptr(), A.data_ptr(), b.data_ptr(), planes.data_ptr(), out.data_ptr(),
                 K, H, W, C, D, stream)
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
