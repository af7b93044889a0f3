"""Fused metadata volume: plane-sweep warp + closed-form metadata + the
202 -> 128 -> 128 -> 1 MLP, one hand-written CUDA kernel (eval path).

Replaces the TPU kernel implicit_depth_tpu/ops/fused_volume.py::
_fused_kernel (wrapper `fused_metadata_volume`). The kernel is in
csrc/fused_volume.cu; this module holds

- `fused_metadata_volume`: the dispatch wrapper. A CPU tensor goes to the
  plain version; a CUDA tensor launches the kernel or raises. Its
  `launches` attribute counts kernel launches, and nothing else.
- `fused_metadata_volume_reference`: the plain PyTorch version on the same
  operands, built from the port's warp (volumes/cost_volume.py) and the
  repacked first-layer weights. The CPU tests and chip_smoke.py compare
  against it.
- `build`: nvcc into a shared library with a plain C entry point, keyed on
  a hash of the sources and flags, in csrc/build/, at the first CUDA call.

Operands (the TPU kernel's contract): cur (B,H,W,C) and src (B,K,H,W,C)
in the compute dtype (f32 or bf16); A (B,K,3,3), b and origins (B,K,3),
invK (B,3,3), planes (D,), base (B,H,F,W), w_metaT (F,K*8), w_plane,
b_fc1, w_fc2 (F,1), b_fc2 (1,) in f32; w_visT (F,K*C) and w_fc1T (F,F) in
the compute dtype. Output (B,D,H,W) f32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from implicit_depth_tpu_torch.volumes.cost_volume import warped_views_from_components

Tensor = torch.Tensor

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
SOURCES = ("fused_volume.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CHANNELS = 16   # matching feature channels the kernel is compiled for
HIDDEN = 128    # MLP width the kernel is compiled for
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt in to

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                           "the fused volume kernel cannot be built")
    return path


def build() -> Path:
    """Compiles csrc/fused_volume.cu for sm_90a unless a library built from
    the same sources and flags exists. Returns the library's path; the
    compiler's output (ptxas register and spill counts) is written beside
    it with the suffix .log. Raises with nvcc's stderr on failure."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    out = BUILD_DIR / f"libfused_volume_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("fused_metadata_volume_f32", "fused_metadata_volume_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    """Dynamic shared memory of one kernel block: f32 fc0 columns for the
    source visuals and the six metadata rows of every view, fc1, and the
    three F-vectors."""
    return 4 * (num_views * (CHANNELS + 6) * HIDDEN + HIDDEN * HIDDEN + 3 * HIDDEN)


def _launch(ops: tuple, dims: tuple) -> Tensor:
    B, K, H, W, C, D, F_ = dims
    if C != CHANNELS or F_ != HIDDEN:
        raise ValueError(f"the kernel is compiled for C={CHANNELS}, F={HIDDEN}; got C={C}, F={F_}")
    if smem_bytes(K) > SMEM_LIMIT:
        raise ValueError(f"K={K} source views need {smem_bytes(K)} bytes of shared memory")
    for t in ops:
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")
    out = torch.empty((B, D, H, W), dtype=torch.float32, device=ops[0].device)
    lib = _library()
    fn = (lib.fused_metadata_volume_f32 if ops[1].dtype == torch.float32
          else lib.fused_metadata_volume_bf16)
    stream = torch.cuda.current_stream(ops[0].device).cuda_stream
    with torch.cuda.device(ops[0].device):
        err = fn(*(t.data_ptr() for t in ops), out.data_ptr(), B, K, H, W, D, stream)
    if err != 0:
        raise RuntimeError(f"fused_metadata_volume kernel launch failed: CUDA error {err}")
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


def fused_metadata_volume_reference(cur: Tensor, src: Tensor, A: Tensor, b: Tensor,
                                    origins: Tensor, invK: Tensor, planes: Tensor,
                                    base: Tensor, w_visT: Tensor, w_metaT: Tensor,
                                    w_plane: Tensor, w_fc1T: Tensor, b_fc1: Tensor,
                                    w_fc2: Tensor, b_fc2: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel on the same operands, in f32:
    the warp and metadata tensors of volumes/cost_volume.py, then the MLP
    with the repacked weights (pose and mask terms are inside `base`)."""
    B, K, H, W, C = src.shape
    D = planes.shape[0]
    no_pose = torch.zeros((B, K, 3), dtype=torch.float32, device=src.device)
    wv = warped_views_from_components(cur.float(), src.float(), A, b, origins, invK,
                                      planes, no_pose, compute_dtype=torch.float32)
    vis = wv.feats.permute(0, 2, 3, 4, 1, 5).reshape(B, D, H, W, K * C)
    zero = torch.zeros_like(wv.depths)
    meta = torch.stack([wv.depths, wv.dot, wv.ray_angle, wv.src_rays[..., 0],
                        wv.src_rays[..., 1], wv.src_rays[..., 2], zero, zero], dim=-1)
    meta = meta.permute(0, 2, 3, 4, 1, 5).reshape(B, D, H, W, K * 8)

    h1 = base.permute(0, 1, 3, 2)[:, None]  # (B, 1, H, W, F)
    h1 = h1 + planes[None, :, None, None, None] * w_plane[:, 0]
    h1 = h1 + vis @ w_visT.float().t() + meta @ w_metaT.t()
    h1 = F.leaky_relu(h1, 0.01)
    h2 = F.leaky_relu(h1 @ w_fc1T.float().t() + b_fc1[:, 0], 0.01)
    return (h2 @ w_fc2 + b_fc2)[..., 0]
