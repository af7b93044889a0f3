"""Builds and loads the port's CUDA kernels (csrc/*.cu) for Hopper.

Each source becomes its own shared library with a plain C interface,
compiled by nvcc for sm_90a into csrc/build/ (git-ignored) under a name
keyed on a hash of the source, the shared headers and the flags, and loaded
with ctypes. `build` starts one nvcc per missing library, all at once, and
waits for them together. The compiler's output (the ptxas register, shared
memory and spill report) is written beside each library with the suffix
.log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
SOURCES = ("fused_volume.cu", "fused_volume_bwd.cu", "ray_head.cu", "warp_planes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt in to

_libs: dict = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump) on PATH or in
    $CUDA_HOME/bin."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which(name) or os.path.join(cuda_home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (looked on PATH and in $CUDA_HOME/bin)")
    return path


def library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict:
    """Compiles every source whose library does not exist yet, one nvcc per
    source, all started together. Returns {source: library path}. Raises
    with nvcc's stderr if any compile fails."""
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = cuda_tool("nvcc")
        procs = []
        for s, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
            procs.append((out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failures = []
        for out, tmp, cmd, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}")
                continue
            out.with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("\n".join(failures))
    return paths


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """The library built from `source`, with {function: (argtypes, restype)}
    set; built at the first call."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build((source,))[source]))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[source] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_aligned(tensors, what: str) -> None:
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")
