"""Builds the host-side C++ libraries the port binds with ctypes (the
image decoder csrc/imageio.cpp and the mesh rasterizer csrc/rasterizer.cpp
at the repository root) into the port's git-ignored
implicit_depth_tpu_torch/csrc/build/, never beside their sources.

A library's name holds a hash of its source and flags, so an edit builds a
new one; g++ writes to a temporary name that is then renamed into place, so
processes that build the same library at once do not see a partial file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

REPO_CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"


def build_library(source: str, flags: tuple = ("-O3",), link: tuple = ()) -> Path:
    """Path of the shared library of REPO_CSRC/source, compiled with
    `g++ <flags> -shared -fPIC <source> -o <lib> <link>` if it is not built
    yet. Raises subprocess.CalledProcessError if g++ fails."""
    src = REPO_CSRC / source
    cmd_flags = (*flags, "-shared", "-fPIC")
    digest = hashlib.sha256(" ".join(cmd_flags + tuple(link)).encode())
    digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *cmd_flags, str(src), "-o", str(tmp), *link], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out
