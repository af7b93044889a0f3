"""Copy of implicit_depth_tpu/train/logging.py (the port imports nothing of the JAX
package); only this first paragraph differs.

Experiment logging: TensorBoard + code-state snapshot.

Replaces Lightning's TensorBoardLogger + copy_code_state
(train_bd.py:117-128; utils/generic_utils.py:16-33). Scalars also mirror
to a JSONL file so headless runs stay inspectable without TB.
"""

from __future__ import annotations

import fnmatch
import json
import os
import shutil
import time
import numpy as np


class ExperimentLogger:
    def __init__(self, log_dir: str, name: str, use_tensorboard: bool = True):
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(self.dir)
            except ImportError:
                pass

    def log_scalars(self, step: int, scalars: dict, prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            val = float(np.asarray(v))
            rec[key] = val
            if self.tb:
                self.tb.add_scalar(key, val, int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_image(self, step: int, tag: str, image_hw3: np.ndarray) -> None:
        if self.tb:
            self.tb.add_image(tag, np.asarray(image_hw3), int(step), dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self.tb:
            self.tb.close()


def _read_gitignore(root: str) -> list[str]:
    path = os.path.join(root, ".gitignore")
    if not os.path.exists(path):
        return []
    pats = []
    for line in open(path):
        line = line.strip()
        if line and not line.startswith("#"):
            pats.append(line.rstrip("/"))
    return pats


def copy_code_state(dest: str, root: str | None = None) -> None:
    """Snapshots the code tree for reproducibility, honouring .gitignore
    (utils/generic_utils.py:16-33, without shelling out to rsync).

    Defaults to the REPOSITORY root (derived from this file), never the
    process cwd — a cwd snapshot can recurse into its own output
    directory or copy arbitrary host files when a CLI runs elsewhere.
    """
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dest_abs = os.path.abspath(dest)
    patterns = _read_gitignore(root) + [".git", ".cache", "*.msgpack", "*.so"]

    def ignored(rel: str) -> bool:
        base = os.path.basename(rel)
        return any(
            fnmatch.fnmatch(base, p) or fnmatch.fnmatch(rel, p) or rel.startswith(p + "/")
            for p in patterns
        )

    for dirpath, dirnames, filenames in os.walk(root):
        dp_abs = os.path.abspath(dirpath)
        if dp_abs == dest_abs or dp_abs.startswith(dest_abs + os.sep):
            dirnames[:] = []  # never descend into our own snapshot
            continue
        rel_dir = os.path.relpath(dirpath, root)
        rel_dir = "" if rel_dir == "." else rel_dir
        dirnames[:] = [d for d in dirnames
                       if not ignored(os.path.join(rel_dir, d) if rel_dir else d)]
        for fn in filenames:
            rel = os.path.join(rel_dir, fn) if rel_dir else fn
            if ignored(rel):
                continue
            dst = os.path.join(dest, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(os.path.join(dirpath, fn), dst)
