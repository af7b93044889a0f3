"""Per-frame model-output caching (parity: utils/generic_utils.py:249-283
cache_model_outputs and the --cache_depths path, test_bd.py:406-428).

Outputs are pickled one file per frame keyed by frame_id, including the
auxiliary intrinsics the downstream fusion/visualisation tools expect.

Copy of implicit_depth_tpu/utils/caching.py (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np


def cache_model_outputs(
    output_path: str,
    outputs: dict,
    cur_data: dict,
    src_data: dict,
    batch_ind: int,
    batch_size: int,
    predictions_to_save: Optional[Sequence[str]] = None,
) -> list[str]:
    os.makedirs(output_path, exist_ok=True)
    frame_ids = cur_data.get("frame_id_string")
    n = len(next(iter(v for k, v in outputs.items() if hasattr(v, "shape"))))
    saved = []
    keys = list(predictions_to_save) if predictions_to_save is not None else [
        k for k, v in outputs.items() if hasattr(v, "shape")
    ]
    for ei in range(n):
        frame_id = frame_ids[ei] if frame_ids else f"{batch_ind * batch_size + ei:06d}"
        elem = {k: np.asarray(outputs[k][ei])[None] for k in keys if k in outputs}
        for aux in ("K_full_depth", "K_s0"):
            if aux in cur_data:
                elem[aux] = np.asarray(cur_data[aux][ei])[None]
        elem["frame_id"] = frame_id
        if "frame_id_string" in src_data:
            elem["src_ids"] = [s[ei] for s in src_data["frame_id_string"]] \
                if isinstance(src_data["frame_id_string"][0], (list, tuple)) \
                else list(src_data["frame_id_string"])
        path = os.path.join(output_path, f"{frame_id}.pickle")
        with open(path, "wb") as f:
            pickle.dump(elem, f)
        saved.append(path)
    return saved


def load_cached_output(output_path: str, frame_id: str) -> dict:
    with open(os.path.join(output_path, f"{frame_id}.pickle"), "rb") as f:
        return pickle.load(f)
