"""DVMVS pose distance (host-side numpy).

Copy of `pose_distance_np` from implicit_depth_tpu/data/keyframes.py, the
one function of that module that data/mvs_dataset.py needs. The keyframe
buffers wait for the temporal slice.
"""

from __future__ import annotations

import numpy as np


def pose_distance_np(reference_pose: np.ndarray, measurement_pose: np.ndarray):
    """Relative DVMVS pose distance between two camera-to-world poses
    (tools/keyframe_buffer.py:69-85)."""
    rel = np.linalg.inv(reference_pose) @ measurement_pose
    R, t = rel[:3, :3], rel[:3, 3]
    r_measure = np.sqrt(2 * (1 - min(3.0, np.trace(R)) / 3))
    t_measure = np.linalg.norm(t)
    return np.sqrt(t_measure**2 + r_measure**2), r_measure, t_measure
