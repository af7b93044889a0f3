"""DVMVS keyframe selection (host-side numpy).

Copy of implicit_depth_tpu/data/keyframes.py with only its imports changed
(the port imports nothing of the JAX package).

Behavioural parity with tools/keyframe_buffer.py (itself adapted from
DeepVideoMVS): online keyframe buffer with tracking-lost handling, a
simple FIFO buffer, and an offline (past+future) variant. These drive
tuple generation and online inference; they are control flow over poses
and stay on the host.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np


class DVMVSConfig:
    train_minimum_pose_distance = 0.125
    train_maximum_pose_distance = 0.325
    train_crawl_step = 3
    test_keyframe_buffer_size = 30
    test_keyframe_pose_distance = 0.1
    test_optimal_t_measure = 0.15
    test_optimal_R_measure = 0.0


class DVMVSHypersimConfig(DVMVSConfig):
    train_maximum_pose_distance = 2.5


def pose_distance_np(reference_pose: np.ndarray, measurement_pose: np.ndarray):
    """Relative DVMVS pose distance between two camera-to-world poses
    (tools/keyframe_buffer.py:69-85)."""
    rel = np.linalg.inv(reference_pose) @ measurement_pose
    R, t = rel[:3, :3], rel[:3, 3]
    r_measure = np.sqrt(2 * (1 - min(3.0, np.trace(R)) / 3))
    t_measure = np.linalg.norm(t)
    return np.sqrt(t_measure**2 + r_measure**2), r_measure, t_measure


def is_pose_available(pose: np.ndarray) -> bool:
    return bool(np.isfinite(pose).all())


def is_valid_pair(reference_pose, measurement_pose, pose_dist_min, pose_dist_max,
                  t_norm_threshold: float = 0.05, return_measure: bool = False):
    combined, _, t = pose_distance_np(reference_pose, measurement_pose)
    ok = pose_dist_min <= combined <= pose_dist_max and t >= t_norm_threshold
    return (ok, combined) if return_measure else ok


def _penalty(t_score, r_score, optimal_t, optimal_r):
    """Frame-selection penalty (tools/keyframe_buffer.py:105-113)."""
    r_pen = abs(r_score - optimal_r) ** 2.0
    t_diff = t_score - optimal_t
    t_pen = (5.0 if t_diff < 0 else 1.0) * abs(t_diff) ** 2.0
    return r_pen + t_pen


class KeyframeBuffer:
    """Online keyframe buffer (tools/keyframe_buffer.py:88-205).

    try_new_keyframe status codes match the reference:
    0 first frame, 1 added, 2 not enough motion, 3 tracking lost/reset,
    4 still lost, 5 pose missing but not lost yet.
    """

    def __init__(self, buffer_size: int, keyframe_pose_distance: float,
                 optimal_t_score: float, optimal_R_score: float,
                 store_return_indices: bool = False):
        self.buffer: deque = deque([], maxlen=buffer_size)
        self.keyframe_pose_distance = keyframe_pose_distance
        self.optimal_t_score = optimal_t_score
        self.optimal_R_score = optimal_R_score
        self._lost_counter = 0
        self._store_indices = store_return_indices

    def _entry(self, pose, image, index):
        return (pose, image, index) if self._store_indices else (pose, image)

    def try_new_keyframe(self, pose, image, dist_to_last_valid: Optional[int] = None,
                         index: Optional[int] = None) -> int:
        if self._store_indices and index is None:
            raise ValueError("index required when store_return_indices is set")

        if dist_to_last_valid is not None and dist_to_last_valid > 30:
            self.buffer.clear()
            self._lost_counter = 0
            self.buffer.append(self._entry(pose, image, index))
            return 3

        if is_pose_available(pose):
            self._lost_counter = 0
            if not self.buffer:
                self.buffer.append(self._entry(pose, image, index))
                return 0
            last_pose = self.buffer[-1][0]
            combined, _, _ = pose_distance_np(pose, last_pose)
            if combined >= self.keyframe_pose_distance:
                self.buffer.append(self._entry(pose, image, index))
                return 1
            return 2

        self._lost_counter += 1
        if self._lost_counter > 30:
            if self.buffer:
                self.buffer.clear()
                return 3
            return 4
        return 5

    def get_best_measurement_frames(self, n_requested: int):
        frames = list(self.buffer)
        ref_pose = frames[-1][0]
        n = min(n_requested, len(frames) - 1)
        penalties = []
        for i in range(len(frames) - 1):
            _, r, t = pose_distance_np(ref_pose, frames[i][0])
            penalties.append(_penalty(t, r, self.optimal_t_score, self.optimal_R_score))
        idx = np.argpartition(penalties, n - 1)[:n]
        return [frames[i] for i in idx]


class SimpleBuffer:
    """FIFO buffer (tools/keyframe_buffer.py:208-264)."""

    def __init__(self, buffer_size: int, store_return_indices: bool = False):
        self.buffer: deque = deque([], maxlen=buffer_size + 1)
        self._lost_counter = 0
        self._store_indices = store_return_indices

    def try_new_keyframe(self, pose, image, index: Optional[int] = None) -> int:
        if self._store_indices and index is None:
            raise ValueError("index required when store_return_indices is set")
        if is_pose_available(pose):
            self._lost_counter = 0
            entry = (pose, image, index) if self._store_indices else (pose, image)
            first = not self.buffer
            self.buffer.append(entry)
            return 0 if first else 1
        self._lost_counter += 1
        if self._lost_counter > 30:
            if self.buffer:
                self.buffer.clear()
                return 2
            return 3
        return 4

    def get_measurement_frames(self):
        return list(self.buffer)[:-1]


class OfflineKeyframeBuffer(KeyframeBuffer):
    """Offline buffer: a frame must be far from EVERY buffered keyframe
    (tools/keyframe_buffer.py:267-408); also selects future frames for
    the oldest entry."""

    def try_new_keyframe(self, pose, image, index: Optional[int] = None) -> int:
        if self._store_indices and index is None:
            raise ValueError("index required when store_return_indices is set")
        if is_pose_available(pose):
            self._lost_counter = 0
            if not self.buffer:
                self.buffer.append(self._entry(pose, image, index))
                return 0
            for buffered in self.buffer:
                combined, _, _ = pose_distance_np(pose, buffered[0])
                if combined < self.keyframe_pose_distance:
                    return 2
            self.buffer.append(self._entry(pose, image, index))
            return 1
        self._lost_counter += 1
        if self._lost_counter > 30:
            if self.buffer:
                self.buffer.clear()
                return 3
            return 4
        return 5

    def get_best_measurement_frames_for_0index(self, n_requested: int):
        frames = list(self.buffer)[1:]
        if not frames:
            return []
        ref_pose = frames[0][0]
        n = min(n_requested, len(frames) - 1)
        penalties = []
        for f in frames:
            _, r, t = pose_distance_np(ref_pose, f[0])
            penalties.append(_penalty(t, r, self.optimal_t_score, self.optimal_R_score))
        idx = np.argpartition(penalties, n - 1)[:n]
        return [frames[i] for i in idx]
