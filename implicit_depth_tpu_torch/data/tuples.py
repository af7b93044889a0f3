"""Frame-tuple generation (parity: data_scripts/generate_test_tuples.py and
generate_train_tuples.py).

Copy of implicit_depth_tpu/data/tuples.py with only its imports changed
(the port imports nothing of the JAX package).

Pure functions over pose lists; dataset glue lives in `generate_tuples_for_scan`.
Tuple types (generate_test_tuples.py:26-43):
  default        online DVMVS keyframes (sources strictly in the past)
  offline        keyframes with past+future sources
  dense          an online tuple for EVERY frame
  dense_offline  past+future sources for every frame
Short tuples are padded with random recent non-keyframe frames
(generate_test_tuples.py:472-502).

Train tuples: multi-offset forward/backward crawls with loosening pose
windows (generate_train_tuples.py:57-137, 229-377).
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np

from implicit_depth_tpu_torch.data.keyframes import (
    DVMVSConfig,
    KeyframeBuffer,
    OfflineKeyframeBuffer,
    is_valid_pair,
)


def _test_buffer(cls=KeyframeBuffer, config=DVMVSConfig):
    return cls(
        buffer_size=config.test_keyframe_buffer_size,
        keyframe_pose_distance=config.test_keyframe_pose_distance,
        optimal_t_score=config.test_optimal_t_measure,
        optimal_R_score=config.test_optimal_R_measure,
        store_return_indices=True,
    )


def default_tuples(poses: Sequence[np.ndarray], dists_to_last_valid, n_src: int,
                   config=DVMVSConfig) -> list[list[int]]:
    """Online keyframe tuples; indices [ref, src...]."""
    buf = _test_buffer(config=config)
    samples = []
    for i, pose in enumerate(poses):
        resp = buf.try_new_keyframe(pose.copy(), None,
                                    dist_to_last_valid=dists_to_last_valid[i], index=i)
        if resp == 1:
            frames = buf.get_best_measurement_frames(n_src)
            samples.append([i] + [f[2] for f in frames])
    return samples


def offline_tuple_for_index(poses, n_src: int, i: int, config=DVMVSConfig) -> list[int]:
    """Fills a buffer by alternately stepping forward/backward from i, then
    selects sources for the reference (generate_test_tuples.py:85-161)."""
    buf = _test_buffer(cls=OfflineKeyframeBuffer, config=config)
    buf.try_new_keyframe(poses[i].copy(), None, index=i)
    back, fwd = i - 1, i + 1
    direction = True
    added = 0
    exhausted_f = exhausted_b = False
    while not (exhausted_f and exhausted_b):
        if direction:
            direction = False
            if fwd >= len(poses):
                exhausted_f = True
                continue
            j, fwd = fwd, fwd + 1
        else:
            direction = True
            if back < 0:
                exhausted_b = True
                continue
            j, back = back, back - 1
        if buf.try_new_keyframe(poses[j].copy(), None, index=j) == 1:
            added += 1
        if added >= config.test_keyframe_buffer_size * 2:
            break
    frames = buf.get_best_measurement_frames_for_0index(n_src)
    return [i] + [f[2] for f in frames]


def offline_tuples(poses, n_src: int, config=DVMVSConfig) -> list[list[int]]:
    buf = _test_buffer(config=config)
    samples = []
    for i, pose in enumerate(poses):
        if buf.try_new_keyframe(pose.copy(), None, index=i) != 1:
            continue
        s = offline_tuple_for_index(poses, n_src, i, config)
        if not (len(s) == 1 and i == 0):
            samples.append(s)
    return samples


def dense_tuples(poses, n_src: int, config=DVMVSConfig) -> list[list[int]]:
    """A backward-looking tuple for EVERY frame
    (generate_test_tuples.py:264-335)."""
    samples = []
    for i in range(len(poses)):
        buf = _test_buffer(cls=OfflineKeyframeBuffer, config=config)
        buf.try_new_keyframe(poses[i], None, index=i)
        j, added = i - 1, 0
        while j >= 0:
            if buf.try_new_keyframe(poses[j], None, index=j) == 1:
                added += 1
            if added >= config.test_keyframe_buffer_size:
                break
            j -= 1
        frames = buf.get_best_measurement_frames_for_0index(n_src)
        s = [i] + [f[2] for f in frames]
        if not (len(s) == 1 and i == 0):
            samples.append(s)
    return samples


def dense_offline_tuples(poses, n_src: int, config=DVMVSConfig) -> list[list[int]]:
    samples = []
    for i in range(len(poses)):
        s = offline_tuple_for_index(poses, n_src, i, config)
        if not (len(s) == 1 and i == 0):
            samples.append(s)
    return samples


def pad_tuple(indices: list[int], num_views: int, rng: random.Random) -> list[int]:
    """Pads short tuples with random recent unused frames, then repeats
    (generate_test_tuples.py:472-502)."""
    if len(indices) == num_views:
        return indices
    available = [f for f in range(indices[0]) if f not in indices]
    diff = min(num_views - len(indices), len(available))
    back = 30 if len(available) >= 30 else len(available)
    indices = indices + rng.sample(available[-back:], k=diff)
    if len(indices) != num_views:
        indices = indices + rng.choices(indices[1:], k=num_views - len(indices))
    return indices


def generate_test_tuples_for_scan(dataset, scan: str, tuple_type: str = "default",
                                  num_views: int = 8, seed: int = 0,
                                  config=DVMVSConfig) -> list[str]:
    """Glue: valid frames + poses -> tuple lines 'scan id0 id1 ...'."""
    valid = dataset.get_valid_frame_ids(scan)
    frame_ids = [l.strip().split(" ")[1] for l in valid]
    dists = [int(l.strip().split(" ")[2]) if len(l.strip().split(" ")) > 2 else None
             for l in valid]
    poses = [dataset.load_pose(scan.rstrip("\n"), fid)[0] for fid in frame_ids]
    n_src = num_views - 1

    if tuple_type == "default":
        samples = default_tuples(poses, dists, n_src, config)
    elif tuple_type == "offline":
        samples = offline_tuples(poses, n_src, config)
    elif tuple_type == "dense":
        samples = dense_tuples(poses, n_src, config)
    elif tuple_type == "dense_offline":
        samples = dense_offline_tuples(poses, n_src, config)
    else:
        raise ValueError(f"Unknown tuple type {tuple_type}")

    rng = random.Random(seed)
    lines = []
    for s in samples:
        s = pad_tuple(s, num_views, rng)
        lines.append(scan + " " + " ".join(frame_ids[i] for i in s))
    return lines


# ----------------------------------------------------------------------- #
# train tuples
# ----------------------------------------------------------------------- #

_CRAWL_PASSES = [
    (0, 1.0, False), (1, 0.666, True), (2, 1.5, False), (3, 0.8, True),
    (4, 1.25, False), (5, 1.0, True), (6, 0.666, False), (7, 1.5, True),
    (8, 0.8, False), (9, 1.25, True),
]


def train_tuples(poses, num_views: int, config=DVMVSConfig,
                 usage_threshold: int = 1) -> list[list[int]]:
    """Multi-pass crawl producing >=3-frame train tuples
    (generate_train_tuples.py:229-377): each pass sweeps the sequence at
    `train_crawl_step` strides with a scaled pose-distance window, chaining
    valid consecutive pairs while limiting frame reuse."""
    n = len(poses)
    used_pairs: set = set()
    used_nodes = {i: 0 for i in range(n)}
    step0 = config.train_crawl_step
    samples = []

    for offset, mult, backward in _CRAWL_PASSES:
        offset = offset % step0
        if backward:
            start, step, limit = n - 1 - offset, -step0, num_views
        else:
            start, step, limit = offset, step0, n - num_views + 1
        for i in range(start, limit, step):
            if used_nodes[i] > usage_threshold:
                continue
            indices = [i]
            prev = i
            valid_count, any_count = 1, 1
            hit_limit = False
            while valid_count < num_views:
                j = i - any_count if backward else i + any_count
                hit_limit = j < 0 if backward else j >= n
                if hit_limit:
                    break
                ok = (
                    used_nodes[j] <= usage_threshold
                    and (prev, j) not in used_pairs
                    and is_valid_pair(
                        poses[prev], poses[j],
                        mult * config.train_minimum_pose_distance,
                        mult * config.train_maximum_pose_distance,
                        t_norm_threshold=mult * config.train_minimum_pose_distance * 0.5,
                    )
                )
                if ok:
                    indices.append(j)
                    prev = j
                    valid_count += 1
                any_count += 1
            if not hit_limit and len(indices) == num_views:
                prev = indices[0]
                used_nodes[prev] += 1
                for cur in indices[1:]:
                    used_nodes[cur] += 1
                    used_pairs.add((prev, cur))
                    used_pairs.add((cur, prev))
                    prev = cur
                samples.append(indices)
    return samples


def train_pairs(poses, config=DVMVSConfig) -> list[list[int]]:
    """Two-frame tuples via the forward/backward pair gatherer with window
    loosening (generate_train_tuples.py:57-137)."""
    used_pairs: set = set()
    all_pairs = []
    for backward in (False, True):
        n = len(poses)
        pose_min = config.train_minimum_pose_distance
        pose_max = config.train_maximum_pose_distance
        used_meas: set = set()
        check_future = False
        loosening = 0
        i, step = (n - 1, -1) if backward else (0, 1)
        first_limit = 5 if backward else n - 5
        second_limit = n - 5 if backward else 5
        while 0 <= i < n:
            pair = (i, -1)
            rng_iter = (
                range(i + step, first_limit, step) if check_future
                else range(i - step, second_limit, -step)
            )
            for j in rng_iter:
                if j in used_meas or (i, j) in used_pairs:
                    continue
                if is_valid_pair(poses[i], poses[j], pose_min, pose_max):
                    pair = (i, j)
                    all_pairs.append([i, j])
                    used_pairs.add((i, j))
                    used_pairs.add((j, i))
                    used_meas.add(j)
                    pose_min = config.train_minimum_pose_distance
                    pose_max = config.train_maximum_pose_distance
                    i += step
                    check_future = False
                    loosening = 0
                    break
            if pair[1] == -1:
                if check_future:
                    pose_min /= 1.1
                    pose_max *= 1.1
                    check_future = False
                    loosening += 1
                    if loosening > 1:
                        i += step
                        loosening = 0
                else:
                    check_future = True
            else:
                check_future = False
    return all_pairs


def generate_train_tuples_for_scan(dataset, scan: str, num_views: int = 8,
                                   config=DVMVSConfig) -> list[str]:
    valid = dataset.get_valid_frame_ids(scan)
    frame_ids = [l.strip().split(" ")[1] for l in valid]
    poses = [dataset.load_pose(scan.rstrip("\n"), fid)[0] for fid in frame_ids]
    samples = (
        train_pairs(poses, config) if num_views == 2
        else train_tuples(poses, num_views, config)
    )
    return [scan + " " + " ".join(frame_ids[i] for i in s) for s in samples]
