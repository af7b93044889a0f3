"""Synthetic batch fixtures for chip_smoke.py and the tests.

Copy of implicit_depth_tpu/utils/fixtures.py (the port imports nothing of
the JAX package)."""

from __future__ import annotations

import numpy as np


def make_K44(fx, fy, cx, cy):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def synthetic_bd_batch(
    batch: int = 1,
    num_src: int = 7,
    height: int = 384,
    width: int = 512,
    num_planes: int = 8,
    num_rays: int = 4096,
    samples_per_ray: int = 64,
    seed: int = 0,
    with_train_keys: bool = True,
):
    """Random but geometrically valid (cur_data, src_data) at the given
    shapes, NHWC, following the BDNet batch contract."""
    rng = np.random.RandomState(seed)
    hd, wd = height // 2, width // 2
    K_s1 = make_K44(width / 4 * 0.9, height / 4 * 0.9, width / 8, height / 8)
    K_s0 = make_K44(width / 2 * 0.9, height / 2 * 0.9, width / 4, height / 4)
    poses = []
    for i in range(num_src + 1):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.08 * i, 0.02 * i, 0.03 * i]
        poses.append(T)

    def rep(x):
        return np.ascontiguousarray(np.broadcast_to(x, (batch,) + x.shape))

    cur = {
        "image": rng.randn(batch, height, width, 3).astype(np.float32),
        "invK_s1": rep(np.linalg.inv(K_s1)),
        "K_s0": rep(K_s0),
        "invK_s0": rep(np.linalg.inv(K_s0)),
        "world_T_cam": rep(poses[0]),
        "cam_T_world": rep(np.linalg.inv(poses[0])),
        "rendered_depth": np.ascontiguousarray(
            np.broadcast_to(
                np.linspace(1.5, 5.0, num_planes, dtype=np.float32), (batch, hd, wd, num_planes)
            )
        ),
    }
    if with_train_keys:
        cur.update(
            {
                "gt_depth": rng.uniform(0.5, 4.0, (batch, hd, wd, 1)).astype(np.float32),
                "depth": rng.uniform(0.5, 4.0, (batch, hd, wd, 1)).astype(np.float32),
                "mask": np.ones((batch, hd, wd, 1), bool),
                "sampled_rays": np.stack(
                    [rng.uniform(0, wd, (batch, num_rays)), rng.uniform(0, hd, (batch, num_rays))],
                    -1,
                ).astype(np.float32),
                "sampled_depths": rng.uniform(
                    0.3, 5.0, (batch, num_rays, samples_per_ray)
                ).astype(np.float32),
            }
        )
    src = {
        "image": rng.randn(batch, num_src, height, width, 3).astype(np.float32),
        "K_s1": rep(np.stack([K_s1] * num_src)),
        "K_s0": rep(np.stack([K_s0] * num_src)),
        "world_T_cam": rep(np.stack(poses[1:])),
        "cam_T_world": rep(np.linalg.inv(np.stack(poses[1:]))),
        "depth": rng.uniform(0.5, 4.0, (batch, num_src, hd, wd, 1)).astype(np.float32),
    }
    return cur, src
