"""The benchmark's traffic: seeded host tuples in the port's batch layout.

A copy of implicit_depth_tpu_torch/utils/fixtures.py::synthetic_bd_batch
(random but geometrically valid (cur, src) tuples, NHWC numpy), frozen here
so that no change to the program moves the inputs. Three departures: the
draws come from numpy's PCG64 generator (`np.random.default_rng`); images
are uniform rather than normal, because set-up pays for every value drawn
and uniform float32 draws cost a tenth of normal ones; and each tuple is a
scene of its own, as in a real batch, where the fixture's tuples differ
only in noise: the mix's `scene_scale` range (log-uniform) scales a
tuple's depths and camera baselines, its `contrast` range (uniform) its
images, and its `brightness` range (uniform) shifts them, as exposure
differs from scene to scene. The query samples keep the fixture's fixed range, as a
sampler with fixed near and far planes draws them. Every seed gives the
same sizes; only the values differ.
"""

from __future__ import annotations

import numpy as np


def make_K44(fx, fy, cx, cy):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def _uniform(rng, lo, hi, shape):
    return (rng.random(shape, dtype=np.float32) * np.float32(hi - lo) + np.float32(lo))


def tuple_batch(rng: np.random.Generator, batch: int, num_src: int, height: int, width: int,
                num_planes: int, num_rays: int, samples_per_ray: int, train_keys: bool,
                scene_scale=(1.0, 1.0), contrast=(1.0, 1.0), brightness=(0.0, 0.0)):
    """(cur, src) numpy dicts for `batch` tuples of one current and
    `num_src` source views. Eval tuples hold the images, poses,
    intrinsics and `num_planes` rendered query depths; `train_keys` adds
    the ground truth (depth, mask) and the rays and samples of the BD
    query head. Each tuple draws its scene scale, its image contrast and
    its brightness from the given ranges."""
    hd, wd = height // 2, width // 2
    K_s1 = make_K44(width / 4 * 0.9, height / 4 * 0.9, width / 8, height / 8)
    K_s0 = make_K44(width / 2 * 0.9, height / 2 * 0.9, width / 4, height / 4)
    scale = np.exp(rng.uniform(*np.log(scene_scale), batch)).astype(np.float32)
    contrast = rng.uniform(*contrast, batch).astype(np.float32)
    brightness = rng.uniform(*brightness, batch).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (batch, num_src + 1, 1, 1))
    steps = np.arange(num_src + 1, dtype=np.float32)[:, None] * np.float32([0.08, 0.02, 0.03])
    poses[:, :, :3, 3] = scale[:, None, None] * steps

    def rep(x):
        return np.array(np.broadcast_to(x, (batch,) + x.shape))

    def per_tuple(x, factor, offset=None):  # x (batch, ...) scaled (and shifted) per tuple
        shape = (batch,) + (1,) * (x.ndim - 1)
        x = x * factor.reshape(shape)
        return x if offset is None else x + offset.reshape(shape)

    cur = {
        "image": per_tuple(_uniform(rng, -1.5, 1.5, (batch, height, width, 3)), contrast,
                           brightness),
        "invK_s1": rep(np.linalg.inv(K_s1)),
        "K_s0": rep(K_s0),
        "invK_s0": rep(np.linalg.inv(K_s0)),
        "world_T_cam": np.ascontiguousarray(poses[:, 0]),
        "cam_T_world": np.linalg.inv(poses[:, 0]),
        "rendered_depth": per_tuple(np.array(np.broadcast_to(
            np.linspace(1.5, 5.0, num_planes, dtype=np.float32), (batch, hd, wd, num_planes))),
            scale),
    }
    if train_keys:
        cur.update({
            "gt_depth": per_tuple(_uniform(rng, 0.5, 4.0, (batch, hd, wd, 1)), scale),
            "depth": per_tuple(_uniform(rng, 0.5, 4.0, (batch, hd, wd, 1)), scale),
            "mask": np.ones((batch, hd, wd, 1), bool),
            "sampled_rays": np.stack([_uniform(rng, 0, wd, (batch, num_rays)),
                                      _uniform(rng, 0, hd, (batch, num_rays))], -1),
            "sampled_depths": _uniform(rng, 0.3, 5.0, (batch, num_rays, samples_per_ray)),
        })
    src = {
        "image": per_tuple(_uniform(rng, -1.5, 1.5, (batch, num_src, height, width, 3)),
                           contrast, brightness),
        "K_s1": rep(np.stack([K_s1] * num_src)),
        "K_s0": rep(np.stack([K_s0] * num_src)),
        "world_T_cam": np.ascontiguousarray(poses[:, 1:]),
        "cam_T_world": np.linalg.inv(poses[:, 1:]),
        "depth": per_tuple(_uniform(rng, 0.5, 4.0, (batch, num_src, hd, wd, 1)), scale),
    }
    return cur, src


def make_ring(seed: int, mix: dict, config: dict) -> list:
    """The mix's `ring` host tuples (batches of mix["batch"]) from the seed.
    Sizes come from the configuration and the mix, never from the seed."""
    rng = np.random.default_rng(seed)
    return [tuple_batch(rng, mix["batch"], config["model_num_views"] - 1,
                        config["image_height"], config["image_width"],
                        mix.get("query_planes", 1), config.get("num_rays", 1),
                        config.get("samples_per_ray", 1), mix["train_keys"],
                        mix.get("scene_scale", (1.0, 1.0)), mix.get("contrast", (1.0, 1.0)),
                        mix.get("brightness", (0.0, 0.0)))
            for _ in range(mix["ring"])]


def step_flips(seed: int, n: int) -> np.ndarray:
    """The flip augmentation of the first n steps, Bernoulli(0.5) from the
    seed (a stream of its own, apart from the tuples')."""
    return np.random.default_rng([seed, 1]).random(n) < 0.5
