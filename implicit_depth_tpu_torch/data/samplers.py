"""Depth-noise augmentation (parity: tools/samplers.py).

Copy of implicit_depth_tpu/data/samplers.py with only its imports changed
(the port imports nothing of the JAX package).

add_noise_to_depth: multiplicative gaussian jitter plus random spatial
resampling of a fraction of pixels (tools/samplers.py:4-41). Host-side
numpy; unused in the main training path (as in the reference) but kept
for ablations.
"""

from __future__ import annotations

import numpy as np


def add_noise_to_depth(
    depth_hw: np.ndarray,
    rng: np.random.RandomState,
    noise_std: float = 0.005,
    resample_fraction: float = 0.01,
    max_shift: int = 4,
) -> np.ndarray:
    """Returns a noised copy: depth * N(1, std) with `resample_fraction` of
    pixels replaced by a random nearby pixel's depth."""
    h, w = depth_hw.shape
    out = depth_hw * (1.0 + rng.randn(h, w).astype(np.float32) * noise_std)
    n = int(h * w * resample_fraction)
    if n:
        ys = rng.randint(0, h, n)
        xs = rng.randint(0, w, n)
        sy = np.clip(ys + rng.randint(-max_shift, max_shift + 1, n), 0, h - 1)
        sx = np.clip(xs + rng.randint(-max_shift, max_shift + 1, n), 0, w - 1)
        out[ys, xs] = depth_hw[sy, sx]
    return out
