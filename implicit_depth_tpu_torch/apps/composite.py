"""AR compositing (parity: inference/composite.py).

Copy of implicit_depth_tpu/apps/composite.py with only its imports changed
(the port imports nothing of the JAX package).

Three matting modes (inference/composite.py:27-41, 96-134):
  mask   — predicted occlusion mattes (matte = 1 - mask * valid_virtual)
  depth  — soft depth-band matte between predicted real depth and the
           virtual depth (0.2 m band, :19-24)
  lidar  — same band matte against sensor depth
plus a fade-in and mp4 export (cv2; the reference shells to ffmpeg).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from implicit_depth_tpu_torch.utils.visualization import write_video


def soft_depth_matte(real_depth: np.ndarray, virtual_depth: np.ndarray,
                     band: float = 0.2) -> np.ndarray:
    """Soft matte ~1 where the real surface is in front of the virtual one
    (inference/composite.py:19-24)."""
    diff = np.clip(virtual_depth - real_depth, 0.0, band) / band
    return np.where(virtual_depth > 0, diff, 0.0)


def composite_frame(
    image_hw3: np.ndarray,
    virtual_rgba_hw4: np.ndarray,
    mode: str = "mask",
    occlusion_matte: Optional[np.ndarray] = None,
    real_depth: Optional[np.ndarray] = None,
    virtual_depth: Optional[np.ndarray] = None,
    fade: float = 1.0,
) -> np.ndarray:
    """Alpha-blends a rendered virtual layer into the frame under the
    chosen occlusion model."""
    valid_virtual = virtual_rgba_hw4[..., 3]
    if mode == "mask":
        assert occlusion_matte is not None
        hide = occlusion_matte * (valid_virtual > 0)
    elif mode in ("depth", "lidar"):
        assert real_depth is not None and virtual_depth is not None
        hide = soft_depth_matte(real_depth, virtual_depth) * (valid_virtual > 0)
    else:
        raise ValueError(mode)

    alpha = valid_virtual * (1.0 - hide) * fade
    out = image_hw3 * (1.0 - alpha[..., None]) + virtual_rgba_hw4[..., :3] * alpha[..., None]
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def composite_sequence(
    images: list[np.ndarray],
    virtual_layers: list[np.ndarray],
    output_path: str,
    mode: str = "mask",
    mattes: Optional[list[np.ndarray]] = None,
    real_depths: Optional[list[np.ndarray]] = None,
    virtual_depths: Optional[list[np.ndarray]] = None,
    fade_in_frames: int = 10,
    fps: int = 30,
) -> None:
    frames = []
    for i, (img, virt) in enumerate(zip(images, virtual_layers)):
        fade = min(1.0, (i + 1) / max(fade_in_frames, 1))
        frames.append(composite_frame(
            img, virt, mode=mode,
            occlusion_matte=None if mattes is None else mattes[i],
            real_depth=None if real_depths is None else real_depths[i],
            virtual_depth=None if virtual_depths is None else virtual_depths[i],
            fade=fade,
        ))
    write_video(output_path, frames, fps=fps)


# Reference defaults (inference/composite.py:14-16, main():virtual_depth=2.0)
FADE_IN_FRAMES = 45
DEFAULT_VIRTUAL_DEPTH = 2.0
DEFAULT_VIRTUAL_RGB = (0.30, 0.9, 0.78)


def composite_capture(
    vdr_dir: str,
    output_dir: str,
    mode: str = "lidar",
    predicted_masks_dir: Optional[str] = None,
    predicted_depths_dir: Optional[str] = None,
    renders_dir: Optional[str] = None,
    virtual_depth: float = DEFAULT_VIRTUAL_DEPTH,
    fadein: bool = False,
    limit_frames: Optional[int] = None,
    fps: int = 30,
    save_frames: bool = True,
) -> str:
    """Composites an AR asset into a raw VDR capture end-to-end
    (inference/composite.py:42-159): iterates capture.json frames
    (skipping frame 0 — some methods make no prediction for it), builds
    the matte per mode, alpha-blends against the rendered virtual layer
    (or the reference's flat teal 2 m plane when `renders_dir` is None),
    writes per-frame images and an mp4. Returns the mp4 path.

    Modes: 'mask' loads sigma mattes from predicted_masks_dir
    (<frame-number>.npy, scripts/inference.py output naming), 'depth'
    loads predicted depth .npy from predicted_depths_dir, 'lidar' uses
    the capture's own sensor depth.
    """
    import cv2

    from implicit_depth_tpu_torch.apps.vdr_sequence import VDRSequence, pad_image_fname

    seq = VDRSequence(vdr_dir)
    os.makedirs(output_dir, exist_ok=True)
    frames_out = []

    for idx, frame in enumerate(seq.frames):
        if idx == 0:
            continue
        if limit_frames is not None and idx >= limit_frames:
            break
        w, h = frame["resolution"]
        image = seq.load_rgb_from_frame(frame).astype(np.float32) / 255.0
        padded = pad_image_fname(seq.image_name(frame))
        stem = os.path.splitext(padded)[0]

        virtual_rgba = vdepth = None
        if renders_dir is not None:
            virtual_rgba, vdepth = seq.load_virtual_layer(renders_dir, frame)
        if virtual_rgba is None:
            virtual_rgba = np.empty((h, w, 4), np.float32)
            virtual_rgba[..., :3] = DEFAULT_VIRTUAL_RGB
            virtual_rgba[..., 3] = 1.0
        if vdepth is None:
            vdepth = np.full((h, w), virtual_depth, np.float32)

        fade = min(1.0, idx / FADE_IN_FRAMES) if fadein else 1.0

        matte = rdepth = None
        if mode == "mask":
            number = stem[len("frame_"):]
            raw = np.load(os.path.join(predicted_masks_dir, number + ".npy"))
            matte = cv2.resize(np.asarray(raw, np.float32), (w, h),
                               interpolation=cv2.INTER_LINEAR)
        else:
            if mode == "lidar":
                rdepth = seq.load_lidar_from_frame(frame)
            else:
                number = stem[len("frame_"):]
                rdepth = np.asarray(
                    np.load(os.path.join(predicted_depths_dir, number + ".npy")),
                    np.float32)
            if rdepth.shape != (h, w):
                rdepth = cv2.resize(rdepth, (w, h), interpolation=cv2.INTER_LINEAR)

        out = composite_frame(image, virtual_rgba, mode=mode,
                              occlusion_matte=matte, real_depth=rdepth,
                              virtual_depth=vdepth, fade=fade)
        if save_frames:
            from PIL import Image

            Image.fromarray((out * 255).astype(np.uint8)).save(
                os.path.join(output_dir, stem + ".jpg"))
        frames_out.append(out)

    mp4_path = os.path.join(output_dir, "composited.mp4")
    write_video(mp4_path, frames_out, fps=fps)
    return mp4_path
