"""Temporal-evaluation driver, counterpart of
implicit_depth_tpu/eval/temporal_driver.py (`test_bd.py --temporal_eval`).

Per scene, at batch 1 and in frame order: every `eval_length` frames a new
occlusion plane is anchored at the current camera; each frame queries the
net with the plane's rendered depth, and a net with the prior gets the
previous frame's sigmoid map and camera (-1 everywhere at each re-anchor);
the GT mesh's visible vertices collect the binarised predictions, and each
window's flips are counted (eval/temporal.py).

Sequential tuples share most of their frames, so `_TupleStager` decodes
each frame once (host LRU), uploads each image once (device LRU) and
decodes the next tuple's frames on a background thread. Two loops:

- frame mode: one forward per frame; frame i-1's C++ vertex update runs on
  the host while the device computes frame i's forward.
- window mode (use_scan=True): a window's forwards are queued back to back
  with no host synchronisation between them, the prior fed back on the
  device. With device scoring (the default unless collect_preds) the host
  rasterizes the window's z-buffers meanwhile and eval/vertex_scorer.py
  counts the flips on the device; the count is read one window late. With
  host scoring the previous window's vertex updates overlap this window.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from implicit_depth_tpu_torch.data.keyframes import pose_distance_np
from implicit_depth_tpu_torch.eval.occlusion_eval import make_forward_fn
from implicit_depth_tpu_torch.eval.rasterizer import rasterize_mesh_depth, render_plane_depth
from implicit_depth_tpu_torch.eval.temporal import TemporalEvaluator
from implicit_depth_tpu_torch.eval.vertex_scorer import DeviceVertexScorer

Tensor = torch.Tensor


def _up(x, device: torch.device) -> Tensor:
    """A host array as an f32 tensor on `device`; the copy does not wait for
    the device's queued work."""
    return torch.as_tensor(np.ascontiguousarray(x, np.float32)).to(device, non_blocking=True)


class _TupleStager:
    """Decode-once, upload-once tuple assembly for sequential evaluation:
    a host LRU of the dataset's per-frame dicts, a device LRU of the frames'
    images (in `dtype`), and `prefetch`, which decodes and uploads tuples'
    frames on a background thread. `get` appends the host time it took to
    `waits` (ms)."""

    def __init__(self, dataset, device: torch.device, dtype: torch.dtype, waits: list,
                 capacity: int = 64):
        self.ds = dataset
        self.waits = waits
        self.device = device
        self.dtype = dtype
        self.capacity = capacity
        self._host: OrderedDict = OrderedDict()
        self._dev: OrderedDict = OrderedDict()
        self._thread: Optional[threading.Thread] = None

    def _tuple_ids(self, idx: int) -> tuple:
        scan_id, *frame_ids = self.ds.frame_tuples[idx].split(" ")
        if self.ds.num_images_in_tuple is not None:
            frame_ids = frame_ids[: self.ds.num_images_in_tuple]
        return scan_id, frame_ids

    @staticmethod
    def _touch(cache: OrderedDict, key, make, capacity: int):
        if key not in cache:
            cache[key] = make()
            while len(cache) > capacity:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
        return cache[key]

    def _host_frame(self, scan_id: str, fid) -> dict:
        return self._touch(self._host, (scan_id, fid),
                           lambda: self.ds.get_frame(scan_id, fid, flip=False, bd_info=False),
                           self.capacity)

    def _dev_image(self, scan_id: str, fid) -> Tensor:
        def upload():
            img = torch.from_numpy(self._host_frame(scan_id, fid)["image"]).to(self.dtype)
            return img.to(self.device, non_blocking=True)

        return self._touch(self._dev, (scan_id, fid), upload, self.capacity)

    def prefetch(self, indices) -> None:
        """Decodes and uploads the frames of the tuples `indices` (those in
        range) on one background thread."""
        items = [self._tuple_ids(i) for i in indices if 0 <= i < len(self.ds.frame_tuples)]
        if not items:
            return
        self.join()

        def work():
            for scan_id, ids in items:
                for fid in ids:
                    self._dev_image(scan_id, fid)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def get(self, idx: int) -> tuple:
        """(cur host dict, src host dicts, cur image, src images, cur GT depth
        (h, w)), the source views ordered by their pose distance to the
        current frame (as GenericMVSDataset.__getitem__); the images on the
        device."""
        t0 = time.perf_counter()
        self.join()
        scan_id, ids = self._tuple_ids(idx)
        frames = [self._host_frame(scan_id, fid) for fid in ids]
        cur_h, src_h = frames[0], frames[1:]
        pens = [pose_distance_np(np.eye(4), cur_h["cam_T_world"].astype(np.float64)
                                 @ s["world_T_cam"].astype(np.float64))[0] for s in src_h]
        order = np.argsort(pens)
        src_h = [src_h[i] for i in order]
        src_ids = [ids[1:][i] for i in order]
        out = (cur_h, src_h, self._dev_image(scan_id, ids[0]),
               tuple(self._dev_image(scan_id, fid) for fid in src_ids), cur_h["depth"][..., 0])
        self.waits.append((time.perf_counter() - t0) * 1e3)
        return out


class _Timer:
    """Elapsed time of a span of device work in ms: CUDA events on a CUDA
    device (read after a later synchronisation), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: list = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, begin) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans.append((begin, end))
        else:
            self.spans.append((time.perf_counter() - begin) * 1e3)

    def median_ms(self) -> float:
        if not self.spans:
            return 0.0
        if self.cuda:
            torch.cuda.synchronize()
            return float(np.median([b.elapsed_time(e) for b, e in self.spans]))
        return float(np.median(self.spans))


class _LateScalar:
    """A device scalar read later without waiting for work queued after it:
    on a CUDA device it is copied into pinned host memory behind an event."""

    def __init__(self, x: Tensor):
        if x.device.type == "cuda":
            self.host = torch.empty((), dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = x, None

    def value(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.host)


def evaluate_temporal(
    net,
    datasets_by_scene: dict,
    mesh_paths_by_scene: dict,
    eval_length: int = 15,
    warmup: int = 2,
    frame_multiplier: int = 8,
    sigmoid_multiplier: float = 1.0,
    height: int = 192,
    width: int = 256,
    max_frames_per_scene: Optional[int] = None,
    regression: bool = False,
    use_scan: bool = False,
    collect_preds: bool = False,
    device_scoring: Optional[bool] = None,
) -> dict:
    """Temporal score of `net` (on its device, in eval mode) over the scenes.

    With regression=True the net is a DepthNet and the occlusion map is
    (rendered depth < predicted depth). use_scan=True runs the window loop;
    device_scoring (window loop only, default `not collect_preds`) counts
    the flips on the device. Returns {"temporal_score", "total_diffs",
    "total_verts", "frames_per_sec" (1 / the median frame time),
    "n_frames", "frame_times" (s, per frame; a window's frames share its
    time), "forward_ms" (median of one frame's forward between CUDA events:
    its device time, or the host's dispatch where that is slower),
    "raster_ms" (median host time per frame of the C++ vertex update or
    z-buffer), "stage_ms" (median host time per frame waiting for the
    stager: decode and upload not hidden behind other work), and with
    collect_preds "preds": the (h, w) maps in frame order}."""
    device = next(net.parameters()).device
    dtype = getattr(net, "compute_dtype", torch.float32)
    use_prior = getattr(net, "use_prior", False) and not regression
    ms = net.matching_scale
    cur_keys = tuple(dict.fromkeys(("world_T_cam", "cam_T_world", "K_s0", "invK_s0",
                                    f"invK_s{ms}")))
    src_keys = ("world_T_cam", "cam_T_world", f"K_s{ms}")
    ev = TemporalEvaluator(height=height, width=width)
    fwd_timer = _Timer(device)
    raster_ms: list = []
    stage_ms: list = []
    frame_times: list = []
    collected: list = []
    no_prior = torch.full((1, height, width, 1), -1.0, device=device)
    bd_fwd = make_forward_fn(net, sigmoid_multiplier=sigmoid_multiplier)

    def plane(depth_hw, world_T_cam) -> tuple:
        """The window's plane: anchor pose and distance on the device."""
        dist = np.float32(np.nanquantile(depth_hw, 0.75))
        return _up(world_T_cam, device), _up(dist, device)

    def predict(frame, plane_td, prior_pred, prior_cam) -> Tensor:
        """One frame's (1, h, w, 1) f32 occlusion map, queued on the device."""
        cur_h, src_h, cur_img, src_imgs, _ = frame
        cur = {k: _up(cur_h[k], device)[None] for k in cur_keys}
        src = {k: _up(np.stack([s[k] for s in src_h]), device)[None] for k in src_keys}
        cur["image"] = cur_img[None]
        src["image"] = torch.stack(src_imgs)[None]
        rendered = render_plane_depth(plane_td[0], plane_td[1], cur["cam_T_world"][0],
                                      cur["K_s0"][0], height, width)
        cur["rendered_depth"] = rendered[None, ..., None]
        t0 = fwd_timer.start()
        if regression:
            out = net(cur, src)
            pred = (cur["rendered_depth"] < out["depth_pred_0"]).float()
        else:
            if use_prior:
                cur["prior_prediction"] = prior_pred
                cur["prior_cam_T_world"] = prior_cam[None]
            pred = bd_fwd(cur, src)
        fwd_timer.stop(t0)
        return pred

    def vertex_update(pred_hw, cam_T_world, K):
        t0 = time.perf_counter()
        ev.update_vertex_predictions(pred_hw, cam_T_world, K)
        raster_ms.append((time.perf_counter() - t0) * 1e3)

    if use_scan and device_scoring is None:
        device_scoring = not collect_preds

    with torch.inference_mode():
        for scene_id, ds in datasets_by_scene.items():
            ev.initialise_new_scene(gt_mesh_path=mesh_paths_by_scene[scene_id])
            stager = _TupleStager(ds, device, dtype, stage_ms)
            n = len(ds) if max_frames_per_scene is None else min(len(ds), max_frames_per_scene)
            stager.prefetch((0,))
            if not use_scan:
                _frame_loop(ev, stager, n, eval_length, plane, predict, vertex_update,
                            no_prior, device, frame_times, collected, collect_preds)
                continue
            scorer = (DeviceVertexScorer(ev.verts, height, width, device)
                      if device_scoring else None)
            _window_loop(ev, stager, n, eval_length, plane, predict, vertex_update, no_prior,
                         device, scorer, raster_ms, frame_times, collected, collect_preds)

    score = ev.temporal_score(len(datasets_by_scene), eval_length, warmup, frame_multiplier)
    med = float(np.median(frame_times)) if frame_times else 0.0
    return {"temporal_score": score, "total_diffs": ev.total_diffs,
            "total_verts": ev.total_verts, "frames_per_sec": (1.0 / med) if med else 0.0,
            "n_frames": len(frame_times), "frame_times": frame_times,
            "forward_ms": fwd_timer.median_ms(),
            "raster_ms": float(np.median(raster_ms)) if raster_ms else 0.0,
            "stage_ms": float(np.median(stage_ms)) if stage_ms else 0.0,
            **({"preds": collected} if collect_preds else {})}


def _frame_loop(ev, stager, n, eval_length, plane, predict, vertex_update, no_prior, device,
                frame_times, collected, collect_preds) -> None:
    """One forward per frame; frame i-1's vertex update overlaps frame i's
    forward."""
    pending = None  # frame i-1's (pred, cam_T_world, K_s0)
    for i in range(n):
        t_frame = time.perf_counter()
        frame = stager.get(i)
        cur_h, depth_host = frame[0], frame[4]
        if i % eval_length == 0:
            if pending is not None:
                vertex_update(*pending)
                pending = None
            if i > 0:
                ev.compute_vertex_occlusion_changes()
            ev.initialise_new_plane(depth_host, cur_h["world_T_cam"])
            plane_td = plane(depth_host, cur_h["world_T_cam"])
            prior_pred, prior_cam = no_prior, _up(cur_h["cam_T_world"], device)
        pred = predict(frame, plane_td, prior_pred, prior_cam)
        stager.prefetch((i + 1,))
        if pending is not None:
            vertex_update(*pending)
        pred_np = pred[0, ..., 0].cpu().numpy()  # waits for the forward
        if collect_preds:
            collected.append(pred_np)
        pending = (pred_np, cur_h["cam_T_world"], cur_h["K_s0"])
        prior_pred, prior_cam = pred, _up(cur_h["cam_T_world"], device)
        frame_times.append(time.perf_counter() - t_frame)
    if pending is not None:
        vertex_update(*pending)
    ev.compute_vertex_occlusion_changes()


def _window_loop(ev, stager, n, eval_length, plane, predict, vertex_update, no_prior, device,
                 scorer, raster_ms, frame_times, collected, collect_preds) -> None:
    """A window's forwards queued back to back; the flips counted on the
    device (scorer) or from the previous window's maps on the host."""
    pending = None        # host scoring: the previous window's maps and cameras
    pending_flips = None  # device scoring: the previous window's count
    i = 0
    while i < n:
        t_win = time.perf_counter()
        l_w = min(eval_length, n - i)
        frames = []
        for j in range(i, i + l_w):
            frames.append(stager.get(j))
            if scorer is None:
                stager.prefetch((j + 1,))
        cur_h0, depth0 = frames[0][0], frames[0][4]
        plane_td = plane(depth0, cur_h0["world_T_cam"])
        prior_pred, prior_cam = no_prior, _up(cur_h0["cam_T_world"], device)
        preds = []
        for frame in frames:
            pred = predict(frame, plane_td, prior_pred, prior_cam)
            preds.append(pred[0, ..., 0])
            prior_pred, prior_cam = pred, _up(frame[0]["cam_T_world"], device)
        cams = [f[0]["cam_T_world"] for f in frames]
        Ks = [f[0]["K_s0"] for f in frames]
        if scorer is not None:
            stager.prefetch(range(i + l_w, i + 2 * l_w))
            t0 = time.perf_counter()
            zbufs = np.stack([rasterize_mesh_depth(ev.verts, ev.faces, T, K, ev.height, ev.width)
                              for T, K in zip(cams, Ks)])
            raster_ms.extend([(time.perf_counter() - t0) * 1e3 / l_w] * l_w)
            flips = (scorer.window_flips(torch.stack(preds), zbufs, np.stack(cams),
                                         np.stack(Ks)) if l_w >= 2 else None)
            if pending_flips is not None:
                ev.total_diffs += pending_flips.value()
            pending_flips = None if flips is None else _LateScalar(flips)
            if l_w >= 2:
                ev.total_verts += scorer.n_verts
            if collect_preds:
                collected.extend(p.cpu().numpy() for p in preds)
        else:
            if pending is not None:
                _apply_window(ev, vertex_update, *pending)
            preds_np = torch.stack(preds).cpu().numpy()  # waits for the window
            if collect_preds:
                collected.extend(preds_np)
            pending = (preds_np, cams, Ks, depth0, cur_h0["world_T_cam"])
        frame_times.extend([(time.perf_counter() - t_win) / l_w] * l_w)
        i += l_w
    if pending is not None:
        _apply_window(ev, vertex_update, *pending)
    if pending_flips is not None:
        ev.total_diffs += pending_flips.value()


def _apply_window(ev, vertex_update, preds_np, cams, Ks, depth0, world_T_cam0) -> None:
    ev.initialise_new_plane(depth0, world_T_cam0)
    for pred_hw, T, K in zip(preds_np, cams, Ks):
        vertex_update(pred_hw, T, K)
    ev.compute_vertex_occlusion_changes()
