"""The port's copies of the capture loaders (data/{vdr,hypersim,seven_scenes,
colmap,arkit,scanniverse}.py), of tuple generation (data/tuples.py with the
keyframe buffers of data/keyframes.py), of the depth-noise sampler
(data/samplers.py) and of the numpy geometry helpers (core/geometry.py's
rotx, roty, rotz, qvec2rotmat) against their JAX package originals: for
the same files and seeds both give bit-equal arrays. Each loader runs on a
tiny on-disk capture written here from what it opens. Also: `build_net`
builds the three Hypersim model configs with the JAX package's parameters,
name for name and shape for shape.
"""

import json
import os

import numpy as np
import pytest

from implicit_depth_tpu import config as jconfig
from implicit_depth_tpu.core import geometry as jgeometry
from implicit_depth_tpu.data import arkit as jarkit
from implicit_depth_tpu.data import colmap as jcolmap
from implicit_depth_tpu.data import hypersim as jhypersim
from implicit_depth_tpu.data import mvs_dataset as jmvs
from implicit_depth_tpu.data import samplers as jsamplers
from implicit_depth_tpu.data import scanniverse as jscanniverse
from implicit_depth_tpu.data import seven_scenes as jseven_scenes
from implicit_depth_tpu.data import tuples as jtuples
from implicit_depth_tpu.data import vdr as jvdr
from implicit_depth_tpu_torch.core import geometry
from implicit_depth_tpu_torch.data import (arkit, colmap, hypersim, mvs_dataset, samplers,
                                           scanniverse, seven_scenes, tuples, vdr)
from tests.test_torch_data_copies import _assert_tree_equal

IMAGE_W, IMAGE_H = 80, 60  # the captures' native frames; the loaders resize to 96x64


def _pose(i: int) -> np.ndarray:
    """A camera walking along x and turning slowly about y."""
    T = np.eye(4)
    T[:3, :3] = jgeometry.roty(0.05 * i) @ jgeometry.rotx(0.02 * i)
    T[:3, 3] = [0.12 * i, 0.01 * i, -0.03 * i]
    return T


def _rgb(rng) -> np.ndarray:
    return rng.randint(0, 255, (IMAGE_H, IMAGE_W, 3)).astype(np.uint8)


def _save(path, array) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(array).save(path)


def _tuples(root, scan: str, ids: list) -> str:
    """Tuple files for the train and test splits: each frame with the two
    frames after it (wrapping round)."""
    d = os.path.join(root, "tuples")
    os.makedirs(d, exist_ok=True)
    lines = [f"{scan} " + " ".join(str(ids[(i + j) % len(ids)]) for j in range(3))
             for i in range(len(ids))]
    for split in ("train", "test"):
        with open(os.path.join(d, f"{split}_tuples.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return d


def _vdr(root):
    """capture.json + RGB jpgs + LiDAR depth and confidence bins (the
    layout of tests/test_vdr_sequence.py), some confidences 0."""
    rng = np.random.RandomState(0)
    scan, dw, dh = "capture0", 32, 24
    d = os.path.join(root, scan)
    frames = []
    for i in range(4):
        _save(os.path.join(d, f"frame_{i}.jpg"), _rgb(rng))
        rng.uniform(0.5, 4.0, (dh, dw)).astype(np.float32).tofile(os.path.join(d, f"depth_{i}.bin"))
        (rng.rand(dh, dw) > 0.1).astype(np.uint8).tofile(os.path.join(d, f"depthConfidence_{i}.bin"))
        frames.append({"image": f"frame_{i}.jpg", "depth": f"depth_{i}.bin",
                       "pose4x4": _pose(i).T.ravel().tolist(),
                       "intrinsics": [70.0, 71.0, IMAGE_W / 2, IMAGE_H / 2, 0.0],
                       "resolution": [IMAGE_W, IMAGE_H], "depthResolution": [dw, dh]})
    with open(os.path.join(d, "capture.json"), "w") as f:
        json.dump({"frames": frames}, f)
    return dict(native_depth_width=dw, native_depth_height=dh), scan, list(range(4))


def _hypersim(root):
    """The layout of tests/test_hypersim.py's fixture: camera and scene
    metadata csvs, keyframe position and orientation HDF5s, tonemapped jpgs
    and distance HDF5s (with a ray matrix, so depth is made planar)."""
    import h5py
    import pandas as pd

    rng = np.random.RandomState(1)
    scene, cam = "ai_001_001", "cam_00"
    detail = os.path.join(root, scene, "_detail")
    camdir = os.path.join(detail, cam)
    geo = os.path.join(root, scene, "images", f"scene_{cam}_geometry_hdf5")
    os.makedirs(camdir)
    os.makedirs(geo)
    mproj = np.diag([1.2, 1.6, -1.0, 1.0])
    cols = {"scene_name": scene, "settings_output_img_width": IMAGE_W,
            "settings_output_img_height": IMAGE_H}
    for i in range(4):
        for j in range(4):
            cols[f"M_proj_{i}{j}"] = mproj[i, j]
    m_uv = np.array([[1.0, 0.0, -0.5], [0.0, 0.75, -0.375], [0.0, 0.0, -1.0]])
    for i in range(3):
        for j in range(3):
            cols[f"M_cam_from_uv_{i}{j}"] = m_uv[i, j]
    pd.DataFrame([cols]).to_csv(os.path.join(root, "metadata_camera_parameters.csv"), index=False)
    pd.DataFrame({"parameter_name": ["meters_per_asset_unit"],
                  "parameter_value": [0.5]}).to_csv(os.path.join(detail, "metadata_scene.csv"),
                                                    index=False)
    n = 5
    with h5py.File(os.path.join(camdir, "camera_keyframe_positions.hdf5"), "w") as f:
        f.create_dataset("dataset", data=np.stack([_pose(i)[:3, 3] for i in range(n)]))
    with h5py.File(os.path.join(camdir, "camera_keyframe_orientations.hdf5"), "w") as f:
        f.create_dataset("dataset", data=np.stack([_pose(i)[:3, :3] for i in range(n)]))
    for fid in range(n):
        _save(os.path.join(root, scene, "images", f"scene_{cam}_final_preview",
                           f"frame.{fid:04d}.tonemap.jpg"), _rgb(rng))
        with h5py.File(os.path.join(geo, f"frame.{fid:04d}.depth_meters.hdf5"), "w") as f:
            f.create_dataset("dataset", data=rng.uniform(1.0, 4.0, (IMAGE_H, IMAGE_W))
                             .astype(np.float32))
    for sub, name in (("bd_split", "train_files_bd.json"),
                      ("standard_split", "test_files_all.json")):
        os.makedirs(os.path.join(root, "splits", sub))
        with open(os.path.join(root, "splits", sub, name), "w") as f:
            json.dump({f"{scene}/{cam}": list(range(n))}, f)
    return (dict(split_json_dir=os.path.join(root, "splits"), use_min_max_depth=True),
            f"{scene}/{cam}", list(range(n)))


def _seven_scenes(root):
    """frame-XXXXXX.{color.png, depth.proj.png (uint16 mm, some 0 and some
    beyond the valid range), pose.txt}."""
    rng = np.random.RandomState(2)
    scan = "chess/seq-01"
    d = os.path.join(root, scan)
    os.makedirs(d)
    ids = [f"{i:06d}" for i in range(4)]
    for i, fid in enumerate(ids):
        _save(os.path.join(d, f"frame-{fid}.color.png"), _rgb(rng))
        depth = rng.randint(0, 12000, (IMAGE_H, IMAGE_W)).astype(np.uint16)
        _save(os.path.join(d, f"frame-{fid}.depth.proj.png"), depth)
        np.savetxt(os.path.join(d, f"frame-{fid}.pose.txt"), _pose(i))
    return {}, scan, ids


def _colmap(root):
    """sparse/cameras.txt, sparse/images.txt (a pose line and a points line
    per image) and images/<name>."""
    rng = np.random.RandomState(3)
    scan = "room"
    d = os.path.join(root, scan)
    os.makedirs(os.path.join(d, "sparse"))
    with open(os.path.join(d, "sparse", "cameras.txt"), "w") as f:
        f.write(f"# camera list\n1 SIMPLE_RADIAL {IMAGE_W} {IMAGE_H} 65.0 40.0 30.0 0.01\n")
    names = [f"img_{i}.jpg" for i in range(4)]
    with open(os.path.join(d, "sparse", "images.txt"), "w") as f:
        f.write("# image list\n")
        for i, name in enumerate(names):
            q = rng.randn(4)
            q /= np.linalg.norm(q)
            t = rng.randn(3) * 0.3
            f.write(f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, t))} 1 {name}\n")
            f.write("10.0 12.0 -1 20.5 30.5 -1\n")
            _save(os.path.join(d, "images", name), _rgb(rng))
    return {}, scan, names


def _arkit(root, n: int = 4, scan: str = "scene_a", images: bool = True):
    """poses/<id>.txt (CV world_T_cam), intrinsics/<id>.txt (3x3) and
    images/<id>.jpg."""
    rng = np.random.RandomState(4)
    d = os.path.join(root, scan)
    for sub in ("poses", "intrinsics"):
        os.makedirs(os.path.join(d, sub))
    for i in range(n):
        np.savetxt(os.path.join(d, "poses", f"{i}.txt"), _pose(i))
        np.savetxt(os.path.join(d, "intrinsics", f"{i}.txt"),
                   [[500.0 + i, 0.0, 320.0], [0.0, 501.0, 240.0], [0.0, 0.0, 1.0]])
        if images:
            _save(os.path.join(d, "images", f"{i}.jpg"), _rgb(rng))
    return {}, scan, [str(i) for i in range(n)]


def _scanniverse(root):
    """frames.txt of `frames { ... }` records (id, quadR x4, T x3, fx, fy,
    cx, cy, width, height) and images/frame_XXXXX.jpg."""
    rng = np.random.RandomState(5)
    scan = "scan_s"
    d = os.path.join(root, scan)
    records = []
    for i in range(4):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        t = _pose(i)[:3, 3]
        records.append("frames {\n  id: %d\n" % i
                       + "".join(f"  quadR: {float(v)!r}\n" for v in q)
                       + "".join(f"  T: {float(v)!r}\n" for v in t)
                       + f"  fx: 66.5\n  fy: 67.0\n  cx: 40.5\n  cy: 29.5\n"
                       + f"  width: {IMAGE_W}\n  height: {IMAGE_H}\n}}")
        _save(os.path.join(d, "images", f"frame_{i:05d}.jpg"), _rgb(rng))
    with open(os.path.join(d, "frames.txt"), "w") as f:
        f.write("\n".join(records) + "\n")
    return {}, scan, list(range(4))


LOADERS = {
    "vdr": (_vdr, jvdr.VDRDataset, vdr.VDRDataset),
    "hypersim": (_hypersim, jhypersim.HypersimDataset, hypersim.HypersimDataset),
    "7scenes": (_seven_scenes, jseven_scenes.SevenScenesDataset, seven_scenes.SevenScenesDataset),
    "colmap": (_colmap, jcolmap.ColmapDataset, colmap.ColmapDataset),
    "arkit": (_arkit, jarkit.ARKitDataset, arkit.ARKitDataset),
    "scanniverse": (_scanniverse, jscanniverse.ScanniverseDataset,
                    scanniverse.ScanniverseDataset),
}
# VDR refuses flip, which the train split draws
CASES = [(name, "test") for name in LOADERS] + [(name, "train") for name in LOADERS
                                                  if name != "vdr"]


@pytest.mark.parametrize("name,split", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_loader_items_bit_equal(tmp_path, name, split):
    """Every item (images, depths, masks, poses, intrinsics, the BD keys:
    rendered planes in test, sampled rays and depths in train, frame ids)
    and the valid frame ids of both copies are bit-equal."""
    make, jcls, cls = LOADERS[name]
    extra, scan, ids = make(str(tmp_path / "data"))
    kw = dict(dataset_path=str(tmp_path / "data"), split=split,
              mv_tuple_file_suffix="_tuples.txt",
              tuple_info_file_location=_tuples(str(tmp_path), scan, ids),
              image_height=64, image_width=96, num_images_in_tuple=3, get_bd_info=True,
              pass_frame_id=True, include_full_res_depth=True, **extra)
    jds = jcls(bd_config=jmvs.BDSamplingConfig(num_rays=64, samples_per_ray=8), **kw)
    ds = cls(bd_config=mvs_dataset.BDSamplingConfig(num_rays=64, samples_per_ray=8), **kw)
    assert len(jds) == len(ds) == len(ids)
    for i in range(len(ds)):
        _assert_tree_equal(jds[i], ds[i])
    _assert_tree_equal(jds.get_valid_frame_ids(scan, store_computed=False),
                       ds.get_valid_frame_ids(scan, store_computed=False))
    cur, src = ds[0]
    assert cur["image"].shape == (64, 96, 3) and src["image"].shape == (2, 64, 96, 3)
    assert cur["frame_id_string"] == str(ids[0])


def test_hypersim_filters_and_converts_as_the_original(tmp_path):
    """The valid-frame filter (an anomalous render, a non-finite pose), the
    planar depth from ray distances and the GL -> CV pose of both copies."""
    import h5py

    extra, scan, _ = _hypersim(str(tmp_path))
    root = str(tmp_path)
    preview = os.path.join(root, "ai_001_001", "images", "scene_cam_00_final_preview")
    _save(os.path.join(preview, "frame.0001.tonemap.jpg"), np.zeros((IMAGE_H, IMAGE_W, 3),
                                                                     np.uint8))
    with h5py.File(os.path.join(root, "ai_001_001", "_detail", "cam_00",
                                "camera_keyframe_positions.hdf5"), "r+") as f:
        f["dataset"][3] = np.inf
    kw = dict(dataset_path=root, split="train", image_height=64, image_width=96, **extra)
    jds, ds = jhypersim.HypersimDataset(**kw), hypersim.HypersimDataset(**kw)
    frames = ds.get_valid_frame_ids(scan, store_computed=False)
    assert frames == jds.get_valid_frame_ids(scan, store_computed=False)
    assert [f.split(" ")[1] for f in frames] == ["0", "2", "4"]
    for fid in (0, 2):
        _assert_tree_equal(jds._depth_h5(scan, fid), ds._depth_h5(scan, fid))
        _assert_tree_equal(jds.load_pose(scan, fid), ds.load_pose(scan, fid))
    rng = np.random.RandomState(6)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    pose[:3, 3] = rng.randn(3)
    _assert_tree_equal(jhypersim.gl_pose_to_cv(pose), hypersim.gl_pose_to_cv(pose))
    img = _rgb(rng)
    img[:30] = 7
    for x in (img, rng.rand(20, 30).astype(np.float32)):
        assert jhypersim.image_is_anomalous(x) == hypersim.image_is_anomalous(x)


TUPLE_CASES = [("test", t, 4) for t in ("default", "offline", "dense", "dense_offline")] + [
    ("train", None, 2), ("train", None, 4)]


@pytest.mark.parametrize("kind,tuple_type,num_views", TUPLE_CASES,
                         ids=[f"{k}-{t or v}" for k, t, v in TUPLE_CASES])
def test_tuples_for_scan_bit_equal(tmp_path, kind, tuple_type, num_views):
    """generate_{test,train}_tuples_for_scan of both copies (and with them
    the keyframe buffers, the padding rng and the train crawls) give the
    same lines over a 40-frame walk."""
    _, scan, _ = _arkit(str(tmp_path), n=40, scan="walk", images=False)
    ds = arkit.ARKitDataset(dataset_path=str(tmp_path), split="test")
    if kind == "test":
        got = tuples.generate_test_tuples_for_scan(ds, scan, tuple_type, num_views, seed=3)
        ref = jtuples.generate_test_tuples_for_scan(ds, scan, tuple_type, num_views, seed=3)
    else:
        got = tuples.generate_train_tuples_for_scan(ds, scan, num_views)
        ref = jtuples.generate_train_tuples_for_scan(ds, scan, num_views)
    assert got == ref and len(got) > 3
    assert all(len(line.split(" ")) == num_views + 1 for line in got)


@pytest.mark.parametrize("kw", [{}, dict(noise_std=0.02, resample_fraction=0.1, max_shift=2)],
                         ids=["default", "heavy"])
def test_depth_noise_sampler_bit_equal(kw):
    depth = np.random.RandomState(7).uniform(0.5, 5.0, (48, 64)).astype(np.float32)
    got = samplers.add_noise_to_depth(depth, np.random.RandomState(8), **kw)
    ref = jsamplers.add_noise_to_depth(depth, np.random.RandomState(8), **kw)
    _assert_tree_equal(got, ref)
    assert not np.array_equal(got, depth)


def test_rotation_helpers_bit_equal():
    rng = np.random.RandomState(9)
    for t in [0.0, np.pi / 2, -np.pi / 2, np.pi, *rng.uniform(-4, 4, 5)]:
        for fn in ("rotx", "roty", "rotz"):
            _assert_tree_equal(getattr(jgeometry, fn)(t), getattr(geometry, fn)(t))
    for q in rng.randn(6, 4):
        _assert_tree_equal(jgeometry.qvec2rotmat(q), geometry.qvec2rotmat(q))
        q = q / np.linalg.norm(q)
        R = geometry.qvec2rotmat(q)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


HYPERSIM_MODELS = [("implicit_depth_hypersim.yaml", "bd"),
                   ("implicit_depth_temporal_hypersim.yaml", "bd"),
                   ("regression_model_hypersim.yaml", "regression")]


@pytest.mark.parametrize("model,kind", HYPERSIM_MODELS, ids=[m for m, _ in HYPERSIM_MODELS])
def test_build_net_builds_the_hypersim_configs(model, kind):
    """The port's build_net on each Hypersim model config (with the Hypersim
    data config) takes the JAX package's parameter tree of the same config
    through the weight bridge, every name and shape, strictly."""
    import jax
    import torch

    from implicit_depth_tpu.train import loop as jloop
    from implicit_depth_tpu.utils.fixtures import synthetic_bd_batch
    from implicit_depth_tpu_torch.config import parse_config
    from implicit_depth_tpu_torch.train.loop import build_net
    from implicit_depth_tpu_torch.weights import load_state_dict, state_dict_from_flax

    argv = ["--config_file", f"configs/models/{model}",
            "--data_config_file", "configs/data/hypersim_default_train.yaml"]
    jcfg = jconfig.parse_and_merge(argv)
    cfg, _ = parse_config(argv + ["--device", "cpu"])
    assert cfg.dataset == "hypersim"
    net = build_net(cfg, kind)
    jnet = jloop.build_net(jcfg, kind)
    cur, src = synthetic_bd_batch(batch=1, num_src=cfg.num_src_views, height=64, width=96,
                                  num_rays=16, samples_per_ray=8, seed=0)
    kwargs = {"flip": False} if kind == "bd" else {}
    shapes = jax.eval_shape(lambda c, s: jnet.init({"params": jax.random.PRNGKey(0)}, c, s,
                                                   **kwargs), cur, src)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    load_state_dict(net, state_dict_from_flax(tree))
    assert net.compute_dtype == torch.bfloat16 and getattr(net, "use_prior", False) == (
        "temporal" in model)
