"""The port's data-preparation CLIs against the JAX package's scripts: on
the same tiny on-disk captures (those tests/test_torch_datasets.py writes,
and a small ScanNet .sens written here) each writes byte-equal files.
The JAX scripts run in this process (tests/torch_parity.py::run_jax_script);
each side's new files are read and removed before the other side runs, so
both start from the same tree.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from implicit_depth_tpu_torch.cli import (extract_scannet_sens, generate_hypersim_planar_depths,
                                          generate_test_tuples, generate_train_tuples,
                                          precompute_valid_frames, preprocess_7scenes,
                                          preprocess_arkit)
from tests.test_torch_datasets import _arkit, _hypersim, _pose
from tests.torch_parity import run_jax_script


def _files(root) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, names in os.walk(root) for f in names}


def _new_files(root, run) -> dict:
    """Runs run(), then returns {path: bytes} of the files it added under
    root and removes them."""
    before = _files(root)
    run()
    added = sorted(_files(root) - before)
    out = {}
    for rel in added:
        path = os.path.join(root, rel)
        with open(path, "rb") as f:
            out[rel] = f.read()
        os.remove(path)
    return out


def _same_outputs(root, script: str, args: list, port_main) -> dict:
    ref = _new_files(root, lambda: run_jax_script(script, args))
    got = _new_files(root, lambda: port_main(args))
    assert sorted(got) == sorted(ref) and ref
    for rel in ref:
        assert got[rel] == ref[rel], rel
    return got


@pytest.mark.parametrize("kind,tuple_type", [("test", "dense"), ("test", "default"),
                                             ("train", None)])
def test_tuple_clis_write_the_same_file(tmp_path, kind, tuple_type):
    root = str(tmp_path)
    _, scan, _ = _arkit(root, n=40, scan="walk", images=False)
    split_file = os.path.join(root, "scans.txt")
    with open(split_file, "w") as f:
        f.write(scan + "\n")
    args = ["--dataset", "arkit", "--dataset_path", root, "--dataset_scan_split_file", split_file,
            "--tuple_info_file_location", os.path.join(root, "tuples"),
            "--mv_tuple_file_suffix", "_walk.txt", "--split", kind, "--num_images_in_tuple", "4",
            "--num_workers", "2"]
    if tuple_type:
        args += ["--frame_tuple_type", tuple_type]
    script, cli = (("generate_test_tuples.py", generate_test_tuples) if kind == "test"
                   else ("generate_train_tuples.py", generate_train_tuples))
    got = _same_outputs(root, script, args, cli.main)
    assert list(got) == [os.path.join("tuples", f"{kind}_walk.txt")]
    assert len(got[list(got)[0]].splitlines()) > 3


def _write_sens(path: str, n: int = 5, bad_pose: int = 2) -> None:
    """A version-4 ScanNet .sens of n frames (colour JPEGs of 40x30, uint16
    depth of 32x24 zlib-compressed), frame `bad_pose` with an inf pose."""
    import io

    from PIL import Image

    rng = np.random.RandomState(9)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 30.0, 31.0, 16.0, 12.0
    with open(path, "wb") as f:
        name = b"StructureSensor"
        f.write(struct.pack("<IQ", 4, len(name)) + name)
        for m in (2 * K, np.eye(4), K, np.eye(4)):
            f.write(np.asarray(m, np.float32).tobytes())
        f.write(struct.pack("<iiIIIIfIQ", 2, 1, 40, 30, 32, 24, 1000.0, 0, n))
        for i in range(n):
            pose = _pose(i).astype(np.float32)
            if i == bad_pose:
                pose[0, 0] = np.inf
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (30, 40, 3)).astype(np.uint8)).save(buf, "JPEG")
            depth = zlib.compress(rng.randint(0, 5000, (24, 32)).astype(np.uint16).tobytes())
            f.write(pose.tobytes() + struct.pack("<QQQQ", i, i, len(buf.getvalue()), len(depth)))
            f.write(buf.getvalue() + depth)


def test_scannet_sens_extraction_and_valid_frames(tmp_path):
    """extract_scannet_sens on a .sens written here, then
    precompute_valid_frames over the extracted ScanNet layout: the same
    files, and the inf pose's frame left out of valid_frames.txt."""
    raw, root = str(tmp_path / "raw"), str(tmp_path / "scannet")
    os.makedirs(os.path.join(raw, "scene0000_00"))
    _write_sens(os.path.join(raw, "scene0000_00", "scene0000_00.sens"))
    out = os.path.join(root, "scans")
    os.makedirs(out)
    args = ["--scans_dir", raw, "--output_dir", out, "--frame_skip", "1"]
    # the port's run must leave the tree for the valid-frames step
    _same_outputs(out, "extract_scannet_sens.py", args, extract_scannet_sens.main)
    extract_scannet_sens.main(args)
    args = ["--dataset", "scannet", "--dataset_path", root, "--single_debug_scan_id",
            "scene0000_00", "--split", "train", "--num_workers", "1"]
    got = _same_outputs(root, "precompute_valid_frames.py", args, precompute_valid_frames.main)
    lines = got[os.path.join("scans", "scene0000_00", "valid_frames.txt")].decode().split()
    assert "000002" not in lines and "000003" in lines


def test_hypersim_planar_depths(tmp_path, monkeypatch):
    """Both tools build the dataset with its default split_json_dir,
    data_splits/hypersim under the working directory: the test runs where
    that names the capture's split files."""
    root = str(tmp_path / "hypersim")
    kwargs, scan, _ = _hypersim(root)
    os.makedirs(tmp_path / "cwd" / "data_splits")
    os.symlink(kwargs["split_json_dir"], tmp_path / "cwd" / "data_splits" / "hypersim")
    monkeypatch.chdir(tmp_path / "cwd")
    args = ["--dataset", "hypersim", "--dataset_path", root, "--single_debug_scan_id", scan,
            "--split", "train", "--num_workers", "1"]
    got = _same_outputs(root, "generate_hypersim_planar_depths.py", args,
                        generate_hypersim_planar_depths.main)
    assert sum(rel.endswith("planar_depth_meters.hdf5") for rel in got) == 5


def test_preprocess_7scenes(tmp_path):
    """Raw Kinect depth (mm, 65535 and 0 invalid) registered onto the RGB
    camera: the same depth.proj.png files."""
    from PIL import Image

    rng = np.random.RandomState(10)
    seq = tmp_path / "chess" / "seq-01"
    seq.mkdir(parents=True)
    for i in range(2):
        depth = rng.randint(500, 4000, (48, 64)).astype(np.uint16)
        depth[:3] = 65535
        depth[-2:] = 0
        Image.fromarray(depth, mode="I;16").save(seq / f"frame-{i:06d}.depth.png")
    got = _same_outputs(str(tmp_path), "preprocess_7scenes.py",
                        ["--dataset_path", str(tmp_path)], preprocess_7scenes.main)
    assert len(got) == 2


def test_preprocess_arkit(tmp_path):
    """A raw capture (an MPEG-4 video of 6 frames 100 ms apart, their
    timestamps, poses for 4 of them): the same images, poses and
    intrinsics, for the 4 frames with a pose within 50 ms."""
    import cv2

    cap = tmp_path / "capture"
    cap.mkdir()
    rng = np.random.RandomState(11)
    writer = cv2.VideoWriter(str(cap / "Frames.m4v"), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (64, 48))
    for _ in range(6):
        writer.write(rng.randint(0, 255, (48, 64, 3)).astype(np.uint8))
    writer.release()
    ts = [0.1 * i for i in range(6)]
    (cap / "Frames.txt").write_text("".join(f"{t:.3f}, 0\n" for t in ts))
    poses = [f"{t + 0.001:.3f}, {0.1 * i}, 0.2, 0.3, 0.9, 0.1, 0.2, 0.3\n"
             for i, t in enumerate(ts) if i not in (2, 3)]  # 2, 3: no pose within 50 ms
    (cap / "ARposes.txt").write_text("# ts, t, q\n" + "".join(poses))
    out = tmp_path / "out"
    got = _same_outputs(str(tmp_path), "preprocess_arkit.py",
                        ["--capture_dir", str(cap), "--output_dir", str(out), "--size", "32", "24"],
                        preprocess_arkit.main)
    assert sum(rel.endswith(".jpg") for rel in got) == 4
