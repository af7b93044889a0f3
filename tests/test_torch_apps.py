"""Port parity of the AR demo path against the JAX package, on the CPU in
f32: occlusion-matte inference with and without the prior feedback
(apps/inference.py), the hole-filled rendered depth, compositing
(apps/composite.py) in its three matting modes, the VDR capture reader
(apps/vdr_sequence.py), the whole chain from a raw capture through
VDRDataset, run_inference and composite_capture, and the two CLIs.

Both sides get the same tiny BDNet (tests/torch_parity.py's seeded
variables through the weight bridge: the tiny encoder, K=2 source views, 8
planes, 64x96 images) and the same frames. Tolerances: the mattes within
5e-5 absolute (sigmoids of logits that agree to f32 sums in another
order; the bound of tests/test_torch_prior.py's forward_val); the
composited frames of the chain within 1/255 (they are written as 8-bit
JPEGs from those mattes). Everything that is a numpy copy (the rendered
depth's hole filling, compositing, the capture reader) is bit-equal.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from implicit_depth_tpu.apps import composite as jcomposite
from implicit_depth_tpu.apps import inference as jinference
from implicit_depth_tpu.apps import vdr_sequence as jvdr_sequence
from implicit_depth_tpu.data import synthetic as jsynthetic
from implicit_depth_tpu.data import vdr as jvdr
from implicit_depth_tpu.data.mvs_dataset import collate as jcollate
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu_torch.apps import composite, inference, vdr_sequence
from implicit_depth_tpu_torch.data import synthetic, vdr
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from tests.test_torch_data_copies import _assert_tree_equal
from tests.torch_parity import bridged, seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATTE_ATOL = 5e-5
TINY = dict(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module's process (`pytest -n 6` puts six
    test processes on the host's cores; see tests/test_torch_prior.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nets(jds, use_prior: bool, seed: int = 13):
    """The tiny JAX BDNet with seeded variables, and the port's BDNet with
    the same weights through the bridge."""
    jnet = JBDNet(use_prior=use_prior, **TINY)
    cur, src = jcollate([jds[0]])
    cur = {k: v for k, v in cur.items() if k != "frame_id_string"}
    src = {k: v for k, v in src.items() if k != "frame_id_string"}
    cur["rendered_depth"] = cur["rendered_depth"][..., :1]
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=seed)
    return jnet, variables, bridged(BDNet(use_prior=use_prior, **TINY), variables,
                                    TRAIN_ONLY_PREFIXES)


def _synthetic(module):
    return module.SyntheticDataset(num_frames=5, num_views=3, split="val", get_bd_info=True,
                                   pass_frame_id=True)


def _rendered_depths(root, frame_ids, h: int, w: int, seed: int = 0) -> str:
    """A virtual asset's depth per frame: a slanted plane around 2 m, with
    holes of zeros (small ones that the 7x7 max pool fills, and one too
    wide to fill in its middle)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i, fid in enumerate(frame_ids):
        depth = (1.6 + 0.8 * np.linspace(0, 1, w)[None, :] + 0.1 * i
                 + 0.05 * rng.rand(h, w)).astype(np.float32)
        depth[rng.rand(h, w) < 0.05] = 0.0
        depth[4:16, 20:34] = 0.0
        np.save(os.path.join(root, f"{fid}.npy"), depth if i % 2 else depth[..., None])
    return root


def _mattes(paths) -> list:
    return [np.load(p) for p in paths]


@pytest.mark.parametrize("use_prior", [False, True], ids=["noprior", "prior"])
def test_run_inference_matches_jax(tmp_path, use_prior):
    """Three frames with hole-filled rendered depths: the same file names
    and mattes within MATTE_ATOL; with the prior, the port's mattes from
    the second frame on differ from a run without it."""
    jds, ds = _synthetic(jsynthetic), _synthetic(synthetic)
    jnet, variables, net = _nets(jds, use_prior)
    renders = _rendered_depths(str(tmp_path / "renders"), ["2", "3", "4"], ds.depth_height,
                               ds.depth_width)
    kw = dict(rendered_depth_load_dir=renders, sigmoid_multiplier=1.5, use_prior=use_prior,
              max_frames=3)
    ref = jinference.run_inference(jnet, variables, jds, str(tmp_path / "jax"), **kw)
    frame_ms = []
    got = inference.run_inference(net, ds, str(tmp_path / "port"), frame_ms=frame_ms, **kw)
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in ref] == ["00002.npy", "00003.npy", "00004.npy"]
    assert len(frame_ms) == 3 and min(frame_ms) > 0
    for g, r in zip(_mattes(got), _mattes(ref)):
        assert g.shape == r.shape == (ds.depth_height, ds.depth_width) and g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=0, atol=MATTE_ATOL)
        assert 0.0 <= g.min() and g.max() <= 1.0
    if use_prior:
        kw["use_prior"] = False
        plain = _mattes(inference.run_inference(net, ds, str(tmp_path / "noprior"), **kw))
        with_prior = _mattes(got)
        np.testing.assert_array_equal(with_prior[0], plain[0])  # no prior on the first frame
        for a, b in zip(with_prior[1:], plain[1:]):
            assert np.abs(a - b).max() > 1e-3


def test_load_rendered_depth_bit_equal(tmp_path):
    renders = _rendered_depths(str(tmp_path), ["a", "b"], 24, 40, seed=1)
    for fid in ("a", "b"):
        got = inference.load_rendered_depth(renders, fid, 24, 40)
        _assert_tree_equal(got, jinference.load_rendered_depth(renders, fid, 24, 40))
        assert got.shape == (24, 40, 1) and (got[:4] > 0).all() and (got[9:11, 26:28] == 0).all()
    _assert_tree_equal(inference.load_rendered_depth(None, "x", 4, 6),
                       jinference.load_rendered_depth(None, "x", 4, 6))


def _layers(seed: int, h: int = 12, w: int = 16):
    rng = np.random.RandomState(seed)
    image = rng.rand(h, w, 3).astype(np.float32)
    virtual = rng.rand(h, w, 4).astype(np.float32)
    virtual[..., 3] = np.where(rng.rand(h, w) < 0.3, 0.0, virtual[..., 3])
    matte = rng.rand(h, w).astype(np.float32)
    real = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    vdepth = np.where(rng.rand(h, w) < 0.2, 0.0, rng.uniform(0.5, 4.0, (h, w))).astype(np.float32)
    return image, virtual, matte, real, vdepth


@pytest.mark.parametrize("mode", ["mask", "depth", "lidar"])
def test_composite_frame_and_sequence_bit_equal(tmp_path, mode):
    image, virtual, matte, real, vdepth = _layers(2)
    _assert_tree_equal(composite.soft_depth_matte(real, vdepth),
                       jcomposite.soft_depth_matte(real, vdepth))
    for fade in (1.0, 0.4):
        kw = dict(mode=mode, occlusion_matte=matte, real_depth=real, virtual_depth=vdepth,
                  fade=fade)
        _assert_tree_equal(composite.composite_frame(image, virtual, **kw),
                           jcomposite.composite_frame(image, virtual, **kw))
    frames = [_layers(s) for s in range(3, 6)]
    kw = dict(mode=mode, mattes=[f[2] for f in frames], real_depths=[f[3] for f in frames],
              virtual_depths=[f[4] for f in frames], fade_in_frames=2, fps=10)
    composite.composite_sequence([f[0] for f in frames], [f[1] for f in frames],
                                 str(tmp_path / "port.mp4"), **kw)
    jcomposite.composite_sequence([f[0] for f in frames], [f[1] for f in frames],
                                  str(tmp_path / "jax.mp4"), **kw)
    assert (tmp_path / "port.mp4").read_bytes() == (tmp_path / "jax.mp4").read_bytes()


@pytest.fixture
def capture_dir(tmp_path):
    """A synthetic VDR capture, the layout of tests/test_vdr_sequence.py:
    capture.json, RGB jpgs, LiDAR depth bins (the left half near) and their
    confidence bins (all valid), and a tuple file for VDRDataset."""
    from PIL import Image

    path = tmp_path / "cap"
    path.mkdir()
    w, h, dw, dh = 64, 48, 32, 24
    rng = np.random.RandomState(0)
    frames = []
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(
            path / f"frame_{i}.jpg")
        depth = np.full((dh, dw), 3.0, np.float32)
        depth[:, : dw // 2] = 1.0
        depth.tofile(path / f"depth_{i}.bin")
        np.full((dh, dw), 2, np.uint8).tofile(path / f"depthConfidence_{i}.bin")
        T_gl = np.eye(4)
        T_gl[0, 3] = 0.1 * i
        frames.append({"image": f"frame_{i}.jpg", "depth": f"depth_{i}.bin",
                       "pose4x4": T_gl.T.ravel().tolist(),
                       "intrinsics": [50.0, 50.0, w / 2, h / 2, 0.0],
                       "resolution": [w, h], "depthResolution": [dw, dh]})
    with open(path / "capture.json", "w") as f:
        json.dump({"frames": frames}, f)
    tuples_dir = tmp_path / "tuples"
    tuples_dir.mkdir()
    (tuples_dir / "test_tuples.txt").write_text("cap 1 0 2\ncap 2 0 1\ncap 3 1 2\n")
    return path, (w, h), (dw, dh)


def _virtual_renders(root, w: int, h: int) -> str:
    """Rendered virtual layers for frames 1 (RGBA png and depth) and 2 (RGB
    png only); frame 3 has none."""
    from PIL import Image

    rng = np.random.RandomState(3)
    os.makedirs(root)
    Image.fromarray(rng.randint(0, 255, (h, w, 4)).astype(np.uint8)).save(
        os.path.join(root, "frame_00001.png"))
    np.save(os.path.join(root, "frame_00001.npy"), rng.uniform(1.0, 3.0, (h, w)).astype(np.float32))
    Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(
        os.path.join(root, "frame_00002.png"))
    return root


def test_vdr_sequence_bit_equal(capture_dir):
    path, (w, h), _ = capture_dir
    renders = _virtual_renders(str(path / "renders"), w, h)
    for name in ("frame_25.jpg", "frame_123456.jpg", "7", "frame_3"):
        assert vdr_sequence.pad_image_fname(name) == jvdr_sequence.pad_image_fname(name)
    seq, jseq = vdr_sequence.VDRSequence(str(path)), jvdr_sequence.VDRSequence(str(path))
    assert len(seq) == len(jseq) == 4 and seq.frames == jseq.frames
    for frame in seq.frames:
        assert seq.image_name(frame) == jseq.image_name(frame)
        _assert_tree_equal(seq.load_pose_for_frame(frame), jseq.load_pose_for_frame(frame))
        _assert_tree_equal(seq.load_intrinsics_from_frame(frame),
                           jseq.load_intrinsics_from_frame(frame))
        _assert_tree_equal(seq.load_rgb_from_frame(frame), jseq.load_rgb_from_frame(frame))
        _assert_tree_equal(seq.load_lidar_from_frame(frame), jseq.load_lidar_from_frame(frame))
        got = seq.load_virtual_layer(renders, frame)
        ref = jseq.load_virtual_layer(renders, frame)
        assert [x is None for x in got] == [x is None for x in ref]
        _assert_tree_equal(tuple(x for x in got if x is not None),
                           tuple(x for x in ref if x is not None))


def _out_files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mode", ["lidar", "mask", "depth"])
def test_composite_capture_bit_equal(capture_dir, mode):
    """composite_capture of both copies writes the same frames and mp4, in
    each matting mode, with rendered layers for some frames and the flat 2 m
    plane for the rest, with and without the fade-in."""
    path, (w, h), (dw, dh) = capture_dir
    renders = _virtual_renders(str(path / "renders"), w, h)
    rng = np.random.RandomState(4)
    for sub in ("masks", "depths"):
        (path / sub).mkdir()
    for i in range(4):
        np.save(path / "masks" / f"{i:05d}.npy", rng.rand(dh, dw).astype(np.float32))
        np.save(path / "depths" / f"{i:05d}.npy", rng.uniform(1.0, 3.0, (dh, dw)).astype(np.float32))
    kw = dict(mode=mode, predicted_masks_dir=str(path / "masks"),
              predicted_depths_dir=str(path / "depths"), fps=10)
    for extra in (dict(renders_dir=renders, fadein=True), dict(limit_frames=3)):
        tag = "fade" if extra.get("fadein") else "limit"
        mp4 = composite.composite_capture(str(path), str(path / f"port_{tag}"), **kw, **extra)
        jmp4 = jcomposite.composite_capture(str(path), str(path / f"jax_{tag}"), **kw, **extra)
        assert os.path.basename(mp4) == os.path.basename(jmp4) == "composited.mp4"
        got, ref = _out_files(path / f"port_{tag}"), _out_files(path / f"jax_{tag}")
        assert got == ref
        assert len([f for f in got if f.endswith(".jpg")]) == (3 if tag == "fade" else 2)


def test_capture_to_inference_to_composite_chain_matches_jax(capture_dir):
    """The AR pipeline off one raw capture, port against JAX: VDRDataset
    over capture.json, run_inference's mattes (same names, the padded frame
    numbers composite_capture looks up, within MATTE_ATOL), then
    composite_capture in mask mode (the same frames within 1/255)."""
    from PIL import Image

    path, _, (dw, dh) = capture_dir
    kw = dict(dataset_path=str(path.parent), split="test", mv_tuple_file_suffix="_tuples.txt",
              tuple_info_file_location=str(path.parent / "tuples"), image_height=64,
              image_width=96, native_depth_width=dw, native_depth_height=dh,
              num_images_in_tuple=3, get_bd_info=True, pass_frame_id=True)
    jds, ds = jvdr.VDRDataset(**kw), vdr.VDRDataset(**kw)
    jnet, variables, net = _nets(jds, use_prior=True, seed=5)
    ref = jinference.run_inference(jnet, variables, jds, str(path / "jax_mattes"), use_prior=True)
    got = inference.run_inference(net, ds, str(path / "port_mattes"), use_prior=True)
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in ref] == ["00001.npy", "00002.npy", "00003.npy"]
    for g, r in zip(_mattes(got), _mattes(ref)):
        np.testing.assert_allclose(g, r, rtol=0, atol=MATTE_ATOL)

    outs = {}
    for side, fn in (("port", composite.composite_capture), ("jax", jcomposite.composite_capture)):
        fn(str(path), str(path / f"{side}_out"), mode="mask",
           predicted_masks_dir=str(path / f"{side}_mattes"))
        outs[side] = sorted(f for f in os.listdir(path / f"{side}_out") if f.endswith(".jpg"))
    assert outs["port"] == outs["jax"] == ["frame_00001.jpg", "frame_00002.jpg", "frame_00003.jpg"]
    for name in outs["port"]:
        a, b = (np.asarray(Image.open(path / f"{side}_out" / name), np.float32)
                for side in ("port", "jax"))
        np.testing.assert_allclose(a, b, rtol=0, atol=1.0)  # 1/255 of the [0, 1] range


def _config_argv(tmp_path) -> list:
    """The temporal config, shrunk: tiny encoder, f32, K=2, 8 planes, 64x96,
    five synthetic frames (three tuples)."""
    return ["--config_file", "configs/models/implicit_depth_temporal.yaml",
            "--data_config_file", "configs/data/synthetic_temporal.yaml",
            "--image_encoder_name", "tiny", "--precision", "32", "--model_num_views", "3",
            "--matching_num_depth_bins", "8", "--image_height", "64", "--image_width", "96",
            "--synthetic_num_frames", "5", "--output_base_path", str(tmp_path / "out"),
            "--device", "cpu"]


def test_inference_cli_on_the_cpu(tmp_path):
    """cli/inference.main with the prior, the rendered depths and a sigmoid
    multiplier writes the mattes that run_inference gives for the same
    weights and dataset, bit for bit, under <output_base_path>/<name>/
    mattes/<scan>; without --load_weights_from_checkpoint it refuses."""
    from implicit_depth_tpu_torch.cli import inference as cli
    from implicit_depth_tpu_torch.cli.test_bd import load_bd_net
    from implicit_depth_tpu_torch.config import parse_config
    from implicit_depth_tpu_torch.train.loop import build_dataset, build_net
    from implicit_depth_tpu_torch.weights import init_params

    argv = _config_argv(tmp_path)
    cfg, _ = parse_config(argv)
    weights = str(tmp_path / "w.pt")
    torch.save(init_params(build_net(cfg), torch.Generator().manual_seed(2)).state_dict(), weights)
    renders = _rendered_depths(str(tmp_path / "renders"), ["2", "3", "4"], 32, 48)
    flags = argv + ["--load_weights_from_checkpoint", weights, "--rendered_depth_map_load_dir",
                    renders, "--bd_sigmoid_multiplier", "2.0", "--max_frames", "3"]
    res = cli.main(flags)
    assert res["out_dir"] == str(tmp_path / "out" / "implicit_depth_temporal" / "mattes" / "scene0")
    assert [os.path.basename(p) for p in res["saved"]] == ["00002.npy", "00003.npy", "00004.npy"]
    assert len(res["frame_ms"]) == 3
    cfg, _ = parse_config(flags)
    assert cfg.use_prior
    ref = inference.run_inference(
        load_bd_net(cfg, "cpu"), build_dataset(cfg, cfg.split, "bd", pass_frame_id=True),
        str(tmp_path / "ref"), rendered_depth_load_dir=renders, sigmoid_multiplier=2.0,
        use_prior=True, max_frames=3)
    for g, r in zip(_mattes(res["saved"]), _mattes(ref)):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(SystemExit):
        cli.main(argv)


def _jax_composite_script():
    spec = importlib.util.spec_from_file_location("jax_composite_script",
                                                  os.path.join(REPO, "scripts", "composite.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_composite_cli_on_the_cpu(capture_dir, monkeypatch):
    """cli/composite.main in capture mode (mattes) and in directory mode
    writes what scripts/composite.py writes, byte for byte."""
    from PIL import Image

    from implicit_depth_tpu_torch.cli import composite as cli

    path, (w, h), (dw, dh) = capture_dir
    rng = np.random.RandomState(6)
    for sub in ("masks", "rgb", "layers", "dir_mattes"):
        (path / sub).mkdir()
    for i in range(4):
        np.save(path / "masks" / f"{i:05d}.npy", rng.rand(dh, dw).astype(np.float32))
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(
            path / "rgb" / f"f{i}.png")
        Image.fromarray(rng.randint(0, 255, (h, w, 4 - i % 2)).astype(np.uint8)).save(
            path / "layers" / f"f{i}.png")
        np.save(path / "dir_mattes" / f"f{i}.npy", rng.rand(h, w).astype(np.float32))
    script = _jax_composite_script()
    for side in ("port", "jax"):
        argvs = [["--vdr_dir", str(path), "--out_dir", str(path / f"{side}_capture"),
                  "--predicted_masks_dir", str(path / "masks"), "--fadein"],
                 ["--images_dir", str(path / "rgb"), "--virtual_dir", str(path / "layers"),
                  "--mattes_dir", str(path / "dir_mattes"), "--output",
                  str(path / f"{side}_dir" / "composite.mp4"), "--fps", "12"]]
        for argv in argvs:
            if side == "port":
                assert os.path.exists(cli.main(argv))
            else:
                monkeypatch.setattr(sys, "argv", ["composite.py"] + argv)
                script.main()
    for kind in ("capture", "dir"):
        got, ref = _out_files(path / f"port_{kind}"), _out_files(path / f"jax_{kind}")
        assert got == ref and {"composited.mp4", "composite.mp4"} & set(got)
