"""Port parity for the temporal (flicker) evaluation against the JAX package,
on the CPU in f32: the plane renderer, the rasterizer bindings, the device
vertex scorer, `evaluate_temporal` in frame and window mode (BD model with
the prior, and the regression model), and both CLIs' --temporal_eval.

Sizes: the tiny encoder, K=2 source views, 8 planes, 64x96 images (32x48
maps), eval windows of 3 frames. Tolerances:
- render_plane_depth: 1e-5 of the largest depth (f32 4x4 inverses and
  products in another order).
- The rasterizer bindings build the same csrc/rasterizer.cpp with the same
  flags: bit-equal. DeviceVertexScorer re-implements its sampling in f32
  elementwise ops in the same order: equal to the C++.
- evaluate_temporal, BD model: the per-frame sigmoid maps within 1e-5
  (the logits agree to 5e-5 relative as tests/test_torch_bd_net.py; the
  prior carries a frame's difference into the next, which the sigmoid
  damps), and equal flip and vertex counts.
- evaluate_temporal, regression: the occlusion map is a hard comparison of
  the plane with the predicted depth (~1e-6 relative apart), so a pixel may
  flip where the two sit that close; at most 1e-3 of the pixels may differ,
  and the flip counts are equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.data.mvs_dataset import collate as jcollate
from implicit_depth_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from implicit_depth_tpu.eval import rasterizer as jras
from implicit_depth_tpu.eval.temporal_driver import evaluate_temporal as jevaluate_temporal
from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
from implicit_depth_tpu_torch.eval import rasterizer as ras
from implicit_depth_tpu_torch.eval.temporal import TemporalEvaluator
from implicit_depth_tpu_torch.eval.temporal_driver import evaluate_temporal
from implicit_depth_tpu_torch.eval.vertex_scorer import DeviceVertexScorer
from implicit_depth_tpu_torch.models.bd_net import TRAIN_ONLY_PREFIXES, BDNet
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.utils.native_build import BUILD_DIR, REPO_CSRC
from implicit_depth_tpu_torch.weights import init_params
from tests.torch_parity import bridged, seeded_variables

K, D_BINS, H, W = 2, 8, 64, 96
FRAMES = dict(eval_length=3, warmup=1, frame_multiplier=2, max_frames_per_scene=7)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """`pytest -n 6` puts six test processes on the host's cores. With
    torch's OpenMP pool at one thread per core in each, the cores are
    oversubscribed and every parallel op's barrier waits on descheduled
    threads (a tiny train step took 60x longer beside a second such
    process). Two threads in this module's process."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rot(axis, angle):
    c, s = np.cos(angle), np.sin(angle)
    i, j = [a for a in range(3) if a != axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def _pose(rng):
    T = np.eye(4)
    T[:3, :3] = _rot(0, rng.uniform(-0.2, 0.2)) @ _rot(1, rng.uniform(-0.3, 0.3))
    T[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return T.astype(np.float32)


def _K44(h, w):
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.8 * w
    K[0, 2], K[1, 2] = w / 2, h / 2
    return K


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """The synthetic scene's procedural mesh at ~20k faces, as a PLY."""
    return SyntheticDataset.get_gt_mesh_path(str(tmp_path_factory.mktemp("mesh")), "val",
                                             "scene0", target_faces=20000)


@pytest.fixture(scope="module")
def scene():
    kw = dict(num_frames=9, num_views=K + 1, split="val", get_bd_info=True, image_height=H,
              image_width=W)
    return JSyntheticDataset(**kw), SyntheticDataset(**kw)


def test_render_plane_depth_matches_jax():
    rng = np.random.RandomState(0)
    for h, w in ((32, 48), (192, 256)):
        anchor, cam, K = np.linalg.inv(_pose(rng)), _pose(rng), _K44(h, w)
        for dist in (1.5, 3.2):
            ref = np.asarray(jras.render_plane_depth(jnp.asarray(anchor), jnp.float32(dist),
                                                     jnp.asarray(cam), jnp.asarray(K), h, w))
            got = ras.render_plane_depth(torch.tensor(anchor), torch.tensor(dist),
                                         torch.tensor(cam), torch.tensor(K), h, w).numpy()
            assert got.dtype == np.float32 and (ref > 0).mean() > 0.5
            np.testing.assert_array_equal(got > 0, ref > 0)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_render_plane_matches_jax():
    """TemporalEvaluator.render_plane after initialise_new_plane on a seeded
    depth map and pose: equal to the JAX evaluator's within 1e-5 of the
    largest depth, for a camera near the anchor and one that sees the plane
    at a grazing angle (82 degrees from its normal). Hit and miss pixels
    agree but where the ray meets the rectangle's edge within 1e-4 of its
    half extent (f32 on both sides); those are counted and are the only
    exceptions."""
    import chip_smoke
    from implicit_depth_tpu.eval.temporal import TemporalEvaluator as JTemporalEvaluator

    rng = np.random.RandomState(7)
    h, w = 48, 64
    depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    depth[:4] = np.nan
    world_T_anchor = np.linalg.inv(_pose(rng)).astype(np.float32)
    ev, jev = TemporalEvaluator(h, w), JTemporalEvaluator(h, w)
    for e in (ev, jev):
        e.initialise_new_plane(depth, world_T_anchor)
    dist = ev.plane_distance
    grazing = np.eye(4)
    grazing[:3, :3] = _rot(1, np.deg2rad(82.0))
    grazing[:3, 3] = [-6.0, 0.3, dist - 0.8]
    near = np.eye(4)
    near[:3, :3] = _rot(0, 0.1) @ _rot(1, -0.15)
    near[:3, 3] = [0.2, -0.1, 0.3]
    K = _K44(h, w)
    for label, anchor_T_cam in (("near", near), ("grazing", grazing)):
        cam_T_world = np.linalg.inv(world_T_anchor.astype(np.float64) @ anchor_T_cam)
        cam_T_world = cam_T_world.astype(np.float32)
        ref = np.asarray(jev.render_plane(cam_T_world, K))
        got = ev.render_plane(torch.tensor(cam_T_world), torch.tensor(K))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        got = got.numpy()
        np.testing.assert_array_equal(
            ev.render_plane(cam_T_world, K, device="cpu").numpy(), got)
        edge = chip_smoke.plane_edge_pixels(world_T_anchor, dist, cam_T_world, K, h, w)
        differ = (got > 0) != (ref > 0)
        assert not (differ & ~edge).any(), (label, int(differ.sum()), int(edge.sum()))
        assert (ref > 0).mean() > 0.2 and (ref == 0).any() == (label == "grazing"), label
        both = (got > 0) & (ref > 0)
        np.testing.assert_allclose(got[both], ref[both], rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=label)
    with pytest.raises(ValueError):
        ev.render_plane(cam_T_world, K)


def test_rasterizer_bindings_bit_equal(mesh, scene):
    verts, faces = ras.load_ply(mesh)
    jverts, jfaces = jras.load_ply(mesh)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    _, ds = scene
    rng = np.random.RandomState(1)
    for i in (0, 4):
        frame = ds.get_frame("scene0", i)
        T, K = frame["cam_T_world"], frame["K_s0"]
        h, w = frame["depth"].shape[:2]
        zbuf = ras.rasterize_mesh_depth(verts, faces, T, K, h, w)
        assert (zbuf > 0).mean() > 0.5
        np.testing.assert_array_equal(zbuf, jras.rasterize_mesh_depth(verts, faces, T, K, h, w))
        np.testing.assert_array_equal(ras.project_mesh_vertices(verts, T, K),
                                      jras.project_mesh_vertices(verts, T, K))
        pred = rng.rand(h, w).astype(np.float32)
        got = ras.sample_vertex_predictions(verts, faces, T, K, pred)
        assert (got > 0).sum() > 100
        np.testing.assert_array_equal(got, jras.sample_vertex_predictions(verts, faces, T, K, pred))
    # built into the port's own directory, not beside the source
    assert list(BUILD_DIR.glob("librasterizer_*.so"))
    assert os.path.dirname(ras._load_lib()._name) == str(BUILD_DIR)
    assert REPO_CSRC != BUILD_DIR.parent


def test_device_vertex_scorer_matches_cpp(mesh, scene):
    """Per frame, the scorer's values equal the fused C++ sampling (and a
    numpy composition of its steps); per window, its flip count equals the
    host evaluator's."""
    verts, faces = ras.load_ply(mesh)
    _, ds = scene
    h, w = ds.depth_height, ds.depth_width
    rng = np.random.RandomState(2)
    scorer = DeviceVertexScorer(verts, h, w, "cpu")
    ev = TemporalEvaluator(h, w)
    ev.initialise_new_scene(verts=verts, faces=faces)
    preds, zbufs, cams, Ks = [], [], [], []
    for i in range(4):
        frame = ds.get_frame("scene0", i)
        T, K = frame["cam_T_world"], frame["K_s0"]
        pred = rng.rand(h, w).astype(np.float32)
        pred[rng.rand(h, w) < 0.1] = 0.5  # ties at the threshold pass through
        zbuf = ras.rasterize_mesh_depth(verts, faces, T, K, h, w)
        got = scorer.frame_values(torch.tensor(pred), torch.tensor(zbuf), torch.tensor(T),
                                  torch.tensor(K)).numpy()
        ref = ras.sample_vertex_predictions(verts, faces, T, K, pred)
        np.testing.assert_array_equal(got, ref)
        # the numpy composition of the same steps
        uvz = ras.project_mesh_vertices(verts, T, K)
        u, v = np.round(uvz[:, 0] - 0.5).astype(int), np.round(uvz[:, 1] - 0.5).astype(int)
        inb = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        uc, vc = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
        p = ev.mask_prediction_edges(pred)[vc, uc]
        z = zbuf[vc, uc]
        ok = inb & (z > 0) & (uvz[:, 2] > 0) & (np.abs(uvz[:, 2] - z) < 0.05) & (p > 0)
        np.testing.assert_array_equal(np.where(ok, p, -1.0).astype(np.float32), ref)
        ev.update_vertex_predictions(pred, T, K)
        preds.append(pred), zbufs.append(zbuf), cams.append(T), Ks.append(K)
    ev.compute_vertex_occlusion_changes()
    flips = scorer.window_flips(torch.tensor(np.stack(preds)), np.stack(zbufs), np.stack(cams),
                                np.stack(Ks))
    assert ev.total_diffs > 100 and float(flips) == ev.total_diffs


def _bd_pair(scene, use_prior=True):
    jds, _ = scene
    cur, src = jcollate([jds[0]])
    cur = {k: jnp.asarray(v) for k, v in cur.items()}
    src = {k: jnp.asarray(v) for k, v in src.items()}
    kw = dict(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny",
              use_prior=use_prior)
    jnet = JBDNet(**kw)
    variables = seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, method=JBDNet.forward_val),
        cur, src, seed=7)
    return jnet, variables, bridged(BDNet(**kw), variables, TRAIN_ONLY_PREFIXES)


def test_evaluate_temporal_frame_mode_matches_jax(scene, mesh):
    jds, ds = scene
    jnet, variables, net = _bd_pair(scene)
    hw = dict(height=ds.depth_height, width=ds.depth_width)
    ref = jevaluate_temporal(jnet, variables, {"scene0": jds}, {"scene0": mesh},
                             collect_preds=True, **hw, **FRAMES)
    got = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, collect_preds=True, **hw,
                            **FRAMES)
    assert len(got["preds"]) == len(ref["preds"]) == got["n_frames"] == 7
    for a, b in zip(got["preds"], ref["preds"]):
        assert a.shape == (ds.depth_height, ds.depth_width)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert got["total_verts"] == ref["total_verts"] > 0
    assert got["total_diffs"] == ref["total_diffs"] > 0
    assert got["temporal_score"] == ref["temporal_score"]
    assert np.isfinite(got["forward_ms"]) and got["raster_ms"] > 0


def test_window_device_scoring_matches_frame_mode(scene, mesh):
    """The window loop with device scoring against the frame loop with the
    C++ host scoring: the same maps (the same forwards in the same order)
    and the same counts; and the window loop with host scoring too."""
    _, ds = scene
    _, _, net = _bd_pair(scene)
    kw = dict(height=ds.depth_height, width=ds.depth_width, collect_preds=True, **FRAMES)
    frame = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, **kw)
    device = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, use_scan=True,
                               device_scoring=True, **kw)
    host = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, use_scan=True, **kw)
    for r in (device, host):
        assert r["n_frames"] == 7
        for a, b in zip(r["preds"], frame["preds"]):
            np.testing.assert_array_equal(a, b)
        assert (r["total_diffs"], r["total_verts"]) == (frame["total_diffs"],
                                                        frame["total_verts"])


def test_regression_temporal_matches_jax(scene, mesh):
    jds, ds = scene
    cur, src = jcollate([jds[0]])
    cur = {k: jnp.asarray(v) for k, v in cur.items()}
    src = {k: jnp.asarray(v) for k, v in src.items()}
    kw = dict(num_src_views=K, num_depth_bins=D_BINS, image_encoder_name="tiny")
    jnet = JDepthNet(**kw)
    variables = seeded_variables(lambda key, c, s: jnet.init({"params": key}, c, s), cur, src,
                                 seed=5)
    # these weights predict log depths around -0.3 +- 0.2 and the plane sits
    # near 1.4 m: shift the scale-0 head onto the plane, so that the hard
    # classifier sees both classes
    head = variables["params"]["decoder"]["output_head_0"]
    head["bias"] = head["bias"] + np.float32(0.66)
    net = bridged(DepthNet(**kw), variables)
    args = dict(regression=True, collect_preds=True, height=ds.depth_height,
                width=ds.depth_width, **dict(FRAMES, max_frames_per_scene=5))
    ref = jevaluate_temporal(jnet, variables, {"scene0": jds}, {"scene0": mesh}, **args)
    got = evaluate_temporal(net, {"scene0": ds}, {"scene0": mesh}, **args)
    maps_got, maps_ref = np.stack(got["preds"]), np.stack(ref["preds"])
    assert 0.05 < maps_ref.mean() < 0.95  # both classes occur
    assert (maps_got != maps_ref).mean() <= 1e-3
    assert got["total_diffs"] == ref["total_diffs"]
    assert got["total_verts"] == ref["total_verts"] > 0


def _checkpoint(tmp_path, net) -> str:
    path = str(tmp_path / "weights.pt")
    torch.save(init_params(net, torch.Generator().manual_seed(0)).state_dict(), path)
    return path


CLI_FLAGS = ["--data_config_file", "configs/data/synthetic_temporal.yaml", "--device", "cpu",
             "--image_encoder_name", "tiny", "--precision", "32", "--image_height", "64",
             "--image_width", "96", "--max_frames", "4", "--model_num_views", "3", "--matching_num_depth_bins", "8"]


@pytest.mark.parametrize("scan", [False, True], ids=["frames", "windows"])
def test_test_bd_temporal_cli(tmp_path, capsys, scan):
    from implicit_depth_tpu_torch.cli import test_bd

    ckpt = _checkpoint(tmp_path, BDNet(num_src_views=2, num_depth_bins=8,
                                       image_encoder_name="tiny", use_prior=True))
    res = test_bd.main(["--config_file", "configs/models/implicit_depth_temporal.yaml",
                        "--temporal_eval", "--load_weights_from_checkpoint", ckpt,
                        "--output_base_path", str(tmp_path)] + CLI_FLAGS
                       + (["--temporal_scan"] if scan else []))
    assert np.isfinite(res["temporal_score"]) and res["n_frames"] == 4
    assert res["total_verts"] > 0
    assert "temporal_score:" in capsys.readouterr().out


def test_test_reg_temporal_cli(tmp_path, capsys):
    from implicit_depth_tpu_torch.cli import test_reg

    ckpt = _checkpoint(tmp_path, DepthNet(num_src_views=2, num_depth_bins=8,
                                          image_encoder_name="tiny"))
    res = test_reg.main(["--config_file", "configs/models/regression_model.yaml",
                         "--temporal_eval", "--load_weights_from_checkpoint", ckpt,
                         "--output_base_path", str(tmp_path)] + CLI_FLAGS)
    assert np.isfinite(res["temporal_score"]) and res["n_frames"] == 4
    assert "temporal_score:" in capsys.readouterr().out
