"""The port keeps its own copies of the JAX package's numpy data modules
(config, data/{keyframes,mvs_dataset,synthetic,loader,registry,scannet},
utils/{caching,fixtures,io,native_io}). These tests keep the copies from
drifting: for a fixed seed, both give bit-equal arrays, both merge the
flagship and synthetic configs to the same Config, and a frame cached by
one loads bit-equal from the other's files."""

import dataclasses
import os

import numpy as np
import pytest

from implicit_depth_tpu import config as jconfig
from implicit_depth_tpu.data import keyframes as jkeyframes
from implicit_depth_tpu.data import loader as jloader
from implicit_depth_tpu.data import mvs_dataset as jmvs
from implicit_depth_tpu.data import synthetic as jsynthetic
from implicit_depth_tpu.utils import caching as jcaching
from implicit_depth_tpu.utils import fixtures as jfixtures
from implicit_depth_tpu_torch import config
from implicit_depth_tpu_torch.data import keyframes, loader, mvs_dataset, registry, synthetic
from implicit_depth_tpu_torch.utils import caching, fixtures

MODEL_CFG = "configs/models/implicit_depth.yaml"
DATA_CFG = "configs/data/synthetic_smoke.yaml"


def _assert_tree_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _datasets(split="train"):
    kw = dict(num_frames=6, num_views=3, image_height=64, image_width=96, split=split,
              get_bd_info=True)
    return (jsynthetic.SyntheticDataset(bd_config=jmvs.BDSamplingConfig(num_rays=64, samples_per_ray=8), **kw),
            synthetic.SyntheticDataset(bd_config=mvs_dataset.BDSamplingConfig(num_rays=64, samples_per_ray=8),
                                       **kw))


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_items_bit_equal(split):
    jds, ds = _datasets(split)
    assert len(jds) == len(ds) > 0
    for i in range(len(ds)):
        _assert_tree_equal(jds[i], ds[i])
    if split == "train":
        cur, _ = ds[0]
        assert cur["sampled_rays"].shape == (64, 2) and cur["sampled_depths"].shape == (64, 8)


def test_collate_and_batch_loader_bit_equal():
    jds, ds = _datasets()
    _assert_tree_equal(jmvs.collate([jds[0], jds[1]]), mvs_dataset.collate([ds[0], ds[1]]))
    jds, ds = _datasets()
    jb = list(jloader.BatchLoader(jds, 2, num_workers=1, seed=3, epochs=1))
    tb = list(loader.BatchLoader(ds, 2, num_workers=1, seed=3, epochs=1))
    assert len(jb) == len(tb) == len(ds) // 2 > 0
    _assert_tree_equal(jb, tb)


def test_fixtures_and_pose_distance_bit_equal():
    for kw in (dict(batch=2, num_src=3, height=64, width=96, num_rays=16, samples_per_ray=4, seed=5),
               dict(batch=1, num_src=2, height=32, width=48, with_train_keys=False)):
        _assert_tree_equal(jfixtures.synthetic_bd_batch(**kw), fixtures.synthetic_bd_batch(**kw))
    np.testing.assert_array_equal(jfixtures.make_K44(1, 2, 3, 4), fixtures.make_K44(1, 2, 3, 4))
    rng = np.random.RandomState(0)
    a, b = (np.linalg.qr(rng.randn(4, 4))[0].astype(np.float32) for _ in range(2))
    a[3] = b[3] = [0, 0, 0, 1]
    _assert_tree_equal(tuple(np.asarray(x) for x in jkeyframes.pose_distance_np(a, b)),
                       tuple(np.asarray(x) for x in keyframes.pose_distance_np(a, b)))
    np.testing.assert_array_equal(jmvs.reverse_imagenet_normalize(a[:3, :3]),
                                  mvs_dataset.reverse_imagenet_normalize(a[:3, :3]))


def test_config_copy_merges_the_same():
    argv = ["--config_file", MODEL_CFG, "--data_config_file", DATA_CFG, "--max_steps", "7"]
    jcfg = jconfig.parse_and_merge(argv)
    cfg, device = config.parse_config(argv + ["--device", "cpu"])
    assert device == "cpu"
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.max_steps == 7 and cfg.dataset == "synthetic" and cfg.precision == 16


def test_registry_names_what_is_not_copied():
    assert registry.get_dataset("synthetic")[0] is synthetic.SyntheticDataset
    with pytest.raises(NotImplementedError, match="hypersim"):
        registry.get_dataset("hypersim")
    with pytest.raises(ValueError):
        registry.get_dataset("no_such_dataset")


def test_cached_frames_round_trip_bit_equal(tmp_path):
    """cache_model_outputs of both copies write the same files from one
    batch (frame ids given, and numbered from the batch index without
    them); each copy's load_cached_output reads the other's bit-equal."""
    jds = jsynthetic.SyntheticDataset(num_frames=6, num_views=3, split="val", get_bd_info=True,
                                      pass_frame_id=True)
    cur, _ = jmvs.collate([jds[0], jds[1]])
    rng = np.random.RandomState(1)
    outputs = {"search_depths": rng.rand(2, 32, 48, 1).astype(np.float32)}
    for ids in (cur["frame_id_string"], None):
        data = dict(cur, frame_id_string=ids)
        src = {"frame_id_string": [["a", "b"], ["c", "d"]]}
        jpaths = jcaching.cache_model_outputs(str(tmp_path / "jax"), outputs, data, src, 3, 2)
        paths = caching.cache_model_outputs(str(tmp_path / "port"), outputs, data, src, 3, 2)
        names = [os.path.basename(p) for p in paths]
        assert names == [os.path.basename(p) for p in jpaths]
        assert names == ([f"{i}.pickle" for i in ids] if ids else ["000006.pickle", "000007.pickle"])
        for name in names:
            frame_id = name[:-len(".pickle")]
            got = caching.load_cached_output(str(tmp_path / "jax"), frame_id)
            _assert_tree_equal(got, jcaching.load_cached_output(str(tmp_path / "port"), frame_id))
            assert sorted(got) == ["K_s0", "frame_id", "search_depths", "src_ids"]
