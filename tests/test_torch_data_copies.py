"""The port keeps its own copies of the JAX package's numpy data modules
(config, data/{keyframes,mvs_dataset,synthetic,loader,registry,scannet},
utils/{fixtures,io,native_io}). These tests keep the copies from drifting:
for a fixed seed, both give bit-equal arrays, and both merge the flagship
and synthetic configs to the same Config."""

import dataclasses

import numpy as np
import pytest

from implicit_depth_tpu import config as jconfig
from implicit_depth_tpu.data import keyframes as jkeyframes
from implicit_depth_tpu.data import loader as jloader
from implicit_depth_tpu.data import mvs_dataset as jmvs
from implicit_depth_tpu.data import synthetic as jsynthetic
from implicit_depth_tpu.utils import fixtures as jfixtures
from implicit_depth_tpu_torch import config
from implicit_depth_tpu_torch.data import keyframes, loader, mvs_dataset, registry, synthetic
from implicit_depth_tpu_torch.utils import fixtures

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
