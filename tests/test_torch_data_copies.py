"""The port keeps its own copies of the JAX package's numpy data modules
(config, data/{keyframes,mvs_dataset,synthetic,loader,registry,scannet},
utils/{caching,fixtures,io,native_io,visualization}, train/logging, and the
.ckpt converters of train/checkpoint.py). These tests keep the copies from
drifting: for a fixed seed, both give bit-equal arrays, both merge the
flagship and synthetic configs to the same Config, a frame cached by one
loads bit-equal from the other's files, both converters give bit-equal
trees from one reference state_dict, both visualisations bit-equal images
and both code snapshots the same files; the registries resolve the same
names. tests/test_torch_datasets.py holds the capture loaders and tuple
generation to theirs."""

import dataclasses
import json
import os

import numpy as np
import pytest

from implicit_depth_tpu import config as jconfig
from implicit_depth_tpu.data import keyframes as jkeyframes
from implicit_depth_tpu.data import loader as jloader
from implicit_depth_tpu.data import mvs_dataset as jmvs
from implicit_depth_tpu.data import registry as jregistry
from implicit_depth_tpu.data import synthetic as jsynthetic
from implicit_depth_tpu.train import checkpoint as jcheckpoint
from implicit_depth_tpu.train import logging as jlogging
from implicit_depth_tpu.utils import caching as jcaching
from implicit_depth_tpu.utils import fixtures as jfixtures
from implicit_depth_tpu.utils import visualization as jvisualization
from implicit_depth_tpu_torch import config
from implicit_depth_tpu_torch.data import keyframes, loader, mvs_dataset, registry, synthetic
from implicit_depth_tpu_torch.train import checkpoint
from implicit_depth_tpu_torch.train import logging as port_logging
from implicit_depth_tpu_torch.utils import caching, fixtures, visualization

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


@pytest.mark.parametrize("fields", [{}, {"name": "x", "lr": 5e-4, "image_encoder_name": "tiny",
                                         "lr_steps": [3, 9], "use_prior": True}],
                         ids=["defaults", "changed"])
def test_save_config_writes_the_same_bytes(tmp_path, fields):
    """save_config's YAML equals the JAX package's byte for byte, and the
    JAX package's round trip (tests/test_config.py) holds on the port."""
    jpath, path = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    jconfig.save_config(jconfig.Config(**fields), jpath)
    config.save_config(config.Config(**fields), path)
    with open(jpath, "rb") as jf, open(path, "rb") as f:
        assert f.read() == jf.read()
    loaded = config.merge_dict(config.Config(), config.load_yaml_options(path))
    assert dataclasses.asdict(loaded) == dataclasses.asdict(config.Config(**fields))


def test_registry_names_what_is_not_copied():
    """Every name the JAX registry resolves resolves in the port to the
    port's copy of that class (the same name, in the port's module of the
    same path); an unknown name still raises ValueError in both."""
    names = ("scannet", "synthetic", "hypersim", "vdr", "7scenes", "sevenscenes", "colmap",
             "arkit", "scanniverse", "ScanNet")
    for name in names:
        jcls, _ = jregistry.get_dataset(name)
        cls, _ = registry.get_dataset(name)
        assert cls.__name__ == jcls.__name__
        assert cls.__module__ == jcls.__module__.replace("implicit_depth_tpu.",
                                                         "implicit_depth_tpu_torch.")
    assert registry.get_dataset("synthetic")[0] is synthetic.SyntheticDataset
    assert registry.get_dataset("vdr", None, "cap0")[1] == ["cap0"]
    for get in (jregistry.get_dataset, registry.get_dataset):
        with pytest.raises(ValueError):
            get("no_such_dataset")


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


@pytest.mark.parametrize("family", ["bd", "depth"])
def test_converters_bit_equal(family):
    """Both copies of convert_reference_{bd,depth}_checkpoint (and with
    them every convert_* and split_bn) map one reference-layout state_dict
    to bit-equal (params, batch_stats) trees; so do both convert_resnet18d
    on a timm resnet18d layout."""
    import jax

    from implicit_depth_tpu.models.bd_net import BDNet as JBDNet
    from implicit_depth_tpu.models.depth_net import DepthNet as JDepthNet
    from tests.test_timm_conversion import ResNet18DTwin
    from tests.torch_parity import reference_state_dict_from_flax, seeded_variables, to_numpy_tree

    cur, src = jfixtures.synthetic_bd_batch(batch=1, num_src=2, height=64, width=96,
                                            num_planes=3, num_rays=16, samples_per_ray=8, seed=0)
    if family == "bd":
        jnet, init_kwargs = JBDNet(num_src_views=2, num_depth_bins=8, train_bn=True), {"flip": False}
        fns = (checkpoint.convert_reference_bd_checkpoint,
               jcheckpoint.convert_reference_bd_checkpoint)
    else:
        jnet, init_kwargs = JDepthNet(num_src_views=2, num_depth_bins=8, train_bn=True), {}
        fns = (checkpoint.convert_reference_depth_checkpoint,
               jcheckpoint.convert_reference_depth_checkpoint)
    variables = to_numpy_tree(seeded_variables(
        lambda key, c, s: jnet.init({"params": key}, c, s, **init_kwargs), cur, src, seed=4))
    sd = reference_state_dict_from_flax(variables)
    _assert_tree_equal(fns[0](sd), fns[1](sd))
    resnet = {f"encoder.{k}": v for k, v in ResNet18DTwin().state_dict().items()}
    _assert_tree_equal(checkpoint.split_bn(checkpoint.convert_image_encoder(resnet)),
                       jcheckpoint.split_bn(jcheckpoint.convert_image_encoder(resnet)))
    assert jax.tree_util.tree_leaves(variables)


def test_visualization_bit_equal(tmp_path):
    rng = np.random.RandomState(2)
    depth = rng.uniform(0.5, 5.0, (24, 32)).astype(np.float32)
    depth[3, :5] = np.nan
    mask = rng.rand(24, 32) > 0.3
    image = rng.rand(24, 32, 3).astype(np.float32)
    pairs = [
        (visualization.colormap_image(depth), jvisualization.colormap_image(depth)),
        (visualization.colormap_image(depth, mask, vmin=1.0, vmax=4.0, colormap="viridis"),
         jvisualization.colormap_image(depth, mask, vmin=1.0, vmax=4.0, colormap="viridis")),
        (visualization.prepare_image_for_logging(depth),
         jvisualization.prepare_image_for_logging(depth)),
        (visualization.prepare_image_for_logging(image, normalize=False),
         jvisualization.prepare_image_for_logging(image, normalize=False)),
        (visualization.normalize_depth(depth, mask), jvisualization.normalize_depth(depth, mask)),
        (visualization.normalize_depth(depth, robust=True),
         jvisualization.normalize_depth(depth, robust=True)),
    ]
    for got, ref in pairs:
        np.testing.assert_array_equal(got, ref)
    visualization.save_image(str(tmp_path / "port.png"), image)
    jvisualization.save_image(str(tmp_path / "jax.png"), image)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_logger_and_code_snapshot_copies_agree(tmp_path):
    root = tmp_path / "src"
    (root / "pkg" / "build").mkdir(parents=True)
    (root / ".gitignore").write_text("# comment\npkg/build/\n*.tmp\n")
    for rel in ("a.py", "pkg/b.py", "pkg/c.tmp", "pkg/build/d.so", "e.msgpack"):
        (root / rel).write_text(rel)
    trees = []
    for mod, name in ((port_logging, "port"), (jlogging, "jax")):
        dest = tmp_path / f"snap_{name}"
        mod.copy_code_state(str(dest), root=str(root))
        trees.append(sorted(os.path.relpath(os.path.join(d, f), dest)
                            for d, _, fs in os.walk(dest) for f in fs))
        logger = mod.ExperimentLogger(str(tmp_path / "logs"), name, use_tensorboard=False)
        logger.log_scalars(3, {"a": np.float32(0.5), "b": 2})
        logger.close()
    assert trees[0] == trees[1] == [".gitignore", "a.py", "pkg/b.py"]
    rows = [json.loads((tmp_path / "logs" / n / "metrics.jsonl").read_text()) for n in ("port", "jax")]
    assert [{k: v for k, v in r.items() if k != "time"} for r in rows] == [
        {"step": 3, "a": 0.5, "b": 2.0}] * 2
