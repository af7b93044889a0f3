"""The batch upload (utils/device.py::batch_to_device) and its counter
(utils/profiling.py::UPLOAD_BYTES).

- On the CPU: the plain copy, torch.as_tensor(v).to(device), for every key
  but "frame_id_string", with the same dtypes, shapes, strides and bytes;
  the counter adds the batch's bytes under "pageable" and none under
  "pinned".
- The eval loops and the AR app (evaluate_scenes, evaluate_depth,
  run_inference) upload every batch through it: on a tiny synthetic
  dataset the counter grows by exactly the bytes of the batches they
  take.
- On the card (marked cuda, skipped without one): the staged path through
  pinned host memory gives tensors bit-equal to the plain copy, strides
  included, for every key and dtype (the bool mask too, and arrays that
  are dense but not C-contiguous, as the benchmark's traffic has); the
  host arrays may be overwritten as soon as the call returns, while the
  copies from their pinned blocks may still be running (the caching host
  allocator's guard on blocks in flight); the counter reads every byte as
  pinned.
"""

import numpy as np
import pytest
import torch

from implicit_depth_tpu_torch.apps.inference import run_inference
from implicit_depth_tpu_torch.data.mvs_dataset import collate
from implicit_depth_tpu_torch.data.synthetic import SyntheticDataset
from implicit_depth_tpu_torch.eval.depth_eval import evaluate_depth
from implicit_depth_tpu_torch.eval.occlusion_eval import evaluate_scenes
from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.models.depth_net import DepthNet
from implicit_depth_tpu_torch.utils.device import batch_to_device
from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.utils.profiling import UPLOAD_BYTES

CPU = torch.device("cpu")


def _host_batch(height: int = 64, width: int = 96, seed: int = 0) -> tuple:
    """A synthetic BD tuple with its train keys, a frame id to drop, and
    two arrays that are dense but not C-contiguous (a transposed plane
    axis, as traffic.py's rendered depths; a transposed 4x4)."""
    cur, src = synthetic_bd_batch(batch=2, num_src=2, height=height, width=width, num_planes=4,
                                  num_rays=16, samples_per_ray=4, seed=seed)
    cur["frame_id_string"] = np.array(["scene0000_00 0", "scene0000_00 1"])
    cur["rendered_depth"] = np.moveaxis(np.ascontiguousarray(
        np.moveaxis(cur["rendered_depth"], -1, 0)), 0, -1)
    src["K_s1"] = np.ascontiguousarray(src["K_s1"].transpose(3, 2, 1, 0)).transpose(3, 2, 1, 0)
    return cur, src


def _batch_bytes(batch) -> int:
    return sum(v.nbytes for d in batch for k, v in d.items() if k != "frame_id_string")


def _bytes(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.cpu().numpy()).tobytes()


def _assert_same(got: dict, host: dict, device: torch.device) -> None:
    """got holds every key of host but "frame_id_string", each equal to
    the plain copy in dtype, shape, strides and bytes."""
    assert sorted(got) == sorted(k for k in host if k != "frame_id_string")
    for k, v in got.items():
        want = torch.as_tensor(host[k]).to(device)
        assert v.device.type == device.type, k
        assert (v.dtype, v.shape, v.stride()) == (want.dtype, want.shape, want.stride()), k
        assert _bytes(v) == _bytes(want), k


def test_cpu_upload_is_the_plain_copy():
    batch = _host_batch()
    assert not batch[0]["rendered_depth"].flags.c_contiguous
    got = batch_to_device(batch, CPU)
    assert len(got) == 2
    for g, host in zip(got, batch):
        _assert_same(g, host, CPU)
    assert got[0]["mask"].dtype == torch.bool


def test_cpu_upload_counts_pageable_bytes():
    batch = _host_batch()
    before = dict(UPLOAD_BYTES)
    batch_to_device(batch, CPU)
    assert UPLOAD_BYTES["pageable"] - before["pageable"] == _batch_bytes(batch)
    assert UPLOAD_BYTES["pinned"] == before["pinned"]


TINY = dict(image_encoder_name="tiny", num_src_views=2, num_depth_bins=8)


def _run_caller(caller: str, tmp_path) -> list:
    """Runs one caller on the CPU over a tiny synthetic scene (2 tuples of
    3 views at 64x96) with a tiny net at torch's default init; returns the
    host batches it should have uploaded."""
    ds = SyntheticDataset(num_frames=4, num_views=3, split="test",
                          get_bd_info=caller != "evaluate_depth")
    if caller == "run_inference":
        net = BDNet(**TINY).eval()
        run_inference(net, ds, str(tmp_path))
        batches = [collate([ds[i]]) for i in range(len(ds))]
        for cur, _ in batches:  # the rendered depth replaces the dataset's
            cur["rendered_depth"] = np.zeros(cur["depth"].shape[:3] + (1,), np.float32)
        return batches
    if caller == "evaluate_scenes":
        net = BDNet(**TINY).eval()
        evaluate_scenes(net, {"scene0": ds}, batch_size=2)
    else:
        net = DepthNet(**TINY).eval()
        evaluate_depth(net, {"scene0": ds}, batch_size=2)
    return [collate([ds[0], ds[1]])]


@pytest.mark.parametrize("caller", ["evaluate_scenes", "evaluate_depth", "run_inference"])
def test_eval_and_app_callers_upload_through_batch_to_device(caller, tmp_path):
    before = dict(UPLOAD_BYTES)
    batches = _run_caller(caller, tmp_path)
    assert UPLOAD_BYTES["pageable"] - before["pageable"] == sum(map(_batch_bytes, batches))
    assert UPLOAD_BYTES["pinned"] == before["pinned"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the staged upload runs only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_upload_bit_equal_to_the_plain_copy(cuda):
    batch = _host_batch()
    got = batch_to_device(batch, cuda)
    torch.cuda.synchronize()
    for g, host in zip(got, batch):
        _assert_same(g, host, cuda)


@pytest.mark.cuda
def test_cuda_sources_may_be_overwritten_after_the_call(cuda):
    """Tuple A at the flagship's image size uploaded behind ~0.1 s of
    work on the stream, so that its copies have not started when the call
    returns; its arrays overwritten (NaN; the mask flipped) at once, then
    tuple B uploaded: A's tensors on the card hold A's values as they
    were, and B's B's. A pinned block reused before its copy ran would
    hand A the NaNs or B's values."""
    a = _host_batch(384, 512, seed=1)
    saved = tuple({k: v.copy(order="K") for k, v in d.items()} for d in a)
    b = _host_batch(384, 512, seed=2)
    torch.cuda._sleep(200_000_000)
    got_a = batch_to_device(a, cuda)
    for d in a:
        for k, v in d.items():
            if v.dtype == bool:
                v[...] = ~v
            elif v.dtype.kind == "f":
                v[...] = np.nan
    got_b = batch_to_device(b, cuda)
    torch.cuda.synchronize()
    for g, host in zip(got_a, saved):
        _assert_same(g, host, cuda)
    for g, host in zip(got_b, b):
        _assert_same(g, host, cuda)


@pytest.mark.cuda
def test_cuda_upload_counts_pinned_bytes(cuda):
    batch = _host_batch()
    before = dict(UPLOAD_BYTES)
    batch_to_device(batch, cuda)
    torch.cuda.synchronize()
    assert UPLOAD_BYTES["pinned"] - before["pinned"] == _batch_bytes(batch)
    assert UPLOAD_BYTES["pageable"] == before["pageable"]
