"""Per-section timing of the dense eval forward on the card (counterpart of
scripts/profile_eval.py).

    python -m implicit_depth_tpu_torch.cli.profile_eval [--batch 1] [--iters 20] \
        [--device cuda]

Times cumulative prefixes of BDNet.forward_val through the trunk's
`stop_at` probe (encoder, matching, volume, cv_encoder, the whole trunk),
then the whole forward, and prints the per-section deltas: the measurement
that orders the work on the eval path. Each probe ends in a scalar (the
sum of its outputs in f32); two synchronised warm-up calls, then `iters`
calls and one synchronisation: the mean per call. Each probe's kernel
launches (#1-#6) over the timed calls are returned with the times.

The model is the flagship BDNet (configs/models/implicit_depth.yaml:
EfficientNetV2-S, ResNet matching, 7 source views, 64 planes, U-Net++) in
eval at bf16 with seeded random weights (weights.init_params, seed 0), on
utils/fixtures.synthetic_bd_batch at 512x384 with 8 query planes, repeated
to --batch. The JAX script's --bf16_matmul has no counterpart: the port's
compute dtype is already bf16. The device defaults to cuda; --device cpu
runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.ops.bounds import launch_counts, reset_launch_counts
from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.utils.profiling import card_name_and_limit, force_sync
from implicit_depth_tpu_torch.weights import init_params

# trunk prefixes (stop_at), then the whole forward; "trunk(decoder)" is stop_at ""
SECTIONS = (("encoder", "encoder"), ("matching", "matching"), ("volume", "volume"),
            ("cv_encoder", "cv_encoder"), ("trunk(decoder)", ""))


def flagship_net(device, feature_volume_type: str = "mlp_feature_volume", seed: int = 0,
                 **net_kwargs) -> BDNet:
    """The flagship BDNet with bf16 compute and seeded random weights, on
    `device` (f32 parameters: cast_to_compute_dtype() for eval)."""
    net = BDNet(compute_dtype=torch.bfloat16, feature_volume_type=feature_volume_type,
                **net_kwargs)
    return init_params(net, torch.Generator().manual_seed(seed)).to(device)


def synthetic_batch(batch: int, device, with_train_keys: bool, **shape) -> tuple:
    """utils/fixtures.synthetic_bd_batch at batch 1 (512x384, 7 source views
    unless `shape` says otherwise), repeated to `batch`, as tensors on
    `device`."""
    dicts = synthetic_bd_batch(batch=1, with_train_keys=with_train_keys, **shape)
    return tuple({k: torch.as_tensor(np.repeat(v, batch, 0)).to(device) for k, v in d.items()}
                 for d in dicts)


def _scalar(out) -> torch.Tensor:
    return sum(x.float().sum() for x in tree_leaves(out) if isinstance(x, torch.Tensor))


def probes(net: BDNet) -> list:
    """[(name, fn(cur, src) -> scalar tensor)]: the cumulative trunk
    prefixes, then forward_val."""
    def section(stop_at):
        return lambda cur, src: _scalar(net.trunk(cur, src, stop_at=stop_at))

    return [(name, section(stop_at)) for name, stop_at in SECTIONS] + [
        ("forward_val", lambda cur, src: _scalar(net.forward_val(cur, src)))]


def time_calls(fn, args: tuple, iters: int, warmup: int = 2) -> tuple:
    """(mean ms, kernel launches #1-#6) of `iters` calls of fn(*args) after
    `warmup` synchronised calls, synchronised once at the end (the JAX
    script's protocol); the launches are those of the timed calls."""
    for _ in range(warmup):
        force_sync(fn(*args))
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    force_sync(out)
    return (time.perf_counter() - t0) / iters * 1000.0, launch_counts()


def profile(net: BDNet, cur: dict, src: dict, iters: int) -> dict:
    """{"ms": {probe: cumulative ms}, "deltas": {probe: ms}, "launches":
    {probe: kernel launches #1-#6 over its `iters` timed calls}, "iters"}
    for an eval-mode net."""
    ms, launches = {}, {}
    with torch.inference_mode():
        for name, fn in probes(net):
            ms[name], launches[name] = time_calls(fn, (cur, src), iters)
    deltas, prev = {}, 0.0
    for name in ms:
        deltas[name] = ms[name] - prev
        prev = ms[name]
    return {"ms": ms, "deltas": deltas, "launches": launches, "iters": iters}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    net = flagship_net(args.device).eval().cast_to_compute_dtype()
    cur, src = synthetic_batch(args.batch, args.device, with_train_keys=False)
    res = profile(net, cur, src, args.iters)
    print(f"card: {card_name_and_limit(args.device)}")
    for name, ms in res["ms"].items():
        print(f"{name:>16}: {ms:8.2f} ms (cumulative)")
    print("\nper-section deltas:")
    for name, ms in res["deltas"].items():
        print(f"{name:>16}: {ms:8.2f} ms  launches #1-#6 per call "
              f"{tuple(n // args.iters for n in res['launches'][name])}")
    print(f"\nbatch={args.batch}  per-frame: {res['ms']['forward_val'] / args.batch:.2f} ms")
    return dict(res, batch=args.batch)


if __name__ == "__main__":
    main()
