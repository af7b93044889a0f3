"""Per-section profile of the BD training step on the card (counterpart of
scripts/profile_train.py).

    python -m implicit_depth_tpu_torch.cli.profile_train [--batch 12] [--iters 8] \
        [--json] [--device cuda]

Four probes, each on a fresh flagship BDNet (bf16 autocast, f32
parameters, seeded random weights) and a fresh AdamW, freed before the
next, on utils/fixtures.synthetic_bd_batch at 512x384 (4096 rays of 64
samples) repeated to --batch:

  full        - train/state.py::make_bd_train_step (forward, backward, AdamW)
  fwd_only    - the same step with forward_only=True: its loss path, no
                backward and no update
  zero_volume - the full step with feature_volume_type=zero_cost_volume
                (encoders, decoder and heads forward and backward, no volume)
  trunk_zero  - the zero-volume trunk with a surrogate loss, the mean square
                of the decoder features, backward and AdamW (no ray head)

and the derived sections:

  volume block (f+b)    = full - zero_volume
  bwd + update          = full - fwd_only
  ray head + loss (f+b) = zero_volume - trunk_zero

Each probe: one synchronised step, then `iters` steps and one
synchronisation: the mean per step, with the kernel launches (#1-#6) of the
timed steps. --json adds one JSON line. The JAX script's --remat has no
counterpart: rematerialising the volume is not ported (the kernels' custom
backward recomputes it already). The device defaults to cuda; --device cpu
runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable

import torch

from implicit_depth_tpu_torch.cli.profile_eval import flagship_net, synthetic_batch, time_calls
from implicit_depth_tpu_torch.train import state as state_lib
from implicit_depth_tpu_torch.utils.profiling import card_name_and_limit

PROBES = ("full", "fwd_only", "zero_volume", "trunk_zero")
ZERO = "zero_cost_volume"


def trunk_zero_step(net, optimizer, scheduler=None) -> Callable:
    """step(batch) -> {"loss"}: the trunk (no flip, batch norm in train
    mode) under the net's autocast, the surrogate loss sum over scales of
    mean(features^2) in f32, backward, AdamW step."""
    def step(batch) -> dict:
        cur, src = batch
        net.train()
        cdt = net.compute_dtype
        dev = cur["image"].device.type
        with torch.autocast(dev, dtype=cdt, enabled=cdt != torch.float32):
            feats = net.trunk(cur, src)["features"]
        loss = sum(torch.mean(torch.square(f.float())) for f in feats.values())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state_lib.fill_missing_grads(net.parameters())
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {"loss": loss.detach()}

    return step


def make_probe(name: str, build_net: Callable) -> tuple:
    """(net, step) of one probe, on a fresh net from build_net(volume type)
    and a fresh AdamW; the flip and the prior's draws from generator seed 0."""
    net = build_net(ZERO if name in ("zero_volume", "trunk_zero") else "mlp_feature_volume")
    opt, sched = state_lib.make_optimizer(net.parameters())
    if name == "trunk_zero":
        return net, trunk_zero_step(net, opt, sched)
    step = state_lib.make_bd_train_step(net, opt, sched, forward_only=name == "fwd_only",
                                        generator=torch.Generator().manual_seed(0))
    return net, step


def profile(batch: tuple, iters: int, build_net: Callable, probes=PROBES) -> dict:
    """{"ms": {probe: mean ms per step}, "launches": {probe: launches #1-#6
    over its `iters` timed steps}, "iters"}; build_net(feature_volume_type)
    makes each probe's fresh net on the batch's device."""
    ms, launches = {}, {}
    for name in probes:
        net, step = make_probe(name, build_net)
        ms[name], launches[name] = time_calls(step, (batch,), iters, warmup=1)
        del net, step
        if batch[0]["image"].is_cuda:
            torch.cuda.empty_cache()
    return {"ms": ms, "launches": launches, "iters": iters}


def derived(ms: dict) -> dict:
    return {"volume block (f+b)": ms["full"] - ms["zero_volume"],
            "bwd + update": ms["full"] - ms["fwd_only"],
            "conv stacks (f+b)": ms["zero_volume"],
            "ray head + loss (f+b)": ms["zero_volume"] - ms["trunk_zero"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--json", action="store_true", help="also print a JSON line")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    batch = synthetic_batch(args.batch, args.device, with_train_keys=True)
    card = card_name_and_limit(args.device)
    print(f"card: {card}", flush=True)
    res = profile(batch, args.iters, lambda volume: flagship_net(args.device, volume))
    for name, ms in res["ms"].items():
        print(f"{name:>22}: {ms:8.1f} ms  launches #1-#6 per step "
              f"{tuple(n // args.iters for n in res['launches'][name])}", flush=True)
    sections = derived(res["ms"])
    print("\nderived sections:")
    for name, ms in sections.items():
        print(f"{name:>22}: {ms:8.1f} ms" + ("  (incl. heads)" if "conv" in name else ""))
    full = res["ms"]["full"]
    print(f"\nbatch={args.batch}: {full:.1f} ms/step = {full / args.batch:.1f} ms/sample "
          f"({1000 * args.batch / full:.1f} samples/s)")
    if args.json:
        print(json.dumps({"batch": args.batch, **res["ms"], "launches": res["launches"],
                          "iters": args.iters, "card": card}))
    return dict(res, batch=args.batch, sections=sections, card=card)


if __name__ == "__main__":
    main()
