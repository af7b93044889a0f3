"""Times the BD training step on the card (counterpart of
scripts/bench_train.py): the first step's wall time and loss, then ms per
step, ms per sample and samples/s over --iters steps.

    python -m implicit_depth_tpu_torch.cli.bench_train [--batch 1] [--iters 10] \
        [--device cuda]

The step is train/state.py::make_bd_train_step on the flagship BDNet (bf16
autocast, f32 parameters, seeded random weights) with AdamW, on
utils/fixtures.synthetic_bd_batch at 512x384 (4096 rays of 64 samples)
repeated to --batch (the reference trains at 12). The first step includes
the nvcc build of the kernels on a cold build cache. After it, one more
step, then --iters steps and one synchronisation.

The JAX script's two other flags are not ported, and argparse refuses
them: --remat (rematerialising the volume: the port's volume kernels carry
their own backward, which recomputes what it needs), and --no_pallas (it
would run the kernels' plain versions on the card, which the port never
does: on a CUDA tensor a wrapper launches its kernel or raises). The device
defaults to cuda; --device cpu runs the plain versions.
"""

from __future__ import annotations

import argparse
import time

import torch

from implicit_depth_tpu_torch.cli.profile_eval import flagship_net, synthetic_batch, time_calls
from implicit_depth_tpu_torch.train import state as state_lib
from implicit_depth_tpu_torch.utils.profiling import card_name_and_limit, force_sync


def bench(net, batch: tuple, iters: int) -> dict:
    """{"first_step_s", "first_loss", "ms", "loss", "launches"} of the BD
    train step on `net` and `batch`: the first step, then `iters` steps
    after one more (launches #1-#6 of the timed steps)."""
    opt, sched = state_lib.make_optimizer(net.parameters())
    step = state_lib.make_bd_train_step(net, opt, sched,
                                        generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    losses = step(batch)
    force_sync(losses)
    first_s = time.perf_counter() - t0
    first_loss = float(losses["loss"])
    last = {}

    def timed(b):
        last.update(step(b))
        return last["loss"]

    ms, launches = time_calls(timed, (batch,), iters, warmup=1)
    return {"first_step_s": first_s, "first_loss": first_loss, "ms": ms,
            "loss": float(last["loss"]), "launches": launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    net = flagship_net(args.device)
    batch = synthetic_batch(args.batch, args.device, with_train_keys=True)
    res = bench(net, batch, args.iters)
    print(f"card: {card_name_and_limit(args.device)}")
    print(f"first step: {res['first_step_s']:.1f} s loss={res['first_loss']:.4f}")
    ms = res["ms"]
    print(f"batch={args.batch}: {ms:.1f} ms/step = {ms / args.batch:.1f} ms/sample "
          f"({1000 * args.batch / ms:.2f} samples/s), loss={res['loss']:.4f}, launches #1-#6 "
          f"per step {tuple(n // args.iters for n in res['launches'])}")
    return dict(res, batch=args.batch)


if __name__ == "__main__":
    main()
