"""Driver kind `reg_train_step`: the regression training step (DepthNet
through program.train_step of a `regression` configuration: the forward,
the SimpleRecon loss cocktail, backward, AdamW), driven as `train_step`
drives the BD step (drivers/train_step.py: the same ring, uploads, flips,
set-up, window and first-step records), with three more records of the
CHECKED_STEPS on both sides:

- every term of each step's losses (ms, grad, normals, mv and the logged
  ones), as the step returns them and as the reference's
  regression_losses computes them;
- each batch element's log-L1 at scale 0 in the first step (the mean over
  its valid pixels of |log gt depth - log_depth_pred_0|, the first term of
  the ms loss, element by element), taken by a forward hook from the
  net's inputs and its detached output (no sync inside the step; read
  after the checked steps);
- the norms of the first step's gradient at the matching encoder's
  output, over the source views' rows and over the reference view's: a
  hook on that output. The source views' rows reach the loss only through
  the warp, so that their gradient is what #6 returns; the reference
  view's do not pass #6.

traced() captures with port_bench/spans.py, so that the span readers find
the program's spans joined to the device trace.

numbers() are compare.train_gaps (with the mix's groups; `matching_grad_gap`
is the worst leaf of the matching encoder's first gradient, the only
leaves that #6's gradient reaches, but mixed there with the reference
view's gradient, which does not pass #6) and:
- `src_share_gap`: the relative gap of the ratio of those two norms, #6's
  output against the gradient that bypasses it. On the seeds that the
  grad term carries, the bf16 backward is off in scale as a whole (the
  median leaf's gradient by up to 0.15, #6's output by up to 0.39 on the
  card); the ratio cancels that, and #6 off by a factor still reads that
  factor less 1;
- `<term>1_gap`: each term of the cocktail (ms, grad, normals, mv), the
  first step's relative gap, each held to a limit of its own;
- `loss1_net_grad_gap`: the first step's loss gap net of its grad term's
  gap, |(loss - ref loss) - (grad - ref grad)| over the reference's loss:
  the loss that the step returns, against the sum of its terms. At random
  init the grad term (Sobel gradients of exp(log depth)) can outweigh the
  rest of the loss a millionfold, and then carries the bf16 forward's
  error into the loss (loss1_gap 0.11 on sound seeds); net of it, a loss
  altered by a tenth still reads a tenth. The gap is over the whole loss
  and not over the loss less grad: on such seeds an f32 loss less its grad
  term is a few units of the loss's last place, and one unit reads 0.1 or
  more; each other term's own gap holds that term;
- `elem_l1_gap`: the worst element's relative gap of the first step's
  log-L1; an element that the program did not answer, or answered twice,
  reads inf.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from port_bench import program
from port_bench.drivers import train_step
from port_bench.reference.steps import TrainRecord
from port_bench.spans import capture

CHECKED_STEPS = train_step.CHECKED_STEPS
TRACED_STEPS = train_step.TRACED_STEPS
# the terms of the cocktail ms + grad + normals + 0.2 mv
# (reference/losses.py::regression_losses, scannet)
TERMS = ("ms_loss", "grad_loss", "normals_loss", "mv_loss")


class RegRecord(TrainRecord):
    """A TrainRecord with each checked step's loss terms ({name: float}),
    the first step's log-L1 of each element and the norms of its gradient
    at the source views' and the reference view's matching features."""

    def __init__(self, record: TrainRecord, terms: list, elements: np.ndarray,
                 matching_grads):
        super().__init__(record.losses, record.grad_norms, record.change_norms,
                         record.stat_norms)
        self.terms = list(terms)
        self.elements = np.asarray(elements, np.float64)
        self.src_grad, self.cur_grad = (float(v) for v in matching_grads)


@contextlib.contextmanager
def first_l1(out: list):
    """Keeps in `out` each element's log-L1 at scale 0 of the first
    forward that a DepthNet (program or reference) makes while this is
    open, as a detached (b,) tensor: a hook on every module's forward that
    acts on the first output holding log_depth_pred_0, whose inputs are
    (cur_data, src_data)."""
    def hook(module, args, outputs):
        if not out and isinstance(outputs, dict) and "log_depth_pred_0" in outputs:
            cur = args[0]
            pred = outputs["log_depth_pred_0"].detach().float()
            log_gt = torch.log(torch.where(cur["mask"], cur["depth"].float(), 1.0))
            mask = cur["mask"].to(pred.dtype)
            err = ((log_gt - pred).abs() * mask).sum(dim=(1, 2, 3))
            out.append(err / mask.sum(dim=(1, 2, 3)).clamp_min(1.0))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


@contextlib.contextmanager
def first_matching_grads(out: list, views: int):
    """Keeps in `out` the norms of the gradient at the source views' rows
    and at the reference view's rows of the first output of a matching
    encoder (program or reference; the output is (b·views, C, h, w), the
    reference view first in each group of `views`) that a backward
    reaches while this is open, as a (2,) tensor."""
    def keep(grad):
        if not out:
            g = grad.float().unflatten(0, (-1, views))
            out.append(torch.stack([g[:, 1:].norm(), g[:, 0].norm()]))

    def hook(module, args, output):
        if type(module).__name__ == "ResnetMatchingEncoder" and output.requires_grad:
            output.register_hook(keep)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


@contextlib.contextmanager
def reference_terms(out: list):
    """Keeps every term of each regression_losses the reference computes
    in `out`, one {name: float} a step."""
    from port_bench.reference import losses as ref_losses

    original = ref_losses.regression_losses

    def recorded(*args, **kwargs):
        terms = original(*args, **kwargs)
        out.append({k: float(v.detach()) for k, v in terms.items()})
        return terms

    ref_losses.regression_losses = recorded
    try:
        yield
    finally:
        ref_losses.regression_losses = original


def _rel(got: float, ref: float) -> float:
    return abs(got - ref) / max(abs(ref), 1e-30)


class Driver(train_step.Driver):
    def setup(self) -> None:
        self.terms: list = []
        self.l1: list = []
        self.matching_grads: list = []
        super().setup()
        self.record = RegRecord(self.record, [{k: float(v) for k, v in t.items()}
                                              for t in self.terms],
                                self.l1[0].cpu().numpy(), self.matching_grads[0])

    def firsts(self, l1: list, matching_grads: list) -> contextlib.ExitStack:
        """The hooks that record the first step's log-L1s and the norms of
        its gradient at the matching features."""
        stack = contextlib.ExitStack()
        stack.enter_context(first_l1(l1))
        stack.enter_context(first_matching_grads(matching_grads,
                                                 self.config["model_num_views"]))
        return stack

    def run_step(self) -> None:
        batch = program.batch_to_device(self.batches[self.i % len(self.batches)], self.device)
        first = (self.firsts(self.l1, self.matching_grads) if self.i == 0
                 else contextlib.nullcontext())
        with first:
            losses = self.step(batch, self.flips[self.i])
        self.losses.append(losses["loss"])
        if len(self.terms) < CHECKED_STEPS:
            self.terms.append(losses)
        self.i += 1

    def traced(self) -> tuple:
        return capture(lambda i: self.run_step(), TRACED_STEPS), {}

    def reference_answers(self, fp8: bool = False) -> RegRecord:
        """train_step.Driver's reference record, with the reference's loss
        terms, first log-L1s and gradient norms at the matching features."""
        terms, l1, matching_grads = [], [], []
        with reference_terms(terms), self.firsts(l1, matching_grads):
            record = super().reference_answers(fp8)
        return RegRecord(record, terms, l1[0].cpu().numpy(), matching_grads[0])

    def gaps(self, got: RegRecord, reference: RegRecord) -> dict:
        out = super().gaps(got, reference)
        first, ref = got.terms[0], reference.terms[0]
        for term in TERMS:
            out[f"{term.split('_')[0]}1_gap"] = _rel(first[term], ref[term])
        net = (got.losses[0] - reference.losses[0]) - (first["grad_loss"] - ref["grad_loss"])
        out["loss1_net_grad_gap"] = abs(net) / max(abs(reference.losses[0]), 1e-30)
        out["src_share_gap"] = _rel(got.src_grad / got.cur_grad,
                                    reference.src_grad / reference.cur_grad)
        if got.elements.shape == reference.elements.shape:
            out["elem_l1_gap"] = float(np.max(np.abs(got.elements - reference.elements)
                                              / np.abs(reference.elements)))
        else:
            out["elem_l1_gap"] = float("inf")
        return out
