"""Multi-process data parallelism, counterpart of
implicit_depth_tpu/parallel/distributed.py, on torch.distributed.

The JAX package joins a jax.distributed cluster, and one global mesh spans
every process's chips: a step on a batch sharded over the processes is one
logical step on the whole (global) batch, XLA inserting the reductions.
The port keeps that contract with one process per device:

- `initialize` forms the process group over tcp:// (nccl for a CUDA
  device, gloo for the CPU, or the backend asked for) and a gloo group for
  `barrier`;
- each process loads its own rows of every global batch
  (`BatchLoader(shard_id=rank, num_shards=world)`);
- every reduction over the batch in a step is global: `global_sum`, a
  differentiable all-reduce, carries batch norm's statistics
  (models/matching.py::BatchNorm, train mode) and the losses' sums
  (train/losses.py), so that every rank computes the loss of the global
  batch;
- `average_gradients` then averages the parameters' gradients over the
  ranks. The all-reduce's backward sums the incoming gradient over the
  ranks, so each rank holds world x its share of the global gradient, and
  their average is the global gradient.

Without a process group (or with one process) every function here is the
identity or a no-op. `mesh.py` and `sharded_warp.py` have no counterpart: a
process holds one device.

Launching N processes: run the same command N times, each with
`--jax_distributed --coordinator_address HOST:PORT
--distributed_num_processes N --distributed_process_id r`.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Iterable, Optional

import torch
import torch.distributed as dist

# the gloo group that barrier() waits on, made by initialize(): with nccl as
# the default backend a barrier there would be a device collective
_BARRIER_GROUP: dict = {}


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device: str = "cuda",
               timeout_s: int = 1800) -> None:
    """Joins (or forms) the process group of `num_processes` ranks at
    `coordinator_address` ("host:port" or "tcp://host:port"). backend None
    takes nccl for a CUDA `device` (one rank per card: nccl refuses two
    ranks on one card at its first collective) and gloo otherwise; gloo's
    all-reduce also takes CUDA tensors, through the host. A second call is
    a no-op."""
    if dist.is_initialized():
        return
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("--jax_distributed needs --coordinator_address, "
                         "--distributed_num_processes and --distributed_process_id")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _BARRIER_GROUP["group"] = (dist.group.WORLD if backend == "gloo"
                               else dist.new_group(backend="gloo", timeout=timeout))


def shutdown() -> None:
    """Leaves the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _BARRIER_GROUP.clear()


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_parallel() -> bool:
    """True in a process group of more than one rank."""
    return process_info()[1] > 1


def local_device(device: str) -> torch.device:
    """The device of this rank: cuda:{rank % device_count} for a CUDA
    `device`, else `device` itself."""
    dev = torch.device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def barrier(name: str, timeout_s: int = 900) -> None:
    """Waits until every rank has reached the barrier `name`, for at most
    timeout_s seconds (then raises). It runs on a gloo group, never on the
    device, so ranks may arrive minutes apart (the JAX package waits on
    its coordination service for the same reason). No-op in one process."""
    if not data_parallel():
        return
    try:
        dist.monitored_barrier(group=_BARRIER_GROUP["group"], timeout=timedelta(seconds=timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed: {e}") from e


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks (differentiable); t itself in one process.
    Every rank must call it, in the same order."""
    return _AllReduceSum.apply(t) if data_parallel() else t


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replaces each parameter's gradient by its mean over the ranks (one
    all-reduce of all of them); no-op in one process."""
    if not data_parallel():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for g, avg in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(avg)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors of one shape concatenated in rank order (the
    global batch's rows), on every rank; t itself in one process. Not
    differentiable. gloo gathers host tensors only, so there t goes through
    the host."""
    if not data_parallel():
        return t
    src = (t if dist.get_backend() == "nccl" else t.cpu()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def rank_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch (the global
    batch is the ranks' batches in rank order)."""
    rank, world = process_info()
    rows = t.shape[0] // world
    return t[rank * rows:(rank + 1) * rows]
