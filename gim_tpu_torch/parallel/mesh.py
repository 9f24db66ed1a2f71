"""Data-parallel training across processes with `torch.distributed`.

Counterpart of `gim_tpu/parallel/mesh.py`. The JAX package replicates the
parameters over a mesh's `data` axis and shards the pair batch; its train
step is one program over the global batch. Here each process holds a
replica of the model and its slice of the batch, and the step is made
equal to the JAX package's step on the global batch.

Whether a step is data-parallel is decided in one place, `in_group()`:
every piece that needs the global batch reads it, so a step under a
process group is the global batch's step whichever entry point drives it.

- BatchNorm: per-channel sums are all-reduced, with their gradient
  (`models/common.batchnorm_train`);
- the losses' normalisers (positive and negative cell counts, valid fine
  slots, the mean inverse std) are summed over the processes by
  `global_sum`, so each process's loss is its share of the global batch's
  loss (`train/losses.py`); the logged loss is the sum of the shares;
- the GT-padding draws are the global batch's, of which each process
  takes its rows (`models/loftr/model.padding_draws`);
- the gradients are *summed* over the processes (`train/loop.backward`):
  the gradient of the global loss is the sum of the gradients of the
  shares.

The gradients are all-reduced explicitly, in one flat buffer after the
backward, not through `DistributedDataParallel`: DDP averages (its
division by the world size would have to be undone), and it issues its
bucket all-reduces during the backward, beside the BatchNorm sums'
all-reduces that the same backward issues; one sum after the backward
keeps every collective in one order on every process.

The process group comes from torchrun's environment (`init_from_env`):
NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def in_group() -> bool:
    """True under a process group (of any size): the step is then the
    global batch's."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def init_from_env(device: torch.device) -> bool:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): NCCL when
    `device` is CUDA (the process takes card LOCAL_RANK as its current
    device, which "cuda" then names), gloo on the CPU.
    Returns False, and joins nothing, outside torchrun."""
    if in_group():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def process_local_pair_slice(n_pairs: int) -> slice:
    """This process's share of a pair list: contiguous blocks of
    ceil(n / world) pairs (the last one shorter)."""
    per = -(-n_pairs // world_size())
    r = rank()
    return slice(r * per, min((r + 1) * per, n_pairs))


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t, detached, summed over the processes (t itself outside a
    group)."""
    t = t.detach()
    if not in_group():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


@torch.no_grad()
def sum_grads_(grads: list[torch.Tensor]) -> None:
    """Sum every process's gradients in place, in one flat all-reduce."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
