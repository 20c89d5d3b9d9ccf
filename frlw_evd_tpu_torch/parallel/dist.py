"""Process groups for data-parallel training (counterpart of
frlw_evd_tpu/parallel/mesh.py).

JAX shards the batch over a 1-D `data` mesh axis and lets GSPMD insert the
collectives. The port runs one process a device under torchrun: each rank
holds a contiguous slice of every global batch (`shard_batch`, the slice
that P("data") gives), the BatchNorm statistics and the loss normalisers
are reduced over the group (`all_gather_rows`, `global_sum`), and the step
sums the f32 masters' gradients over the ranks in one bucket
(`all_reduce_grads`). With no group every function here is the identity
of one process: world() is 1 and rank() 0.

JAX's `make_data_mesh` takes the largest device count that divides the
batch (mesh.py:36-41); a torchrun world size is fixed, so `shard_batch`
raises when the batch does not divide by it.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def init_process_group(device="cuda", *, backend=None,
                       timeout_s: float = 600.0) -> torch.device:
    """Join the process group that the torchrun environment names (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): by default NCCL
    with this rank's card cuda:LOCAL_RANK, or gloo when `device` is "cpu";
    backend "gloo" on the card too (ranks that share one card, which NCCL
    refuses). Returns this rank's device; raises where a card is asked
    for and absent."""
    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda is "
                               "not available; pass device='cpu' for gloo")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"init_process_group: unsupported device {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl"
                                            and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev}: nccl needs the "
                         f"card, gloo takes either")
    if not initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def destroy_process_group() -> None:
    if initialized():
        dist.destroy_process_group()


def rows(n: int) -> tuple[int, int]:
    """This rank's contiguous rows [r·n/W, (r+1)·n/W) of a batch of n;
    raises unless W divides n."""
    w, r = world(), rank()
    if n % w:
        raise ValueError(f"a batch of {n} rows does not shard over "
                         f"{w} ranks; make the batch a multiple of the "
                         f"world size")
    return r * n // w, (r + 1) * n // w


def shard_batch(batch):
    """This rank's `rows` of every leading axis in `batch` (a tensor, an
    array, or a tuple / list of them); the batch itself with no group."""
    if world() == 1:
        return batch
    if isinstance(batch, (tuple, list)):
        lo, hi = rows(len(batch[0]))
        return type(batch)(v[lo:hi] for v in batch)
    lo, hi = rows(len(batch))
    return batch[lo:hi]


@torch.no_grad()
def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(world, *x.shape): every rank's x, in rank order (x[None] with no
    group)."""
    if not initialized():
        return x[None]
    if dist.get_backend() == "nccl":
        out = x.new_empty((world(), *x.shape))
        dist.all_gather_into_tensor(out, x.contiguous())
        return out
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


@torch.no_grad()
def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a detached value over the group, as a new tensor (x
    detached with no group): a loss normaliser of the global batch."""
    x = x.detach()
    if not initialized():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """Sum every parameter's .grad over the group in place, as one
    all-reduce of one flat buffer (the gradients of the ranks' shares of
    a loss normalised by the global batch add up to the global
    gradient)."""
    if not initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
