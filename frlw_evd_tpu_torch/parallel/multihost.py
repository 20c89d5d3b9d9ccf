"""Multi-process utilities (counterpart of frlw_evd_tpu/parallel/
multihost.py; reference core/yolox/utils/dist.py, allreduce_norm.py):

  * gather_objects   -- every rank's picklable object, in rank order
                        (dist.all_gather_object), for the per-rank
                        validation results that rank 0 evaluates;
  * sync_batch_stats -- the mean over ranks of every BatchNorm running
                        statistic, in place.

With no process group each is the one-process identity.
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist
from torch import nn

from . import dist as pdist


def is_multiprocess() -> bool:
    return pdist.world() > 1


def gather_objects(obj: Any) -> List[Any]:
    """[obj of rank 0, obj of rank 1, ...] on every rank; [obj] with one
    process."""
    if not pdist.initialized():
        return [obj]
    out = [None] * pdist.world()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank src's obj on every rank (obj itself with one process)."""
    if not pdist.initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


_STATS = ("running_mean", "running_var")


@torch.no_grad()
def sync_batch_stats(target):
    """Average every BatchNorm running mean and variance over the ranks,
    in place, and return `target`: a module (its BatchNorm buffers) or a
    state_dict (its keys ending in running_mean / running_var)."""
    if not pdist.initialized():
        return target
    if isinstance(target, nn.Module):
        stats = [t for name, t in target.named_buffers()
                 if name.endswith(_STATS)]
    else:
        stats = [t for name, t in target.items() if name.endswith(_STATS)]
    w = pdist.world()
    for t in stats:
        dist.all_reduce(t)
        t.div_(w)
    return target
