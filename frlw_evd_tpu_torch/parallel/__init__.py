"""Data-parallel training over torch.distributed and H-sharded TAF steps
(counterpart of frlw_evd_tpu/parallel/): `dist` (the process group, the
batch shards, the group sums), `multihost` (object gather, BatchNorm
statistics sync) and `spatial` (the TAF queue sharded over its rows)."""

from .dist import (init_process_group, rank, shard_batch, world)
from .multihost import gather_objects, sync_batch_stats
from .spatial import (make_spatial_taf_step, make_spatial_taf_step_p64,
                      shard_taf_state, shard_taf_state_p64)

__all__ = ["init_process_group", "rank", "world", "shard_batch",
           "gather_objects", "sync_batch_stats", "make_spatial_taf_step",
           "make_spatial_taf_step_p64", "shard_taf_state",
           "shard_taf_state_p64"]
