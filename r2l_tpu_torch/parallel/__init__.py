"""Multi-device runs over ``torch.distributed``: one process per device
(NCCL on CUDA cards, gloo on the host), a data x model mesh of process
groups, and the collectives the training steps, frame paths and datagen
use. Counterpart of ``r2l_tpu/parallel``; the JAX package is one SPMD
process whose collectives XLA inserts, the port calls them itself."""
from .dist import init_distributed, spawn_ranks
from .mesh import (Mesh, all_reduce_, apply_r2l_tp, broadcast_value,
                   gather_rows, make_mesh, r2l_param_shardings, replicate_,
                   shard_rows, sharded, sync_grads)

__all__ = ["Mesh", "all_reduce_", "apply_r2l_tp", "broadcast_value",
           "gather_rows", "init_distributed", "make_mesh",
           "r2l_param_shardings", "replicate_", "shard_rows", "sharded",
           "spawn_ranks", "sync_grads"]
