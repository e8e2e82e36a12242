"""Scenario parallelism across processes: one process per device.

Port of ``g1_locomotion_tpu/parallel/mesh.py``. The reference lays a 1-D
``('scenario',)`` mesh over its devices and ``shard_map``s the batched
cascade over it; the PyTorch idiom is one process per device under
``torch.distributed``. Every per-scenario cascade is independent, so each
process runs its own contiguous rows of the batch with no collective per
tick; collectives appear only in the sweep statistics' reduction
(:func:`all_reduce_stats`).

Outside ``torch.distributed`` (one process) every helper is the identity.
:func:`distributed_init` takes the card (NCCL) unless the caller names the
CPU (Gloo); it never falls back to the CPU by itself.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from g1_locomotion_tpu_torch._device import require_cuda
from g1_locomotion_tpu_torch.utils import tree

# The collective of each statistic's reduction (the reference's _COLLECTIVES):
# a maximum summed over n processes would report up to n x the true maximum.
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def distributed_init(init_method: str, world_size: int, rank: int,
                     device=None) -> torch.device:
    """Join a job of ``world_size`` processes as process ``rank``
    (``init_method`` e.g. ``tcp://localhost:29500``; nothing tells a process
    of a cluster, so the caller gives all three). ``device=None`` takes card
    ``rank % device_count`` and the NCCL backend; a CPU device the Gloo
    backend. Returns this process's device."""
    if device is None:
        require_cuda()
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size, rank=rank)
    return device


def rank_world() -> Tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) outside
    ``torch.distributed``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def coordination_barrier() -> None:
    """Block until every process of the job reaches this barrier; a no-op in
    one process."""
    if rank_world()[1] > 1:
        dist.barrier()


def row_slice(batch: int, rank: int, world: int) -> slice:
    """Process ``rank``'s contiguous rows of a batch of ``batch``: the first
    ``batch % world`` processes take one row more."""
    base, extra = divmod(batch, world)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (rank < extra))


def shard_rows(batch_tree: Any, rank: int, world: int) -> Any:
    """Process ``rank``'s contiguous rows of a batched tree: a
    ``ScenarioParams`` by its own ``rows`` (shared leaves stay shared), any
    other tree's every leaf by its leading axis."""
    if hasattr(batch_tree, "rows"):
        return batch_tree.rows(row_slice(batch_tree.batch(), rank, world))
    n = tree.leaves(batch_tree)[0].shape[0]
    return tree.map_leaves(lambda x: x[row_slice(n, rank, world)], batch_tree)


def all_reduce_stats(stats: Any, ops: Any) -> Any:
    """Reduce every statistic (a tree of tensors) across the processes, each
    by the collective its leaf in ``ops`` names (``"sum"``, ``"max"`` or
    ``"min"``); the identity in one process."""
    if rank_world()[1] == 1:
        return stats

    def reduce(x: torch.Tensor, op: str) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x, op=_OPS[op])
        return x

    return tree.map_leaves(reduce, stats, ops)
