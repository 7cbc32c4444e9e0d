"""Process-indexed data sharding (counterpart of ``mer_tpu/data/process_sharding.py``).

On a TPU pod each *process* is a host that feeds its own devices; every host
builds the identical global batch list (seeded, never global RNG state) and
takes the round-robin slice ``batches[index::count]``. The port runs one
process per card, so ``mer_tpu``'s process is a torch **node** (a host of
``torchrun``'s ``LOCAL_WORLD_SIZE`` ranks): the ranks of one node share one
batch list and split its rows among themselves (``parallel/mesh.py``'s
``dp_row_shard``), as a TPU host's devices split the host's batch, and only
the nodes take round-robin slices. Were every rank a process here, dp and
the round-robin would shard the data twice.
"""

from __future__ import annotations

import os
from typing import Sequence, TypeVar

import torch.distributed as dist

T = TypeVar("T")


def resolve_process(process_index: int | None, process_count: int | None) -> tuple[int, int]:
    """(node rank, node count), each taken from the argument when given.
    Without an initialized process group the answer is (0, 1); with one it
    is the group's: ``torchrun``'s ``GROUP_RANK`` (else rank //
    ``LOCAL_WORLD_SIZE``) and world size // ``LOCAL_WORLD_SIZE`` (a group
    without ``LOCAL_WORLD_SIZE`` is one node). Out-of-range values raise."""
    if process_index is None or process_count is None:
        if dist.is_initialized():
            world = dist.get_world_size()
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            nodes, node = world // local, int(os.environ.get("GROUP_RANK", dist.get_rank() // local))
        else:
            nodes, node = 1, 0
        process_count = nodes if process_count is None else process_count
        process_index = node if process_index is None else process_index
    process_index, process_count = int(process_index), int(process_count)
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range for {process_count} processes")
    return process_index, process_count


def shard_batches(batches: Sequence[T], process_index: int, process_count: int) -> list[T]:
    """This node's round-robin slice of the global batch list."""
    return list(batches[process_index::process_count])


def local_num_batches(global_batches: int, process_index: int, process_count: int) -> int:
    """``len(shard_batches(range(global_batches), ...))`` without building it."""
    return (global_batches - process_index + process_count - 1) // process_count
