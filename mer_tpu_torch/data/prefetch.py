"""Double-buffered host -> device input pipeline (counterpart of
``mer_tpu/data/prefetch.py``).

A producer thread runs the host batcher and moves each batch (a dict of
numpy arrays) to the device while the consumer computes on the one before.
On a CUDA device every array is copied into pinned host memory, then to the
device with ``non_blocking=True`` on a side stream, and an event marks the
end of the batch's copies. The consumer makes its current stream wait on that
event and calls ``record_stream`` on the batch's tensors, so the caching
allocator does not hand their memory back to the side stream while the
compute stream still reads it. The pinned buffers form a ring of
``buffer_size + 2`` slots; a slot is refilled only after the event of its
last copy has completed. On the CPU the same thread hands over plain tensors,
without streams.

A producer exception reaches the consumer after the batches made before it.

Spans (``utils/tracing.py``): ``prefetch.host`` (the producer pulling the
next host batch) and ``prefetch.h2d`` (``_to_device``: the slot's wait, the
pinned staging and the copies issued; ``bytes``) on the producer thread,
``stream.wait`` (the consumer waiting for a batch) on the consumer's. After
an iteration, ``host_s`` and ``h2d_bytes`` hold its producer spans' seconds
and bytes.

``sharding`` places each batch across the dp axis of a mesh, as
``mer_tpu``'s ``jax.device_put`` onto a batch sharding does: a ``(group,
dp_rank)`` pair (the dp process group, None for one rank, and this rank's
place in it), with which the producer keeps the rank's rows of the batch
(``parallel/mesh.py``'s ``dp_row_shard``: padded to a multiple of the group's
size as ``pad_batch_to_dp`` pads) and copies only those to the device.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from mer_tpu_torch.parallel.mesh import dp_row_shard
from mer_tpu_torch.utils.tracing import span


class _PinnedSlot:
    """Pinned host buffers for one batch in flight, and the event of their last copy."""

    def __init__(self):
        self.buffers: dict[str, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None

    def stage(self, key: str, array: np.ndarray) -> torch.Tensor:
        """``array`` copied into this slot's pinned buffer for ``key`` (grown as needed)."""
        array = np.ascontiguousarray(array)
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < array.nbytes:
            buf = self.buffers[key] = torch.empty(max(array.nbytes, 1), dtype=torch.uint8, pin_memory=True)
        view = buf[: array.nbytes].view(torch.from_numpy(array[:0].reshape(-1)).dtype).view(array.shape)
        view.numpy()[...] = array
        return view


class DevicePrefetcher:
    """Wrap an iterable of host batches (dicts of numpy arrays); yield the
    same dicts with torch tensors on ``device``.

    Args:
        batches: the host batches.
        device: where the tensors land.
        sharding: None, or ``(dp group, dp rank)``: yield this rank's row
            shard of each batch.
        buffer_size: batches the producer may run ahead (2: double buffering).
    """

    def __init__(self, batches: Iterable[dict], device: torch.device | str = "cuda", sharding=None,
                 buffer_size: int = 2):
        if sharding is not None:
            group, rank = sharding
            size = dist.get_world_size(group) if group is not None else 1
            if not 0 <= rank < size:
                raise ValueError(f"sharding: dp rank {rank} outside a group of {size}")
            batches = (dp_row_shard(batch, size, rank) for batch in batches)
        self._batches = batches
        self.device = torch.device(device)
        self._buffer_size = max(1, buffer_size)

    def _to_device(self, batch: dict, slot: _PinnedSlot | None, stream) -> tuple[dict, object]:
        if slot is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, None
        if slot.event is not None:
            slot.event.synchronize()  # the slot's last copies have left its buffers
        out = {}
        with torch.cuda.stream(stream):
            for key, array in batch.items():
                out[key] = slot.stage(key, array).to(self.device, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(stream)
        return out, slot.event

    def __iter__(self) -> Iterator[dict]:
        on_card = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if on_card else None
        slots = [_PinnedSlot() for _ in range(self._buffer_size + 2)] if on_card else None
        q: queue.Queue = queue.Queue(maxsize=self._buffer_size)
        sentinel = object()
        error: list[BaseException] = []
        stop = threading.Event()
        self.host_s, self.h2d_bytes = 0.0, 0

        def producer() -> None:
            try:
                batches = iter(self._batches)
                for i in itertools.count():
                    with span("prefetch.host", batch=i) as pulled:
                        batch = next(batches, sentinel)
                    self.host_s += pulled.seconds
                    if batch is sentinel or stop.is_set():
                        return
                    nbytes = sum(np.asarray(v).nbytes for v in batch.values())
                    with span("prefetch.h2d", batch=i, bytes=nbytes):
                        item = self._to_device(batch, slots[i % len(slots)] if on_card else None, stream)
                    self.h2d_bytes += nbytes
                    q.put(item)
            except BaseException as e:  # reaches the consumer after the batches before it
                error.append(e)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            for i in itertools.count():
                with span("stream.wait", batch=i):
                    item = q.get()
                if item is sentinel:
                    break
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for t in batch.values():
                        t.record_stream(current)
                yield batch
        finally:
            stop.set()
            while thread.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()
        if error:
            raise error[0]


def prefetch(batches: Iterable[dict], device: torch.device | str = "cuda", sharding=None,
             buffer_size: int = 2) -> Iterator[dict]:
    return iter(DevicePrefetcher(batches, device=device, sharding=sharding, buffer_size=buffer_size))
