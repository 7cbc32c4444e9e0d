"""Online serving: request queue + dynamic micro-batching (counterpart of
``mer_tpu/serving/online.py``).

- callers ``submit()`` one dialogue (text/audio embedding rows) and get a
  Future;
- a collector thread drains the queue into micro-batches bounded by
  ``max_batch`` dialogues and ``max_wait_ms`` (the batch ships as soon as it
  is full or the oldest request has waited that long);
- each micro-batch is padded to a (batch-bucket, length-bucket) shape, so the
  model sees a handful of shapes;
- per-request latency and batch occupancy are tracked.

One model replica per process; scale-out is replicas behind a router.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from mer_tpu_torch.data.fusion import DEFAULT_LENGTH_BUCKETS, pick_bucket

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


@dataclass
class _Request:
    text: np.ndarray      # [u, d]
    audio: np.ndarray     # [u, d]
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)


class ServerStats:
    """Latency percentiles + batching efficiency (thread-safe snapshot)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latencies_ms: list[float] = []
        self._batch_rows: list[int] = []      # dialogues per batch
        self._real_cells: list[int] = []      # sum of true utterance counts
        self._padded_cells: list[int] = []    # b_bucket * u_bucket

    def record(self, latencies_ms: list[float], rows: int, real_cells: int, padded_cells: int) -> None:
        with self._lock:
            self._latencies_ms.extend(latencies_ms)
            self._batch_rows.append(rows)
            self._real_cells.append(real_cells)
            self._padded_cells.append(padded_cells)

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies_ms, dtype=np.float64)
            n_batches = len(self._batch_rows)
            rows = sum(self._batch_rows)
            real, padded = sum(self._real_cells), sum(self._padded_cells)
        if lat.size == 0:
            return {"requests": 0}
        return {
            "requests": int(lat.size),
            "batches": n_batches,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "latency_ms_max": float(lat.max()),
            "mean_batch_size": rows / max(n_batches, 1),
            # share of the padded [b_bucket, u_bucket] cells doing real work:
            # counts both batch-axis and utterance-length padding
            "occupancy": real / max(padded, 1),
        }


class OnlineServer:
    """Dynamic micro-batching in front of a per-batch predict.

    Args:
        predict_fn: ``(text [b, u, d], audio [b, u, d], padding_mask [b, u])
            -> per-utterance predictions [b, u]``, numpy in and out; called
            on the server's collector thread.
        max_batch: largest micro-batch (dialogues); also the largest batch
            bucket used.
        max_wait_ms: latency budget: a non-full batch ships once its oldest
            request has waited this long.
        length_buckets: utterance-count buckets (the fusion batcher's).
    """

    def __init__(
        self,
        predict_fn: Callable[[Any, Any, Any], Any],
        *,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        length_buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS,
    ):
        self._predict = predict_fn
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._length_buckets = tuple(length_buckets)
        self._batch_buckets = tuple(b for b in DEFAULT_BATCH_BUCKETS if b <= self._max_batch) or (self._max_batch,)
        self._queue: "queue.Queue[_Request | None]" = queue.Queue()
        self.stats = ServerStats()
        self._closed = False
        self._close_lock = threading.Lock()  # orders submit() vs close()
        self._d: int | None = None           # feature dim, fixed by first request
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, text: np.ndarray, audio: np.ndarray) -> Future:
        """One dialogue: [u, d] text + audio embedding rows -> Future of the
        [u] per-utterance predictions."""
        text = np.asarray(text)
        audio = np.asarray(audio)
        if text.ndim != 2 or audio.shape != text.shape:
            raise ValueError(f"expected matching [u, d] rows, got {text.shape} vs {audio.shape}")
        req = _Request(text=text, audio=audio)
        # closed-check and enqueue under one lock: a request can never land
        # behind the shutdown sentinel (whose future would then never resolve)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server closed")
            if self._d is None:
                self._d = int(text.shape[1])
            elif text.shape[1] != self._d:
                raise ValueError(
                    f"feature dim {text.shape[1]} != server's established {self._d} "
                    "(mixed embedding widths would be silently truncated)")
            self._queue.put(req)
        return req.future

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # sentinel unblocks the collector
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- collector ----------------------------------------------------------

    def _collect(self) -> list[_Request] | None:
        """Block for the first request, then drain until full or the oldest
        request's latency budget is spent."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = first.t_submit + self._max_wait_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.perf_counter()
            try:
                # past the deadline, still drain whatever is already queued
                # (backlog: while a batch runs, every waiter ages past the
                # budget; without this the server degenerates to b=1)
                nxt = self._queue.get(timeout=remaining) if remaining > 0 else self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-arm the sentinel for shutdown
                break
            batch.append(nxt)
        return batch

    def _run_batch(self, batch: list[_Request]) -> None:
        b = pick_bucket(len(batch), self._batch_buckets)
        u = pick_bucket(max(r.text.shape[0] for r in batch), self._length_buckets)
        d = batch[0].text.shape[1]
        text = np.zeros((b, u, d), np.float32)
        audio = np.zeros((b, u, d), np.float32)
        mask = np.ones((b, u), bool)  # True = padding (torch convention)
        real = 0
        for i, r in enumerate(batch):
            n = r.text.shape[0]
            text[i, :n] = r.text
            audio[i, :n] = r.audio
            mask[i, :n] = False
            real += n
        # batch-bucket filler rows keep one attendable key so their softmax
        # stays finite (same guard as the offline collate, data/fusion.py)
        mask[len(batch):, 0] = False
        preds = np.asarray(self._predict(text, audio, mask))
        done = time.perf_counter()
        lat = []
        for i, r in enumerate(batch):
            r.future.set_result(preds[i, : r.text.shape[0]])
            lat.append((done - r.t_submit) * 1e3)
        self.stats.record(lat, rows=len(batch), real_cells=real, padded_cells=b * u)

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                # shutdown: fail anything that slipped in around the sentinel
                while True:
                    try:
                        leftover = self._queue.get_nowait()
                    except queue.Empty:
                        return
                    if leftover is not None and not leftover.future.done():
                        leftover.future.set_exception(RuntimeError("server closed"))
            try:
                self._run_batch(batch)
            except Exception as e:  # fail the waiters, keep serving
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)


__all__ = ["OnlineServer", "ServerStats", "DEFAULT_BATCH_BUCKETS"]
