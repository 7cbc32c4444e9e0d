"""Host spans at the port's layer boundaries, on the device trace's clock.

``with span("fe.step", step=n) as s: ...`` times its body on
``time.perf_counter_ns`` whatever else runs: ``s.seconds`` is the body's
length, so a caller that reports phase times (``StreamingPipeline.run``'s
``stages``) reads them from its spans, one set of boundaries on one clock.
That is all a span does while no ``torch.profiler`` capture records; the
test is a read of torch's own flag (``torch.autograd.profiler.
_is_profiler_enabled``, a module global that the profiler sets at its start
and clears at its stop), not a ``record_function`` call, which costs tens of
times more.

While a capture records, a span entered also

1. opens ``torch.profiler.record_function("mer." + name)``: a span on the
   capturing thread then lies in the capture's host events beside the
   kernels it launched;
2. appends a :class:`Record` to a bounded list in memory: name, thread,
   start and end on ``perf_counter_ns``, the enclosing span of the same
   thread (``parent``, an index into the list) and ``attrs``, the step or
   batch id and the counts taken at the boundary (:meth:`span.note`).

The profiler sees only the threads it was started on (a Python thread of
the program's own, such as the prefetcher's producer, records no host
event), so the list is what places those threads' spans: the spans that are
also host events give the offset between ``perf_counter_ns`` and the
trace's microseconds (:func:`clock_offset_us`), and the offset places the
rest. ``utils.profiling.trace`` writes the other threads' spans into its
Chrome trace that way.

:func:`spans` returns the list. It is cleared by the first span that finds a
capture recording after a span found none (and by :func:`reset`), so it
holds the latest capture's spans.
"""

from __future__ import annotations

import statistics
import threading
from dataclasses import dataclass, field
from time import perf_counter_ns

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

PREFIX = "mer."
MAX_SPANS = 200_000


@dataclass(slots=True)
class Record:
    """One span recorded during a capture. ``end_ns`` is None while it is
    open; ``parent`` is the index of the enclosing span of the same thread
    in :func:`spans`, or None."""

    name: str
    thread: int  # threading.get_native_id(): the tid a Chrome trace shows
    thread_name: str
    start_ns: int
    end_ns: int | None = None
    parent: int | None = None
    attrs: dict = field(default_factory=dict)


_records: list[Record] = []
_lock = threading.Lock()
_local = threading.local()
_stale = True  # a span found no capture since the list was cleared
dropped = 0  # spans not recorded because the list was full


def spans() -> list[Record]:
    """The spans recorded during the latest capture, in the order they were entered."""
    return list(_records)


def reset() -> None:
    """Empty the list (a new capture starts)."""
    global _stale, dropped
    with _lock:
        _records.clear()
        _stale, dropped = False, 0


class span:
    """A host span (see the module's docstring). ``attrs`` go into the
    record when a capture records; keep them to numbers already at hand."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_range", "_record")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs
        self._range = None  # the record_function range, while a capture records

    def __enter__(self) -> "span":
        global _stale
        self.start_ns = perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self._open()
        else:
            _stale = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end_ns = perf_counter_ns()
        if self._range is not None:
            self._close()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def note(self, **attrs) -> None:
        """Add counts known only inside the span to its record (nothing
        while no capture records)."""
        if self._range is not None and self._record is not None:
            self._record.attrs.update(attrs)

    def _open(self) -> None:
        global _stale, dropped
        self._range = record_function(PREFIX + self.name)
        self._range.__enter__()  # its event starts here, a fixed few microseconds after ``start_ns``
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            if _stale:
                _records.clear()
                _stale, dropped = False, 0
            if len(_records) >= MAX_SPANS:
                dropped += 1
                record = index = None
            else:
                thread = threading.current_thread()
                record = Record(self.name, threading.get_native_id(), thread.name, self.start_ns,
                                parent=stack[-1] if stack else None, attrs=self.attrs)
                index = len(_records)
                _records.append(record)
        stack.append(index)
        self._record = record

    def _close(self) -> None:
        if self._record is not None:
            self._record.end_ns = self.end_ns
        _local.stack.pop()
        self._range.__exit__(None, None, None)


def clock_offset_us(records, events) -> tuple[float, list[float]] | None:
    """The offset that places ``perf_counter_ns`` on a trace's clock:
    ``trace_us = start_ns / 1000 + offset``. ``events``: (name, start in the
    trace's microseconds) of the trace's host events only (a range's copy on
    a card's timeline starts when its kernels do). The spans that are also
    host events (``mer.<name>``) are paired with them name by name in the
    order they started; the offset is the median over the pairs. Returns
    (offset, every pair's offset), or None without a pair."""
    by_name: dict[str, list[float]] = {}
    for name, start_us in events:
        if name.startswith(PREFIX):
            by_name.setdefault(name[len(PREFIX):], []).append(start_us)
    mine: dict[str, list[int]] = {}
    for r in records:
        if r.end_ns is not None and r.name in by_name:
            mine.setdefault(r.name, []).append(r.start_ns)
    pairs = [t - s / 1000.0 for name, starts in mine.items()
             for s, t in zip(sorted(starts), sorted(by_name[name]))]
    return (statistics.median(pairs), pairs) if pairs else None
