"""The program's spans in a traced window, on the device trace's clock.

The port records its spans (``mer_tpu_torch.utils.tracing.spans()``) while
the window's capture runs: name, thread, start and end on
``perf_counter_ns``, the enclosing span and a few counts. A span on the
capturing thread is also a host event of the capture, ``mer.<name>``. The
spans that are both are paired, name by name in the order they started,
and the median of the pairs' offsets places every span, any thread's, on
the trace's microseconds. Device idle gaps and kernel-launch calls are then
put inside or outside spans by host time.

Reads ``Trace.host``, ``Trace._merged`` and ``Trace._launches``; changes
nothing. A program without spans gives no :class:`Spans` (None), and every
reader then returns None.
"""

from __future__ import annotations

import bisect
import importlib
import statistics

PREFIX = "mer."


def program_records() -> list:
    """The program's finished spans of the latest capture; [] for a program
    that records none."""
    try:
        tracing = importlib.import_module("mer_tpu_torch.utils.tracing")
    except ImportError:
        return []
    return [r for r in tracing.spans() if r.end_ns is not None]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


class Spans:
    """The window's spans by name; times in the trace's microseconds."""

    def __init__(self, trace, records: list):
        self.trace = trace
        self.by_name: dict[str, list] = {}
        for r in records:
            self.by_name.setdefault(r.name, []).append(r)
        events: dict[str, list[float]] = {}
        for e in trace.host:
            if e.name.startswith(PREFIX):
                events.setdefault(e.name[len(PREFIX):], []).append(e.time_range.start)
        self.pair_offsets_us = [t - r.start_ns / 1000.0 for name, rs in self.by_name.items() if name in events
                                for r, t in zip(sorted(rs, key=lambda r: r.start_ns), sorted(events[name]))]
        self.offset_us = statistics.median(self.pair_offsets_us) if self.pair_offsets_us else None

    def count(self, name: str) -> int:
        return len(self.by_name.get(name, []))

    def durations_ms(self, name: str) -> list[float]:
        return [(r.end_ns - r.start_ns) * 1e-6 for r in self.by_name.get(name, [])]

    def intervals_us(self, name: str) -> list[tuple[float, float]] | None:
        """The spans' merged intervals on the trace's clock; None where no
        span of the window is a host event of the capture (no offset)."""
        if self.offset_us is None:
            return None
        return _union([(r.start_ns / 1000.0 + self.offset_us, r.end_ns / 1000.0 + self.offset_us)
                       for r in self.by_name.get(name, [])])

    def launches_inside(self, name: str) -> int | None:
        """Kernel-launch calls, any thread's, whose host time falls inside a span ``name``."""
        intervals = self.intervals_us(name)
        if intervals is None:
            return None
        starts = [s for s, _ in intervals]
        n = 0
        for t, _ in self.trace._launches:
            i = bisect.bisect_right(starts, t) - 1
            n += i >= 0 and t <= intervals[i][1]
        return n

    def idle_us(self, name: str) -> tuple[float, float] | None:
        """(idle time of the device whose gap's midpoint lies outside every
        span ``name``, all the idle time between the device's busy
        intervals), in microseconds."""
        intervals = self.intervals_us(name)
        if intervals is None:
            return None
        starts = [s for s, _ in intervals]
        merged = self.trace._merged
        outside = total = 0.0
        for (_, end), (start, _) in zip(merged, merged[1:]):
            if start <= end:
                continue
            mid, gap = end + (start - end) / 2, start - end
            total += gap
            i = bisect.bisect_right(starts, mid) - 1
            if not (i >= 0 and mid <= intervals[i][1]):
                outside += gap
        return outside, total


def of(layers: dict) -> Spans | None:
    """The traced window's spans; None without a trace or without spans."""
    trace = layers.get("trace")
    if trace is None:
        return None
    records = program_records()
    return Spans(trace, records) if records else None
