"""A ``torch.profiler`` capture of the window, reduced to what the metrics'
readers need: the device's busy time, the device time of the kernels
launched inside named host ranges, the top device operations and the idle
gaps by what the host was doing.

A kernel belongs to the host range its launch call ran in: the runtime
call (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ...) lies inside the
range on the host's clock, and the kernel carries the call's CUPTI
correlation. So a roofline reads every kernel an op's call launched,
whatever the kernels' names and however they were launched (through torch
or through ``ctypes``). Copies and fills are not launches.
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict
from typing import Callable


@contextlib.contextmanager
def capture(enabled: bool):
    """Profile the body (host ops and CUDA activity) when ``enabled``;
    yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def _is_device(event) -> bool:
    return getattr(event.device_type, "name", str(event.device_type)) == "CUDA"


def _union_us(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """(total length, merged intervals) of sorted [start, end) pairs."""
    merged: list[list[float]] = []
    for start, end in intervals:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


class Trace:
    """The reduced capture. Times in seconds; ``window_s`` is the host
    clock's length of the traced window."""

    def __init__(self, prof, window_s: float):
        events = list(prof.events())
        self.host = [e for e in events if not _is_device(e)]
        host_names = {e.name for e in self.host}
        # a host range's copy on the device timeline (a user annotation) is no device operation
        device = [e for e in events if _is_device(e) and e.name not in host_names]
        spans = sorted((e.time_range.start, e.time_range.end) for e in device)
        busy_us, self._merged = _union_us(spans)
        self.busy_s = busy_us * 1e-6
        self.window_s = float(window_s)
        by_name: dict[str, float] = defaultdict(float)
        self._device_us: dict[int, float] = defaultdict(float)  # CUPTI correlation -> device microseconds
        for e in device:
            by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
            self._device_us[e.id] += e.time_range.end - e.time_range.start
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        # the runtime calls that launched kernels: host time, CUPTI correlation
        self._launches = sorted((e.time_range.start, e.id) for e in self.host if "LaunchKernel" in e.name)
        self.kernel_s = sum(self._device_us.values()) * 1e-6
        self.launched_s = sum(self._device_us.get(c, 0.0) for _, c in self._launches) * 1e-6

    def range_device_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the kernels whose launch call ran inside a host
        range whose name ``match`` accepts (nested ranges count once). A
        launch belongs to the range by host time, its kernel by the CUPTI
        correlation of the two."""
        _, ranges = _union_us(sorted((e.time_range.start, e.time_range.end) for e in self.host if match(e.name)))
        total, i = 0.0, 0
        for start, corr in self._launches:
            while i < len(ranges) and ranges[i][1] < start:
                i += 1
            if i == len(ranges):
                break
            if ranges[i][0] <= start:
                total += self._device_us.get(corr, 0.0)
        return total * 1e-6

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle gaps, summed by the innermost host op that was
        running at each gap's middle; the ``top`` largest, in seconds."""
        gaps = [(s1 + (s2 - s1) / 2, s2 - s1) for (_, s1), (s2, _) in zip(self._merged, self._merged[1:])
                if s2 > s1]
        host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in self.host), key=lambda x: x[0])
        totals: dict[str, float] = defaultdict(float)
        active: list[tuple[float, float, str]] = []  # heap by latest start
        i = 0
        for mid, length in sorted(gaps):
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            totals[active[0][2] if active else "(no host op)"] += length * 1e-6
        return [[name, s] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[name, s] for name, s in self.device_ops[:top]], "idle_gaps": self.idle_gaps(top)}
