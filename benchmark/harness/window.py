"""What every driver does around its window: synchronising, the device's
peak memory, the traced window's reductions, and the counters."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.harness.ops import OpRecorder, counter_delta, launch_counters
from benchmark.harness.trace import Trace, capture


def synchronize(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def free_device(device: str) -> None:
    import gc

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


class Window:
    """The measured window: ``with Window(ctx) as win: ...``, then
    ``win.seconds``. With ``ctx.trace`` the port's op entries are wrapped
    (:class:`OpRecorder`) and the window is profiled, for at most the
    traffic's ``trace_seconds``; ``win.deadline`` is when the body stops
    starting work. The garbage collector is off inside the window (what
    set-up made is frozen first), so no collection pauses the host."""

    def __init__(self, ctx, recorder: OpRecorder | None):
        self.ctx, self.recorder = ctx, recorder
        length = ctx.seconds
        if ctx.trace:
            length = min(length, float(ctx.cell.traffic.get("trace_seconds", length)))
        self.length = length
        self.trace: Trace | None = None
        self.counters: dict = {}

    def __enter__(self) -> "Window":
        self._before = launch_counters()
        gc.collect()
        gc.freeze()
        gc.disable()
        synchronize(self.ctx.device)
        self._capture = capture(self.ctx.trace)
        self._prof = self._capture.__enter__()
        if self.recorder is not None:
            self.recorder.recording = True
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.length
        return self

    def __exit__(self, *exc) -> None:
        synchronize(self.ctx.device)
        self.seconds = time.perf_counter() - self.t0
        gc.enable()
        gc.unfreeze()
        if self.recorder is not None:
            self.recorder.recording = False
        self._capture.__exit__(*exc)
        self.counters = counter_delta(self._before, launch_counters())
        if self._prof is not None and exc[0] is None:
            self.trace = Trace(self._prof, self.seconds)

    def layers(self, **extra) -> dict:
        """What the metrics' readers read: the traced window's busy and
        window seconds, breakdown, op calls and backward nodes, and
        ``extra`` (the window's FLOPs)."""
        if self.trace is None:
            return {}
        out = {"trace": self.trace, "busy_s": self.trace.busy_s, "window_s": self.trace.window_s,
               "breakdown": self.trace.breakdown()}
        if self.recorder is not None:
            out["calls"] = dict(self.recorder.calls)
            out["backward_nodes"] = {k: sorted(v) for k, v in self.recorder.backward_nodes.items()}
        out.update(extra)
        return out
