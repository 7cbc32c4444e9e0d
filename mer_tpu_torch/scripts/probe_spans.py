"""What the port's host spans (``utils/tracing.py``) cost, and how well they
sit on the device trace's clock.

    python -m mer_tpu_torch.scripts.probe_spans [--device cuda|cpu] [--repeats 100000]

Prints, with the card's name and power limit:

- the median cost of one span, entered and left, with no capture recording
  (``off``; without and with attrs), of reading the profiler's flag alone
  and of a bare ``record_function`` (both off), each the median of
  ``--repeats`` timings of one call less the median of an empty timing;
- the same of a span while a ``torch.profiler`` capture records (``on``);
- whether a second thread's ``record_function`` ranges and ops appear in
  the capture's host events, for a thread started inside the capture and
  for one started before it;
- the spread of the offset between ``perf_counter_ns`` and the trace's
  microseconds over main-thread spans around small device work
  (``tracing.clock_offset_us``' pairs: quartiles, least and largest, in
  microseconds from their median).

The last line is one JSON object of the same numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import threading
from time import perf_counter_ns

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from mer_tpu_torch.utils import tracing
from mer_tpu_torch.utils.tracing import span


def _median_ns(body, repeats: int) -> float:
    times = [0] * repeats
    for i in range(repeats):
        t0 = perf_counter_ns()
        body()
        times[i] = perf_counter_ns() - t0
    return statistics.median(times)


def _empty():
    pass


def _span():
    with span("probe"):
        pass


def _span_attrs():
    with span("probe", batch=3, rows=16):
        pass


def _flag():
    return autograd_profiler._is_profiler_enabled


def _record_function():
    with record_function("probe"):
        pass


def costs(repeats: int) -> dict:
    """Median ns of one call, the empty timing's median subtracted."""
    base = _median_ns(_empty, repeats)
    out = {"empty_timing_ns": base}
    for name, body in (("span_off_ns", _span), ("span_attrs_off_ns", _span_attrs), ("flag_read_ns", _flag),
                       ("record_function_off_ns", _record_function)):
        out[name] = _median_ns(body, repeats) - base
    with profile(activities=_activities()):
        out["span_on_ns"] = _median_ns(_span, min(repeats, 20_000)) - base
    return out


def _on_device(event) -> bool:
    return getattr(event.device_type, "name", str(event.device_type)) == "CUDA"


def _activities():
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def thread_visibility(device: str) -> dict:
    """Which of a second thread's ranges and ops the capture's host events hold."""
    x = torch.randn(256, 256, device=device)

    def work(tag: str, ready: threading.Event | None = None, go: threading.Event | None = None):
        if ready is not None:
            ready.set()
            go.wait(30)
        with span(f"thread_{tag}"):
            with record_function(f"range_{tag}"):
                (x @ x).sum().item()

    ready, go = threading.Event(), threading.Event()
    before = threading.Thread(target=work, args=("before", ready, go))
    before.start()
    ready.wait(30)
    with profile(activities=_activities()) as prof:
        with span("main"):
            (x @ x).sum().item()
        inside = threading.Thread(target=work, args=("inside",))
        inside.start()
        inside.join(60)
        go.set()
        before.join(60)
    names = {e.name for e in prof.events() if not _on_device(e)}
    threads = {e.thread for e in prof.events() if not _on_device(e)}
    listed = {r.name for r in tracing.spans()}
    return {"host_threads_in_capture": len(threads),
            **{f"{tag}_range_event": f"range_{tag}" in names or f"mer.thread_{tag}" in names
               for tag in ("inside", "before")},
            **{f"{tag}_span_listed": f"thread_{tag}" in listed for tag in ("inside", "before")}}


def clock_spread(device: str, spans_n: int = 2000) -> dict:
    """Offsets of main-thread spans around small device work, from their median, in us."""
    x = torch.randn(256, 256, device=device)
    with profile(activities=_activities()) as prof:
        for i in range(spans_n):
            with span("probe_work", i=i):
                x = torch.tanh(x @ x)
    host = [(e.name, e.time_range.start) for e in prof.events() if not _on_device(e)]
    found = tracing.clock_offset_us(tracing.spans(), host)
    if found is None:
        return {"pairs": 0}
    offset, pairs = found
    d = sorted(p - offset for p in pairs)
    q = statistics.quantiles(d, n=4)
    return {"pairs": len(d), "q1_us": q[0], "q3_us": q[2], "min_us": d[0], "max_us": d[-1],
            "within_50us": sum(abs(v) <= 50.0 for v in d) / len(d)}


def card() -> dict:
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = ""
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.scripts.probe_spans")
    p.add_argument("--device", default="cuda")
    p.add_argument("--repeats", type=int, default=100_000)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu for a CPU reading")
    out = {**card(), **costs(args.repeats), **thread_visibility(args.device), **clock_spread(args.device)}
    for key, value in out.items():
        print(f"{key}: {value}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
