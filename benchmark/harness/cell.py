"""One run of one cell: the arguments, the manifest's entries for the cell,
its driver, the metrics' readers, the look at what the process loaded, and
the result line.

A driver (``benchmark/drivers/<driver>.py``, named by the cell's traffic
file) exposes ``run(ctx) -> RunRecord``: it builds the program from the
cell's configuration and traffic, warms up, measures the window, then
compares what the window's path produced with the plain reference.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Any

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mer_tpu")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
HOST_THREADS = 1  # intra-op threads of the host's libraries


@dataclass
class Cell:
    """A workload entry of the manifest with its configuration and traffic."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


@dataclass
class RunContext:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


@dataclass
class RunRecord:
    """What a driver hands back. ``checks``: (name, value, limit), each
    correct while value <= limit. ``layers``: what the metrics' readers
    read (the trace, the op calls, the window's FLOPs)."""

    setup_s: float
    end_to_end: dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: list[tuple[str, float, float]]
    counters: dict = field(default_factory=dict)
    layers: dict[str, Any] = field(default_factory=dict)
    notes: list[str] = field(default_factory=list)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "workloads", f"{name}.json")) as f:
        traffic = json.load(f)
    if traffic.get("traffic") != entry["traffic"]:
        raise SystemExit(f"benchmark/workloads/{name}.json is traffic {traffic.get('traffic')!r}, "
                         f"the manifest says {entry['traffic']!r}")
    return Cell(name, int(entry["chips"]), config, traffic,
                [m for m in manifest["end_to_end"] if applies(m, name)],
                [m for m in manifest["per_layer"] if applies(m, name)])


def reader(metric: str):
    """The ``read(layers)`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loaded_forbidden() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name, compared whole, is
    one of :data:`FORBIDDEN`."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def power_limit_w() -> float | None:
    """The first card's power limit from ``nvidia-smi`` (None without it)."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                              capture_output=True, text=True, timeout=30)
        return float(proc.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def set_cache_dirs() -> None:
    """Every cache a library might keep goes inside the checkout, at fixed
    paths (the port builds its kernels into ``mer_tpu_torch/_build/``)."""
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def set_host_threads() -> None:
    """One process with few threads: the host's libraries get
    :data:`HOST_THREADS` intra-op threads (before torch is imported, then
    torch's own pool), so their pools do not contend with the thread that
    launches the card's work."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> RunRecord:
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    return driver.run(RunContext(cell, int(seed), float(seconds), bool(trace), device, t_start))


def metrics_of(cell: Cell, record: RunRecord, trace: bool) -> dict:
    out = {}
    if not trace:
        for m in cell.end_to_end:
            value = record.setup_s if m["name"] == "setup_s" else record.end_to_end.get(m["name"])
            if value is None:
                raise RuntimeError(f"the driver gave no {m['name']}")
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = reader(m["name"])(record.layers)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, record: RunRecord, trace: bool, device: dict) -> dict:
    checks = {name: {"value": float(value), "limit": float(limit)} for name, value, limit in record.checks}
    correct = bool(record.checks) and record.failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in record.checks)
    out = {"correct": correct, "attempted": int(record.attempted), "failed": int(record.failed),
           "metrics": metrics_of(cell, record, trace), "device": device}
    if trace and record.layers.get("breakdown"):
        out["breakdown"] = record.layers["breakdown"]
    out["checks"] = checks
    return out


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    set_cache_dirs()
    set_host_threads()

    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    record = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = loaded_forbidden()
    if found:
        print(f"JAX-side modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(record.memory_peak_bytes)}
    if args.trace:
        device.update(busy_s=record.layers["busy_s"], window_s=record.layers["window_s"])
    device["power_limit_w"] = power_limit_w()
    line = result_line(cell, record, bool(args.trace), device)
    if record.counters:
        print(json.dumps({"counters": record.counters}))
    trace = record.layers.get("trace")
    if trace is not None:
        print(f"trace: {trace.kernel_s!r} s of device operations, {trace.launched_s!r} s of them linked to a "
              f"launch call", file=sys.stderr)
    for note in record.notes:
        print(note, file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
