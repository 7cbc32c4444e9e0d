"""Lowering probes P on the card (counterpart of
``scripts/probe_pallas_strided.py``): can a CUDA kernel read every second row
of a tile, fold row pairs into one row or split a row in two, run the skinny
[T, 16] x [16, C] bf16 product of the conv frontend's layer 0, and accumulate
a reduce over a sequential grid axis? Each probe is a small kernel of
``mer_tpu_torch/csrc/probe_strided.cu``, checked against torch exactly (the
bf16 product to rtol 1e-3, as the TPU probe checks it), one line a probe.

    python -m mer_tpu_torch.scripts.probe_strided [--device cuda|cpu]

The input is the TPU probe's: X = arange(256 x 512) mod 1003, f32. On the card
each probe also reports its device time per call beside its plain version's
and one torch call's that computes the same function (the library call):
calls captured in a CUDA graph and replayed between CUDA events, so the
host's launch cost is left out. On the CPU the plain versions run, so the
script checks only itself there.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from mer_tpu_torch.ops import _build
from mer_tpu_torch.scripts.bench_attention import device_ms
from mer_tpu_torch.serving.engine import resolve_device

T, C = 256, 512
REPS, REPLAYS = 50, 20  # calls captured in one graph, replays timed: a probe takes microseconds
PROBES = ("even_rows", "odd_rows", "fold_pairs", "unfold_halves", "skinny_bf16_gemm", "grid_reduce")


def probe_input(device) -> tuple[torch.Tensor, torch.Tensor]:
    """X [T, C] f32 (the TPU probe's) and a seeded bf16 W [16, C]."""
    x = (torch.arange(T * C, dtype=torch.float32) % 1003.0).reshape(T, C)
    w = torch.randn(16, C, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    return x.to(device), w.to(device)


def probe_reference(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain torch version of probe ``name``."""
    t, c = x.shape
    if name == "even_rows":
        return x[0::2].contiguous()
    if name == "odd_rows":
        return x[1::2].contiguous()
    if name == "fold_pairs":
        return x.reshape(t // 2, 2 * c).clone()
    if name == "unfold_halves":
        return x.reshape(2 * t, c // 2).clone()
    if name == "skinny_bf16_gemm":
        return x[:, :16].to(torch.bfloat16).float() @ w.float()
    if name == "grid_reduce":
        return sum(chunk.sum(0, keepdim=True) for chunk in x.chunk(4, 0))
    raise ValueError(f"unknown probe {name!r}")


def library_call(name: str, x: torch.Tensor, w: torch.Tensor):
    """A call of one torch function that computes probe ``name``, for its
    time: a strided or reshaped copy, ``torch.mm`` on the bf16 rows cast
    beforehand (its output bf16), ``sum`` over the rows."""
    if name == "skinny_bf16_gemm":
        rows = x[:, :16].to(torch.bfloat16)
        return lambda: torch.mm(rows, w)
    if name == "grid_reduce":
        return lambda: x.sum(0, keepdim=True)
    return lambda: probe_reference(name, x, w)


def _out_shape(name: str, t: int, c: int) -> tuple[int, int]:
    return {"even_rows": (t // 2, c), "odd_rows": (t // 2, c), "fold_pairs": (t // 2, 2 * c),
            "unfold_halves": (2 * t, c // 2), "skinny_bf16_gemm": (t, c), "grid_reduce": (1, c)}[name]


def _kernel_fn():
    fn = _build.load("probe_strided").mer_probe_strided
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def run_probe(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Probe ``name`` through its kernel for CUDA tensors, its plain version
    for CPU tensors. ``run_probe.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return probe_reference(name, x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.bfloat16 or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the probes take a contiguous f32 x and bf16 w")
    fn = _kernel_fn()
    out = torch.empty(_out_shape(name, *x.shape), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(PROBES.index(name), x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe {name} launch failed: cudaError {rc}")
    run_probe.launches += 1
    return out


run_probe.launches = 0


def main(argv=None) -> dict:
    """Returns ``{probe: {"ok", "max_abs_err", ...}}``, with ``"ms"``,
    ``"plain_ms"`` and ``"library_ms"`` on the card."""
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.scripts.probe_strided")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    x, w = probe_input(device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain versions only)"
    print(f"probes on [{T}, {C}] f32, {where}")
    results = {}
    for name in PROBES:
        got = run_probe(name, x, w)
        want = probe_reference(name, x, w)
        err = (got - want).abs().max().item()
        ok = got.shape == want.shape and (
            torch.allclose(got, want, rtol=1e-3, atol=0) if name == "skinny_bf16_gemm" else torch.equal(got, want))
        row = {"ok": bool(ok), "max_abs_err": err}
        if device.type == "cuda":
            row["ms"] = device_ms(lambda: run_probe(name, x, w), REPS, REPLAYS)
            row["plain_ms"] = device_ms(lambda: probe_reference(name, x, w), REPS, REPLAYS)
            row["library_ms"] = device_ms(library_call(name, x, w), REPS, REPLAYS)
        results[name] = row
        print(f"{name:18s} {'OK' if ok else 'WRONG VALUES'} max_abs_err {err}"
              + (f" kernel {row['ms']} ms, plain {row['plain_ms']} ms, library {row['library_ms']} ms"
                 if "ms" in row else ""))
    return results


if __name__ == "__main__":
    main()
