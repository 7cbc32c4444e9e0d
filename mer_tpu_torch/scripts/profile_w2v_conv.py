"""Profile the wav2vec2 conv feature extractor: the stock PyTorch conv stack
against the variants that put part of it into the port's kernels (counterpart
of ``scripts/profile_w2v_conv.py``).

    python -m mer_tpu_torch.scripts.profile_w2v_conv [batch] [seconds]
        [--fused] [--l0fused] [--gnfused] [--f32] [--device cuda|cpu] [--repeats N] [--trace]

The stock stack is ``conv_stack_stock`` (7 x ``F.conv1d``, ``F.group_norm`` with
float32 statistics, exact GELU: cuDNN on the card). The variants, all of
:mod:`mer_tpu_torch.ops.w2v_conv`:

- ``--fused``: layer 0 + GroupNorm + GELU in K7, layers 1..6 in K6 (the route
  the model serves with);
- ``--l0fused``: K7, then stock convs for layers 1..6;
- ``--gnfused``: stock convs everywhere, only the GroupNorm + GELU in K8.

For every variant asked for: its numerics against the stock stack on the first
two clips (largest difference over the stock stack's largest value), then the
time per batch (CUDA events around ``--repeats`` calls on the card; a host
clock on the CPU, labelled so) and the conv products' TFLOP/s with their share
of the card's dense peak for the compute dtype (989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them: the H100 SXM data sheet). ``--trace``
(card only) adds, for each variant besides the stock stack, every launch of
one call in order with its device time (torch.profiler's trace), and each of
K6's six layer grids with its share of that peak. Default: batch 32, 10 s
clips, bf16, seeded weights.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from mer_tpu_torch.models.wav2vec2 import Wav2Vec2Config, audio_erc_from_seed
from mer_tpu_torch.ops import w2v_conv
from mer_tpu_torch.serving.engine import resolve_device
from mer_tpu_torch.utils.profiling import PEAK_FLOPS

SAMPLE_RATE = 16000


def layer_flops(cfg: Wav2Vec2Config, batch: int, length: int) -> list[float]:
    """Multiply-adds x 2 of each of the seven convs on ``batch`` clips of ``length`` samples."""
    flops, c_in = [], 1
    for dim, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
        flops.append(2.0 * length * k * c_in * dim * batch)
        c_in = dim
    return flops


def conv_flops(cfg: Wav2Vec2Config, batch: int, length: int) -> float:
    """Multiply-adds x 2 of the seven convs on ``batch`` clips of ``length`` samples."""
    return sum(layer_flops(cfg, batch, length))


def launches_us(fn) -> list[tuple[str, float]]:
    """(kernel name, device us) of every launch and fill of one call of ``fn``
    on the card, in order, from torch.profiler's trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memset")), key=lambda e: e["ts"])
    return [(e["name"], float(e["dur"])) for e in kernels]


def timed_ms(fn, repeats: int, device: torch.device) -> float:
    """Time per call of ``fn``: CUDA events around ``repeats`` calls on the
    card (after two warm-up calls), the host clock on the CPU."""
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def variants(frontend, cfg: Wav2Vec2Config, dtype: torch.dtype) -> dict:
    """name -> ``wave [B, L] -> [B, T6, C]`` over the seeded frontend's weights."""
    first = frontend.conv_layers[0]
    weights = [layer.conv.weight for layer in frontend.conv_layers]
    gamma, beta, eps, strides = first.layer_norm.weight, first.layer_norm.bias, first.layer_norm.eps, cfg.conv_stride
    common = dict(eps=eps, dtype=dtype)

    def fused(wave):
        x = w2v_conv.layer0_gn(wave, weights[0], gamma, beta, stride=strides[0], **common)
        return w2v_conv.conv_stack_fused(x, weights[1:], strides[1:])

    return {
        "stock": lambda wave: w2v_conv.conv_stack_stock(wave, weights, gamma, beta, strides, **common),
        "fused": fused,
        "l0fused": lambda wave: w2v_conv.conv_stack_l0fused(wave, weights, gamma, beta, strides, **common),
        "gnfused": lambda wave: w2v_conv.conv_stack_gnfused(wave, weights, gamma, beta, strides, **common),
    }


def main(argv=None) -> dict:
    """Returns ``{variant: {"ms", "tflops", "peak_share", "max_rel_err"}}`` on
    the card, ``{variant: {"host_ms", "max_rel_err"}}`` on the CPU."""
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.scripts.profile_w2v_conv")
    p.add_argument("batch", nargs="?", type=int, default=32)
    p.add_argument("seconds", nargs="?", type=float, default=10.0)
    p.add_argument("--fused", action="store_true", help="K7 + K6")
    p.add_argument("--l0fused", action="store_true", help="K7 + stock tail")
    p.add_argument("--gnfused", action="store_true", help="stock convs + K8")
    p.add_argument("--f32", action="store_true", help="float32 compute (default bf16)")
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--trace", action="store_true", help="each launch of one call with its device time (card only)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = Wav2Vec2Config.base()
    length = int(SAMPLE_RATE * args.seconds)
    wave = torch.from_numpy(np.random.default_rng(0).normal(size=(args.batch, length)).astype(np.float32)).to(device)
    frontend = audio_erc_from_seed(0, cfg).wav2vec2.feature_extractor.to(device)
    fns = variants(frontend, cfg, dtype)
    chosen = ["stock"] + [name for name in ("fused", "l0fused", "gnfused") if getattr(args, name)]
    flops = conv_flops(cfg, args.batch, length)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock, no device time)"
    print(f"conv frontend [{args.batch}, {length}] {dtype}, {flops / 1e9:.1f} GFLOP of conv products, on {where}")

    results: dict[str, dict] = {}
    with torch.no_grad():
        want = fns["stock"](wave[:2]).float()
        for name in chosen:
            got = fns[name](wave[:2]).float()
            rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-9)).item()
            if name != "stock":
                print(f"{name}-vs-stock max rel err ({dtype}): {rel:.2e}")
            ms = timed_ms(lambda: fns[name](wave), args.repeats, device)
            if device.type != "cuda":  # a host time is no device metric: no rate, no share of a peak
                results[name] = {"host_ms": ms, "max_rel_err": rel}
                print(f"{name}_conv: {ms:8.3f} ms/batch on the host clock (no device time measured)")
                continue
            rate = flops / (ms * 1e-3)
            results[name] = {"ms": ms, "tflops": rate / 1e12, "peak_share": rate / PEAK_FLOPS[dtype],
                             "max_rel_err": rel}
            print(f"{name}_conv: {ms:8.3f} ms/batch  {rate / 1e12:6.1f} TFLOP/s  "
                  f"({rate / PEAK_FLOPS[dtype] * 100:4.1f}% of the card's dense {dtype} peak)")
            if args.trace and name != "stock":
                trace = launches_us(lambda: fns[name](wave))
                tail = iter(layer_flops(cfg, args.batch, length)[1:])  # K6's grids are layers 1..6 in order
                for kernel, us in trace:
                    share = f"  {next(tail) / (us * 1e-6) / PEAK_FLOPS[dtype] * 100:4.1f}% of the peak" \
                        if "w2v_conv_s2_gelu" in kernel else ""
                    print(f"  {us:9.1f} us  {kernel[:90]}{share}")
                results[name]["launches_us"] = trace
    return results


if __name__ == "__main__":
    main()
