#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path at the full width of the default config
(``src/config.yaml``: 768-wide, 6 + 6 encoder layers, 5 FAM layers; seeded
random weights) and fails on any fault:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build every CUDA kernel from ``mer_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card at the
   dialogue buckets (B=32), and time kernel, plain version and library call;
4. offline evaluation: ``mer_tpu_torch.test.main`` on the synthetic MELD test
   split (280 dialogues, batch 32), with and without ``--serving-batch 512``;
   17 attention launches per forward; f32 logits through the kernel against
   the plain attention over both batchings; bf16-vs-f32 agreement, utterances
   per second, and one forward's kernel count and device-time breakdown;
5. online serving: ``mer_tpu_torch.serve.main(--synthetic --requests N)``,
   N = 64 (one micro-batch) and N = 280 (a burst of the test split's
   dialogue count, several micro-batches);
6. hold each kernel against its plain version again at every shape that
   phases 4-5 gave it (recorded during those runs), in float32 and bfloat16;
7. one ``{"kernels": [...]}`` line, whose times and bound are per launch,
   averaged over the main path's launches at their own shapes; then the
   device line last.

Tolerances (kernel against plain version, same inputs): float32 out and lse
within 2e-5; bfloat16 inputs out within 1e-2 (bf16 rounding of the output)
and lse within 1e-3 of the plain version computed in float32. Model logits in
float32, kernel against plain attention: 1e-3.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                                  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 non-tensor
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}  # (out, lse)
KERNEL_SHAPES = (  # (B, H, Sq, Sk, Dh): dialogue buckets, dh 96 (768/8) and 50 (300/6), one Sq != Sk
    [(32, 8, s, s, dh) for dh in (96, 50) for s in (8, 16, 24, 33)] + [(32, 8, 24, 33, 96)]
)
KERNELS = ("flash_attention_fwd",)  # sources mer_tpu_torch/csrc/<name>.cu
ONLINE_REQUESTS = (64, 280)  # one micro-batch at --max-batch 64; the MELD test split's dialogue count
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# ((B, H, Sq, Sk, Dh), dtype name) -> kernel launches, over the main path's counted runs
PATH_SHAPES: collections.Counter = collections.Counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def eager_ms(fn, iters: int = 200) -> float:
    """Time per call issued eagerly from Python (host launch cost included)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(shape, dtype, seed: int):
    """q, k, v at the main path's scale and a dialogue-style key mask: row b
    keeps its first L_b keys, row 0 is all padding with key 0 attendable.

    On the main path q, k, v are LayerNorm'd activations (unit variance)
    through the in-projection, whose seeded weights are U(+-1/sqrt(D)): the
    projections have variance 1/3. So |out| stays below 4, where half a bf16
    ulp of the output (<= 2**-7) is inside the 1e-2 tolerance."""
    b, h, sq, sk, dh = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v = ((torch.randn(b, h, s, dh, generator=g) / 3 ** 0.5).to("cuda", dtype) for s in (sq, sk, sk))
    lengths = torch.randint(1, sk + 1, (b,), generator=g)
    mask = torch.arange(sk)[None, :] >= lengths[:, None]
    mask[0] = True
    mask[0, 0] = False
    return q, k, v, mask.cuda()


def attention_bound(shape, dtype) -> tuple[float, float]:
    """Least time (us) for one call from bytes (q, k, v, mask read once; out,
    lse written once) at the HBM rate, and from the two products' FLOPs at
    the dense peak; the bound is the larger."""
    b, h, sq, sk, dh = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * sq * dh + 2 * b * h * sk * dh) * esize + b * h * sq * 4 + b * sk
    flops = 4 * b * h * sq * sk * dh
    return nbytes / HBM_BYTES_PER_S * 1e6, flops / PEAK_FLOPS[dtype] * 1e6


def check_kernel(fa, cases) -> list[dict]:
    """K1 against its plain version at each (shape, dtype name) of ``cases``,
    with times; raises on the first disagreement."""
    import torch.nn.functional as F

    rows = []
    for i, (shape, dtype) in enumerate(cases):
        q, k, v, mask = attention_inputs(shape, DTYPES[dtype], seed=i)
        out, lse = fa.flash_attention_forward(q, k, v, mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask)
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dtype]
        attn_mask = ~mask[:, None, None, :]  # SDPA: True = take part
        row = {
            "shape": shape, "dtype": dtype,
            "err_out": err_out, "err_lse": err_lse,
            "kernel_ms": device_ms(lambda: fa.flash_attention_forward(q, k, v, mask)),
            "kernel_eager_ms": eager_ms(lambda: fa.flash_attention_forward(q, k, v, mask)),
            "plain_ms": device_ms(lambda: fa.flash_attention_reference(q, k, v, mask)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)),
        }
        bytes_us, ops_us = attention_bound(shape, DTYPES[dtype])
        row.update(bound_bytes_us=bytes_us, bound_ops_us=ops_us, bound_us=max(bytes_us, ops_us),
                   bound_by="bytes" if bytes_us >= ops_us else "operations")
        log("kernel " + json.dumps(row))
        if not (err_out <= tol_out and err_lse <= tol_lse):
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {shape} "
                                 f"{dtype}: out {err_out} (tol {tol_out}), lse {err_lse} (tol {tol_lse})")
        rows.append(row)
    return rows


@contextlib.contextmanager
def main_path_run(fa):
    """One counted run of a main path: the launch count starts at 0 and is
    read at the end into ``run["launches"]``; every shape the path gives the
    kernel is tallied in ``PATH_SHAPES`` (the tally launches nothing)."""
    from mer_tpu_torch.ops import attention as attention_mod

    forward = fa.flash_attention_forward

    def tallied(q, k, v, key_padding_mask=None):
        if q.is_cuda:
            PATH_SHAPES[((*q.shape[:3], k.shape[2], q.shape[3]), str(q.dtype).removeprefix("torch."))] += 1
        return forward(q, k, v, key_padding_mask)

    run = {}
    forward.launches = 0
    with mock.patch.object(attention_mod, "flash_attention_forward", tallied):
        yield run
    run["launches"] = forward.launches


def offline_phase(fa, card: str) -> tuple[int, int]:
    """Phase 4; returns (kernel launches of the offline entry point,
    attention calls per forward)."""
    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.models import M2FNet, init_random_, save_reference_checkpoint
    from mer_tpu_torch.ops import attention as attention_mod
    from mer_tpu_torch.serving import BatchedPredictor, recollate_batches
    from mer_tpu_torch.serving.engine import build_model, predict_fn

    config = load_config(CONFIG_PATH)
    m = config.model
    per_forward = (int(m.AUDIO.n_encoder_layers) * int(m.AUDIO.n_transformers)
                   + int(m.TEXT.n_encoder_layers) * int(m.TEXT.n_transformers) + int(m.FAM.n_layers))
    batches = eval_entry.eval_batches(config, eval_entry.eval_dataset(config, synthetic=True))
    feed = [{k: b[k] for k in ("text", "audio", "padding_mask")} for b in batches]
    merged, _ = recollate_batches(feed, 512)
    n_utt = int(sum((b["emotion"] != -1).sum() for b in batches))

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m2fnet.pth")
        model = init_random_(M2FNet.from_config(m), torch.Generator().manual_seed(0))
        save_reference_checkpoint(ckpt, model)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"offline: M2FNet default config, {n_params} parameters, checkpoint {os.path.getsize(ckpt)} bytes")

        launches = 0
        for extra, n_forward in (([], len(batches)), (["--serving-batch", "512"], len(merged))):
            with main_path_run(fa) as run:
                summary = eval_entry.main(["--synthetic", "--checkpoint", ckpt, *extra])
            got = run["launches"]
            launches += got
            log(f"offline {extra or 'batch 32'}: {json.dumps(summary)}; kernel launches {got} "
                f"= {per_forward} x {n_forward} forwards")
            if got != per_forward * n_forward:
                raise AssertionError(f"expected {per_forward * n_forward} attention launches, got {got}")

        f32 = build_model(config.override(tpu__compute_dtype="float32"), torch.device("cuda"), checkpoint=ckpt)
        bf16 = build_model(config, torch.device("cuda"), checkpoint=ckpt)

    def logits(model, feed_set):
        dtype = next(model.parameters()).dtype
        with torch.inference_mode():
            return [model(torch.from_numpy(b["text"]).to("cuda", dtype), torch.from_numpy(b["audio"]).to("cuda", dtype),
                          torch.from_numpy(b["padding_mask"]).cuda()).float()
                    for b in feed_set]

    for name, feed_set in (("batch 32", feed), ("serving batch 512", merged)):
        with_kernel = logits(f32, feed_set)
        with mock.patch.object(attention_mod, "flash_attention_forward", fa.flash_attention_reference):
            with_plain = logits(f32, feed_set)
        err = max((a - b).abs().max().item() for a, b in zip(with_kernel, with_plain))
        log(f"offline f32 logits {name} {[tuple(b['text'].shape) for b in feed_set]}, kernel vs plain "
            f"attention: max abs diff {err} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"f32 logits through the kernel differ from plain attention by {err} ({name})")
        if name == "batch 32":
            f32_logits = with_kernel

    valid = [torch.from_numpy(b["emotion"] != -1).cuda() for b in batches]
    pred_bf16 = logits(bf16, feed)
    agree = sum(int(((a.argmax(-1) == b.argmax(-1)) & v).sum()) for a, b, v in zip(pred_bf16, f32_logits, valid))
    log(f"offline bf16 vs f32 predictions agree on {agree}/{n_utt} utterances ({card})")

    for name, feed_set in (("batch 32", feed), ("serving batch 512", merged)):
        predictor = BatchedPredictor(predict_fn(bf16), "cuda")
        predictor(feed_set)  # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            predictor(feed_set)  # ends in a device-to-host fetch
            times.append(time.perf_counter() - t0)
        log(f"offline bf16 {name}: {len(feed_set)} forwards, {n_utt} utterances, median "
            f"{np.median(times) * 1e3} ms = {n_utt / np.median(times)} utterances/s ({card})")

    # where the time of one forward goes: eager wall time vs device-only time
    for name, b in (("batch 32", feed[0]), ("serving batch", merged[0])):
        args = (torch.from_numpy(b["text"]).to("cuda", torch.bfloat16),
                torch.from_numpy(b["audio"]).to("cuda", torch.bfloat16), torch.from_numpy(b["padding_mask"]).cuda())
        with torch.inference_mode():
            eager, device = eager_ms(lambda: bf16(*args), iters=20), device_ms(lambda: bf16(*args), reps=1, replays=20)
            kernels, count = kernel_profile(lambda: bf16(*args))
        log(f"forward bf16 {name} {tuple(b['text'].shape)}: eager {eager} ms, device-only (CUDA graph replay) "
            f"{device} ms, device idle share of the eager forward {1 - device / eager} ({card})")
        busy = sum(kernels.values())
        if not kernels:
            log("  profiler: no device activity recorded (kernel breakdown not measured)")
            continue
        k1 = sum(t for n, t in kernels.items() if "flash_attention_fwd" in n)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        log(f"  profiler: {count} kernels, {busy} us of kernels in one forward, K1 share {k1 / busy}; top: "
            + "; ".join(f"{n[:60]} {t} us" for n, t in top))
    return launches, per_forward


def kernel_profile(fn) -> tuple[dict[str, float], int]:
    """Device time (us) by kernel name over one call, and the number of
    kernels it ran (copies and memsets left out), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    totals: dict[str, float] = {}
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += not e.name.startswith(("Memcpy", "Memset"))
    return totals, count


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs one NVIDIA card")
    sys.path.insert(0, REPO)
    from mer_tpu_torch import serve as serve_entry
    from mer_tpu_torch.ops import _build
    from mer_tpu_torch.ops import flash_attention as fa

    # 1. device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        "TF32 off (torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False)")

    # 2. build
    t0 = time.perf_counter()
    built = [name for name in KERNELS if _build.build(name)]
    log(f"build: {built or 'all kernels already built'} in {time.perf_counter() - t0:.1f} s")

    # 3. kernel against its plain version at the dialogue buckets
    rows = check_kernel(fa, [(shape, dtype) for shape in KERNEL_SHAPES for dtype in DTYPES])

    # 4. offline evaluation, 5. online serving: counts start at 0 for each path
    launches, per_forward = offline_phase(fa, card)
    for n_requests in ONLINE_REQUESTS:
        with main_path_run(fa) as run:
            report = serve_entry.main(["--synthetic", "--requests", str(n_requests)])
        served = run["launches"]
        log(f"online {n_requests} requests: {served} kernel launches, {report['batches']} micro-batches ({card})")
        if report["requests"] != n_requests or served == 0 or served % per_forward:
            raise AssertionError(f"online serving answered {report['requests']}/{n_requests} requests "
                                 f"with {served} launches")
        launches += served
    if sum(PATH_SHAPES.values()) != launches:
        raise AssertionError(f"{sum(PATH_SHAPES.values())} attention calls on the card, {launches} kernel launches")

    # 6. kernel against its plain version at every shape the paths gave it
    # (both dtypes: the f32 parity leg of phase 4 runs the same shapes)
    checked = {(r["shape"], r["dtype"]) for r in rows}
    rows += check_kernel(fa, sorted({(shape, dtype) for shape, _ in PATH_SHAPES for dtype in DTYPES} - checked))
    by_case = {(r["shape"], r["dtype"]): r for r in rows}
    for (shape, dtype), n in sorted(PATH_SHAPES.items()):
        r = by_case[(shape, dtype)]
        log(f"main path {shape} {dtype}: {n} launches x kernel {r['kernel_ms']} ms (bound {r['bound_us'] / 1e3} ms)")
    path = {key: sum(n * by_case[case][key] for case, n in PATH_SHAPES.items())
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_bytes_us", "bound_ops_us")}
    log(f"main path: {launches} launches at {len(PATH_SHAPES)} shapes; summed over them {json.dumps(path)} ({card})")

    # 7. kernel line (times per launch, averaged over the main path's
    # launches at their own shapes), then the device line last
    bound_us = max(path["bound_bytes_us"], path["bound_ops_us"])
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mer_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mer_tpu/ops/flash_attention.py:72",
        "launches": launches,
        "max_abs_err": max(r["err_out"] for r in rows),
        "ms": path["kernel_ms"] / launches,
        "plain_ms": path["plain_ms"] / launches,
        "bound_ms": bound_us / 1e3 / launches,
        "bound_by": "bytes" if path["bound_bytes_us"] >= path["bound_ops_us"] else "operations",
        "library_ms": path["library_ms"] / launches,
        "shapes": {f"{dtype} {'x'.join(map(str, shape))}": n for (shape, dtype), n in sorted(PATH_SHAPES.items())},
        "shapes_checked": len(rows),
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
