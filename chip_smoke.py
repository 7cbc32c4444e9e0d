#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving and training paths at the full width of the
default config (``src/config.yaml``: 768-wide, 8 heads, 6 + 6 encoder
layers, 5 FAM layers; seeded random weights) and fails on any fault:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build every CUDA kernel from ``mer_tpu_torch/csrc``, one nvcc per source,
   all started together;
3. hold each kernel against its plain PyTorch version on the card at the
   dialogue buckets (B=32), f32 and bf16, dropout off and on (K1 the
   forward, K2 the backward), and read the kernels' dropout masks off
   exactly; time kernel, plain version and library call;
4. offline evaluation: ``mer_tpu_torch.test.main`` on the synthetic MELD test
   split (280 dialogues, batch 32), with and without ``--serving-batch 512``;
   17 attention launches per forward; f32 logits through the kernel against
   the plain attention over both batchings; bf16-vs-f32 agreement, utterances
   per second, and one forward's kernel count and device-time breakdown;
5. online serving: ``mer_tpu_torch.serve.main(--synthetic --requests N)``,
   N = 64 (one micro-batch) and N = 280 (a burst of the test split's
   dialogue count, several micro-batches);
6. training: ``mer_tpu_torch.train.main(--synthetic --epochs 3)`` with the
   checkpoints in a temporary directory: 17 K1 (dropout 0.4) and 17 K2
   launches per step, 17 K1 launches per validation batch, finite losses,
   the last epoch's train loss below the first, and a checkpoint that
   ``mer_tpu_torch.test --checkpoint`` reads; an f32, dropout-0 parity leg
   (3 steps through the kernels against 3 through the plain attention);
   training utterances per second and one step's eager vs device time with
   its kernel breakdown;
7. hold each kernel against its plain version again at every shape that
   phases 4-6 gave it (recorded at each launch), in float32 and bfloat16;
8. one ``{"kernels": [...]}`` line, whose times and bound are per launch,
   averaged over the main paths' launches at their own shapes; then the
   device line last.

Tolerances (kernel against plain version, same inputs, |err| <= atol +
rtol |want|): K1 out f32 (2e-5, 0), bf16 (1e-2, 2**-8: the plain version
runs on the f32 values of the bf16 inputs and is not rounded); lse 2e-5 in
f32, 1e-3 in bf16. K2 f32 (1e-4, 1e-5), bf16 (2e-2, 2**-7: both round an f32
value to bf16, one ulp apart at most). Dropout masks: exact. Model logits in
f32, kernel against plain attention: 1e-3. Parity leg after 3 steps: losses
within 1e-4; every parameter within 2 x lr x 3 (Adam moves a parameter whose
gradient is rounding noise by up to lr per step, in either direction).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import json
import math
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
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPE_NAMES = {0: "float32", 1: "bfloat16"}  # the kernels' dtype codes
# (atol, rtol) per kernel output and dtype
TOL = {
    ("fwd", "float32"): (2e-5, 0.0), ("fwd", "bfloat16"): (1e-2, 2.0 ** -8),
    ("lse", "float32"): (2e-5, 0.0), ("lse", "bfloat16"): (1e-3, 0.0),
    ("bwd", "float32"): (1e-4, 1e-5), ("bwd", "bfloat16"): (2e-2, 2.0 ** -7),
}
DROPOUT = 0.4  # the config's model.dropout
FWD, BWD = "flash_attention_fwd", "flash_attention_bwd"  # sources mer_tpu_torch/csrc/<name>.cu
KERNELS = (FWD, BWD)
REPLACES = {FWD: "mer_tpu/ops/flash_attention.py:72", BWD: "mer_tpu/ops/flash_attention.py:270"}
BUCKETS = (8, 16, 24, 33)
# (B, H, Sq, Sk, Dh): dialogue buckets, dh 96 (768/8) and 50 (300/6), one Sq != Sk
KERNEL_SHAPES = [(32, 8, s, s, dh) for dh in (96, 50) for s in BUCKETS] + [(32, 8, 24, 33, 96)]
ONLINE_REQUESTS = (64, 280)  # one micro-batch at --max-batch 64; the MELD test split's dialogue count
TRAIN_EPOCHS = 3
# (kernel, (B, H, Sq, Sk, Dh), dtype name, dropout rate) -> launches, over the main paths' counted runs
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


def excess(got, want, key) -> float:
    """Largest |got - want| beyond the TOL allowance of ``key`` (<= 0 passes)."""
    atol, rtol = TOL[key]
    got, want = got.float(), want.float()
    return ((got - want).abs() - atol - rtol * want.abs()).max().item()


def attention_inputs(shape, dtype, seed: int):
    """q, k, v and a cotangent g at the main path's scale, and a
    dialogue-style key mask: row b keeps its first L_b keys, row 0 is all
    padding with key 0 attendable.

    On the main path q, k, v are LayerNorm'd activations (unit variance)
    through the in-projection, whose seeded weights are U(+-1/sqrt(D)): the
    projections have variance 1/3."""
    b, h, sq, sk, dh = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = ((torch.randn(b, h, s, dh, generator=gen) / 3 ** 0.5).to("cuda", dtype)
                  for s in (sq, sk, sk, sq))
    lengths = torch.randint(1, sk + 1, (b,), generator=gen)
    mask = torch.arange(sk)[None, :] >= lengths[:, None]
    mask[0] = True
    mask[0, 0] = False
    return q, k, v, g, mask.cuda()


def dropout_seed(i: int, rate: float):
    return (0x9E3779B9 ^ i, 1000 + i) if rate else None


def attention_bound(kernel: str, shape, dtype) -> tuple[float, float]:
    """Least time (us) of one call from bytes at the HBM rate (each input
    read once, each output written once) and from the products' FLOPs at
    the dense peak of the dtype; the bound is the larger. The forward reads
    q, k, v, mask and writes out, lse (2 products); the backward reads q, k,
    v, out, g, lse, mask and writes dq, dk, dv (5 products). Dropout's
    Philox integer work is not counted."""
    b, h, sq, sk, dh = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    rows_q, rows_k = (2, 2) if kernel == FWD else (4, 4)  # q, out (+ g, dq); k, v (+ dk, dv)
    nbytes = (rows_q * b * h * sq * dh + rows_k * b * h * sk * dh) * esize + b * h * sq * 4 + b * sk
    flops = (4 if kernel == FWD else 10) * b * h * sq * sk * dh
    return nbytes / HBM_BYTES_PER_S * 1e6, flops / PEAK_FLOPS[dtype] * 1e6


def sdpa_forward(q, k, v, mask, rate):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=~mask[:, None, None, :], dropout_p=rate)


def library_backward_ms(q, k, v, mask, g, rate) -> float:
    """SDPA's backward at the same shape: fwd+bwd minus fwd, both as device
    time of CUDA graph replays (the port never calls SDPA)."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def forward():
        return sdpa_forward(*leaves, mask, rate)

    def forward_backward():
        for t in leaves:
            t.grad = None
        forward().backward(g)

    return device_ms(forward_backward) - device_ms(forward)


def check_case(fa, kernel: str, shape, dtype: str, rate: float, i: int) -> dict:
    """One kernel against its plain version at one case, with times; raises
    on a disagreement."""
    q, k, v, g, mask = attention_inputs(shape, DTYPES[dtype], seed=i)
    seed = dropout_seed(i, rate)
    out, lse = fa.flash_attention_forward(q, k, v, mask, seed, rate)
    if kernel == FWD:
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask, seed, rate)
        errs = {"out": excess(out, ref_out, ("fwd", dtype)), "lse": excess(lse, ref_lse, ("lse", dtype))}
        max_abs_err = (out.float() - ref_out).abs().max().item()
        call = lambda: fa.flash_attention_forward(q, k, v, mask, seed, rate)
        plain = lambda: fa.flash_attention_reference(q, k, v, mask, seed, rate)
        library = device_ms(lambda: sdpa_forward(q, k, v, mask, rate))
    else:
        grads = fa.flash_attention_backward(q, k, v, mask, out, lse, g, seed, rate)
        torch.cuda.synchronize()
        ref = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g, seed, rate)
        errs = {name: excess(a, b, ("bwd", dtype)) for name, a, b in zip(("dq", "dk", "dv"), grads, ref)}
        max_abs_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref))
        call = lambda: fa.flash_attention_backward(q, k, v, mask, out, lse, g, seed, rate)
        plain = lambda: fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g, seed, rate)
        library = library_backward_ms(q, k, v, mask, g, rate)
    row = {"kernel": kernel, "shape": shape, "dtype": dtype, "rate": rate, "max_abs_err": max_abs_err,
           "excess": errs, "kernel_ms": device_ms(call), "kernel_eager_ms": eager_ms(call),
           "plain_ms": device_ms(plain), "library_ms": library}
    bytes_us, ops_us = attention_bound(kernel, shape, DTYPES[dtype])
    row.update(bound_bytes_us=bytes_us, bound_ops_us=ops_us, bound_us=max(bytes_us, ops_us),
               bound_by="bytes" if bytes_us >= ops_us else "operations")
    log("kernel " + json.dumps(row))
    if not all(e <= 0 for e in errs.values()):
        raise AssertionError(f"{kernel} disagrees with its plain version at {shape} {dtype} dropout {rate}: "
                             f"excess over tolerance {errs}")
    return row


def check_dropout_masks(fa, b: int, h: int, sq: int, sk: int) -> None:
    """Read the kernels' dropout masks off exactly: with v = I the forward's
    out[i, j] is P_ij D_ij, with g = I the backward's dv[j, i] is too."""
    seed = (0xC0FFEE, sq * 100 + sk)
    want = fa.dropout_factor(seed, (b, h, sq, sk), DROPOUT, "cuda") > 0
    eye = lambda n: torch.eye(n, device="cuda").expand(b, h, n, n).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(sk)
    q, k = torch.randn(b, h, sq, sk, device="cuda", generator=gen), torch.randn(b, h, sk, sk, device="cuda", generator=gen)
    fwd_mask = fa.flash_attention_forward(q, k, eye(sk), None, seed, DROPOUT)[0] > 0
    q = torch.randn(b, h, sq, sq, device="cuda", generator=gen)
    k, v = (torch.randn(b, h, sk, sq, device="cuda", generator=gen) for _ in range(2))
    out, lse = fa.flash_attention_forward(q, k, v, None, seed, DROPOUT)
    bwd_mask = fa.flash_attention_backward(q, k, v, None, out, lse, eye(sq), seed, DROPOUT)[2].transpose(2, 3) > 0
    bad = int((fwd_mask != want).sum()), int((bwd_mask != want).sum())
    log(f"dropout masks at B={b} H={h} Sq={sq} Sk={sk}: {want.numel()} probabilities, keep rate "
        f"{want.float().mean().item()}, mismatches forward {bad[0]}, backward {bad[1]}")
    if bad != (0, 0):
        raise AssertionError(f"kernel dropout masks differ from the plain Philox mask: {bad}")


@contextlib.contextmanager
def main_path_run(fa):
    """One counted run of a main path: the launch counts start at 0 and are
    read at the end into ``run``; every launch's shape, dtype and dropout
    rate is tallied in ``PATH_SHAPES`` from the arguments the wrappers hand
    the kernels (the tally launches nothing)."""
    kernel_fn = fa._kernel_fn

    def tallying(name, n_pointers):
        fn = kernel_fn(name, n_pointers)

        def launch(*args):
            dims = tuple(args[1 + n_pointers: 6 + n_pointers])
            on, keep_scale = args[7 + n_pointers], args[11 + n_pointers]
            rate = round(1.0 - 1.0 / keep_scale, 6) if on else 0.0
            PATH_SHAPES[(name, dims, DTYPE_NAMES[args[0]], rate)] += 1
            return fn(*args)

        return launch

    run = {}
    fa.flash_attention_forward.launches = fa.flash_attention_backward.launches = 0
    with mock.patch.object(fa, "_kernel_fn", tallying):
        yield run
    run[FWD], run[BWD] = fa.flash_attention_forward.launches, fa.flash_attention_backward.launches


@contextlib.contextmanager
def plain_attention(fa):
    """Every attention call through the plain versions instead of the kernels."""
    with mock.patch.object(fa, "flash_attention_forward", fa.flash_attention_reference), \
            mock.patch.object(fa, "flash_attention_backward", fa.flash_attention_backward_reference):
        yield


def embeddings(batch, device="cuda"):
    """A batch's (text, audio, padding_mask) on the card; f32 embeddings."""
    return tuple(torch.as_tensor(batch[k]).to(device) for k in ("text", "audio", "padding_mask"))


def offline_phase(fa, card: str) -> dict:
    """Phase 4; returns the launches of the offline entry point."""
    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.models import M2FNet, init_random_, save_reference_checkpoint
    from mer_tpu_torch.serving import BatchedPredictor, recollate_batches
    from mer_tpu_torch.serving.engine import build_model, predict_fn

    config = load_config(CONFIG_PATH)
    batches = eval_entry.eval_batches(config, eval_entry.eval_dataset(config, synthetic=True))
    feed = [{k: b[k] for k in ("text", "audio", "padding_mask")} for b in batches]
    merged, _ = recollate_batches(feed, 512)
    n_utt = int(sum((b["emotion"] != -1).sum() for b in batches))
    per_forward = attention_calls_per_forward(config)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m2fnet.pth")
        model = init_random_(M2FNet.from_config(config.model), torch.Generator().manual_seed(0))
        save_reference_checkpoint(ckpt, model)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"offline: M2FNet default config, {n_params} parameters, checkpoint {os.path.getsize(ckpt)} bytes")

        launches = 0
        for extra, n_forward in (([], len(batches)), (["--serving-batch", "512"], len(merged))):
            with main_path_run(fa) as run:
                summary = eval_entry.main(["--synthetic", "--checkpoint", ckpt, *extra])
            launches += run[FWD]
            log(f"offline {extra or 'batch 32'}: {json.dumps(summary)}; kernel launches {run[FWD]} "
                f"= {per_forward} x {n_forward} forwards")
            if run[FWD] != per_forward * n_forward or run[BWD]:
                raise AssertionError(f"expected {per_forward * n_forward} attention launches, got {run}")

        f32 = build_model(config.override(tpu__compute_dtype="float32"), torch.device("cuda"), checkpoint=ckpt)
        bf16 = build_model(config, torch.device("cuda"), checkpoint=ckpt)

    def logits(model, feed_set):
        with torch.inference_mode():
            return [model(*embeddings(b)).float() for b in feed_set]

    for name, feed_set in (("batch 32", feed), ("serving batch 512", merged)):
        with_kernel = logits(f32, feed_set)
        with plain_attention(fa):
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
    log(f"offline bf16 vs f32 predictions agree on {agree}/{n_utt} utterances "
        f"(encoder skips in f32, as mer_tpu) ({card})")

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
        args = embeddings(b)
        with torch.inference_mode():
            eager, device = eager_ms(lambda: bf16(*args), iters=20), device_ms(lambda: bf16(*args), reps=1, replays=20)
            kernels, count = kernel_profile(lambda: bf16(*args))
        log(f"forward bf16 {name} {tuple(b['text'].shape)}: eager {eager} ms, device-only (CUDA graph replay) "
            f"{device} ms, device idle share of the eager forward {1 - device / eager} ({card})")
        log_profile(kernels, count)
    return launches


def attention_calls_per_forward(config) -> int:
    m = config.model
    return (int(m.AUDIO.n_encoder_layers) * int(m.AUDIO.n_transformers)
            + int(m.TEXT.n_encoder_layers) * int(m.TEXT.n_transformers) + int(m.FAM.n_layers))


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
    for e in prof.events():  # user annotations (Optimizer.step) span kernels already counted
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += not e.name.startswith(("Memcpy", "Memset"))
    return totals, count


def log_profile(kernels: dict[str, float], count: int) -> None:
    if not kernels:
        log("  profiler: no device activity recorded (kernel breakdown not measured)")
        return
    busy = sum(kernels.values())
    k1 = sum(t for n, t in kernels.items() if "flash_attention_fwd" in n)
    k2 = sum(t for n, t in kernels.items() if "flash_attention_bwd" in n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profiler: {count} kernels, {busy} us of kernels, K1 share {k1 / busy}, K2 share {k2 / busy}; top: "
        + "; ".join(f"{n[:60]} {t} us" for n, t in top))


def training_phase(fa, card: str) -> dict:
    """Phase 6; returns the launches of the training entry point."""
    import yaml

    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch import train as train_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.train import load_checkpoint
    from mer_tpu_torch.train.pipeline import build, parse_args

    config = load_config(CONFIG_PATH)
    per_forward = attention_calls_per_forward(config)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m2fnet.ckpt")

        def write_config(name, cfg):
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                yaml.safe_dump(cfg.override(checkpoint__save_path=ckpt, checkpoint__load_path=ckpt).to_dict(), f)
            return path

        cfg_path = write_config("config.yaml", config)
        argv = ["--synthetic", "--config", cfg_path]

        t0 = time.perf_counter()
        with main_path_run(fa) as run:
            state, history = train_entry.main([*argv, "--epochs", str(TRAIN_EPOCHS)])
        seconds = time.perf_counter() - t0
        _, batchers, solver = build(parse_args(argv))
        steps, val_batches = TRAIN_EPOCHS * len(batchers["train"]), TRAIN_EPOCHS * len(batchers["val"])
        want = {FWD: per_forward * (steps + val_batches), BWD: per_forward * steps}
        losses = history["loss_values"]
        log(f"training: {TRAIN_EPOCHS} epochs of {len(batchers['train'])} steps in {seconds} s (model build, "
            f"checkpoints and validation included); losses {json.dumps(history)}; launches {run} "
            f"(want {want}: {per_forward} K1 + {per_forward} K2 per step, {per_forward} K1 per validation batch)")
        if run != want:
            raise AssertionError(f"training launches {run}, want {want}")
        if len(losses) != TRAIN_EPOCHS or not all(math.isfinite(x) for x in losses + history["val_loss_values"]):
            raise AssertionError(f"training losses not finite or epochs missing: {history}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the last epoch's train loss {losses[-1]} is not below the first {losses[0]}")
        saved = load_checkpoint(ckpt)
        log(f"training checkpoint: epoch {saved['epoch']}, step {saved['extra']['step']}, "
            f"{os.path.getsize(ckpt)} bytes")
        summary = eval_entry.main(["--synthetic", "--config", cfg_path, "--checkpoint", ckpt])
        log(f"mer_tpu_torch.test --checkpoint on the trained checkpoint: {json.dumps(summary)}")
        if saved["extra"]["step"] != steps or not math.isfinite(summary["accuracy"]):
            raise AssertionError(f"checkpoint step {saved['extra']['step']} (want {steps}) or metrics {summary}")

        # throughput and one step's time split, on the default config (bf16)
        state = solver.init_state(len(batchers["train"]))
        n_utt = sum(int((torch.as_tensor(b["emotion"]) != -1).sum()) for b in batchers["train"])
        solver.train_epoch(state, batchers["train"])  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.train_epoch(state, batchers["train"])  # ends in a device-to-host fetch
            times.append(time.perf_counter() - t0)
        log(f"training bf16 epoch: {len(batchers['train'])} steps, {n_utt} utterances, median "
            f"{np.median(times) * 1e3} ms = {n_utt / np.median(times)} utterances/s ({card})")
        batch = next(iter(batchers["train"]))
        step = lambda: solver.train_epoch(state, [batch])
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        eager = (time.perf_counter() - t0) / 10 * 1e3
        kernels, count = kernel_profile(step)
        busy = sum(kernels.values()) / 1e3
        log(f"training step bf16 {tuple(batch['text'].shape)}: eager {eager} ms (forward, backward, Adam, loss "
            f"fetch), device busy {busy} ms, device idle share {1 - busy / eager if kernels else 'not measured'} "
            f"({card})")
        log_profile(kernels, count)

        # parity: 3 f32 dropout-0 steps through the kernels against the plain attention
        parity = parse_args(["--synthetic", "--config", write_config(
            "parity.yaml", config.override(tpu__compute_dtype="float32", model__dropout=0.0))])
        results = []
        for through in ("kernels", "plain"):
            _, batchers, solver = build(parity)
            state = solver.init_state(len(batchers["train"]))
            batches = list(batchers["train"])[:3]
            with plain_attention(fa) if through == "plain" else contextlib.nullcontext():
                step_losses = [solver.train_epoch(state, [b])[1] for b in batches]
            results.append((step_losses, {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    (k_losses, k_params), (p_losses, p_params) = results
    loss_diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    diffs = torch.cat([(k_params[n] - p_params[n]).abs().flatten() for n in k_params])
    lr = float(config.solver.lr)
    log(f"training parity f32 dropout 0, 3 steps, kernels vs plain attention: losses {k_losses} vs {p_losses}, "
        f"max diff {loss_diff} (tol 1e-4); params max diff {diffs.max().item()} (tol {2 * lr * 3}), "
        f"{int((diffs > lr / 50).sum())} of {diffs.numel()} beyond lr/50")
    if not (loss_diff <= 1e-4 and diffs.max().item() <= 2 * lr * 3 + 1e-6):
        raise AssertionError("training through the kernels departs from training through the plain attention")
    return run


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs one NVIDIA card")
    sys.path.insert(0, REPO)
    from mer_tpu_torch import serve as serve_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
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

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = [name for name, new in zip(KERNELS, pool.map(_build.build, KERNELS)) if new]
    log(f"build: {built or 'all kernels already built'} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions at the dialogue buckets
    cases = [(FWD, shape, dtype, 0.0) for shape in KERNEL_SHAPES for dtype in DTYPES]
    cases += [(kernel, shape, dtype, rate) for shape in KERNEL_SHAPES if shape[-1] == 96 for dtype in DTYPES
              for kernel, rate in ((FWD, DROPOUT), (BWD, 0.0), (BWD, DROPOUT))]
    rows = [check_case(fa, *case, i) for i, case in enumerate(cases)]
    for s in BUCKETS:
        check_dropout_masks(fa, 32, 8, s, s)

    # 4. offline evaluation, 5. online serving, 6. training: counts start at 0 for each path
    launches = {FWD: offline_phase(fa, card), BWD: 0}
    per_forward = attention_calls_per_forward(load_config(CONFIG_PATH))
    for n_requests in ONLINE_REQUESTS:
        with main_path_run(fa) as run:
            report = serve_entry.main(["--synthetic", "--requests", str(n_requests)])
        log(f"online {n_requests} requests: {run[FWD]} kernel launches, {report['batches']} micro-batches ({card})")
        if report["requests"] != n_requests or run[FWD] == 0 or run[FWD] % per_forward or run[BWD]:
            raise AssertionError(f"online serving answered {report['requests']}/{n_requests} requests "
                                 f"with launches {run}")
        launches[FWD] += run[FWD]
    for name, n in training_phase(fa, card).items():
        launches[name] += n
    for name in KERNELS:
        tallied = sum(n for (kernel, *_), n in PATH_SHAPES.items() if kernel == name)
        if tallied != launches[name]:
            raise AssertionError(f"{name}: {tallied} launches tallied, {launches[name]} counted")

    # 7. kernels against their plain versions at every case the paths gave them
    checked = {(r["kernel"], r["shape"], r["dtype"], r["rate"]) for r in rows}
    more = sorted({(kernel, shape, dtype, rate) for kernel, shape, _, rate in PATH_SHAPES
                   for dtype in DTYPES} - checked)
    rows += [check_case(fa, *case, len(rows) + i) for i, case in enumerate(more)]
    for b, h, sq, sk in sorted({shape[:4] for (kernel, shape, _, rate) in PATH_SHAPES if rate}):
        check_dropout_masks(fa, b, h, sq, sk)
    by_case = {(r["kernel"], r["shape"], r["dtype"], r["rate"]): r for r in rows}

    # 8. kernel line (times per launch, averaged over the main paths' launches
    # at their own shapes), then the device line last
    kernels = []
    for name in KERNELS:
        path = {case: n for case, n in PATH_SHAPES.items() if case[0] == name}
        for case, n in sorted(path.items()):
            r = by_case[case]
            log(f"main path {case}: {n} launches x kernel {r['kernel_ms']} ms (bound {r['bound_us'] / 1e3} ms)")
        total = {key: sum(n * by_case[case][key] for case, n in path.items())
                 for key in ("kernel_ms", "plain_ms", "library_ms", "bound_bytes_us", "bound_ops_us")}
        n = launches[name]
        log(f"{name} main path: {n} launches at {len(path)} cases; summed over them {json.dumps(total)} ({card})")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mer_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            "ms": total["kernel_ms"] / n,
            "plain_ms": total["plain_ms"] / n,
            "bound_ms": max(total["bound_bytes_us"], total["bound_ops_us"]) / 1e3 / n,
            "bound_by": "bytes" if total["bound_bytes_us"] >= total["bound_ops_us"] else "operations",
            "library_ms": total["library_ms"] / n,
            "shapes": {f"{dtype} {'x'.join(map(str, shape))} dropout {rate}": c
                       for (_, shape, dtype, rate), c in sorted(path.items())},
            "cases_checked": sum(r["kernel"] == name for r in rows),
            "card": card,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
