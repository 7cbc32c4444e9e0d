"""Time the port's attention kernels against PyTorch's SDPA at the workload's
shapes (counterpart of ``scripts/bench_attention.py``).

    python -m mer_tpu_torch.scripts.bench_attention [--shapes NAME,...] [--dtypes float32,bfloat16]
        [--device cuda|cpu]

The shapes are ``mer_tpu``'s list (RoBERTa windows of 64-512 tokens, wav2vec2
at 499 and 512 frames, the long-audio axis 1,024-8,192 frames) plus one clip of
16,384 frames, each with a 10% key mask drawn from seed 0. For each shape and
dtype: the forward and the forward + backward through the port (whichever
kernels the dispatch by key count picks, named: K1 or K3 forward, K2 or K4
backward), the same two through ``F.scaled_dot_product_attention`` with the
same mask (a yardstick: the port never calls it), and the least time of each
from bytes at 3.35 TB/s and products at 989 (bf16) or 67 (f32) TFLOP/s, the
H100 SXM data sheet's. On the card times are device time per call: calls
captured in a CUDA graph and replayed between CUDA events, or, above 100
GFLOP a forward, eager calls between CUDA events; on the CPU the host clock,
labelled so. One JSON line per shape and dtype.

    python -m mer_tpu_torch.scripts.bench_attention --crossover [--device cuda|cpu]

times, instead, the kernels on either side of the two dispatch thresholds on
the same inputs, bf16, the same 10% key mask, dropout 0 and 0.1: the
single-pass forward K1 against the streaming K3 at the fusion buckets (S 8-33,
Dh 96) and at 4,096 keys (Dh 64, where both launch one design;
``CROSSOVER_FORWARD``), the fused
backward K2 against the key-tiled K4 at the fusion buckets, at 48-499 keys
(B 16, the text and wav2vec2 fine-tune batches) and at 512-2,048
(``CROSSOVER_BACKWARD``), each kernel's own wrapper called whatever the
dispatch would pick (K2's: ``flash_attention_fused_backward``). One JSON line
per key count and rate, both kernels named. ``STREAM_THRESHOLD`` and
``BWD_FUSED_MAX`` rest on these rows. K1 is timed only up to
``STREAM_THRESHOLD``: its wrapper hands longer calls to K3. Then K1's two
bf16 designs at head dim 64 on the same inputs (``CROSSOVER_DESIGNS``: the
RoBERTa and wav2vec2 export batch of 32 at 64-499 keys, and 1,024 keys):
the template (reached through the route argument of K1's C entry, a hook for
this comparison) against the Hopper forward the dispatch takes, with SDPA's
bf16 forward and the template on inputs one element off 16-byte alignment
(``template_unaligned_ms``, the only way to it without the hook: its
element-wise loads, not the aligned template's cp.async) beside them.

    python -m mer_tpu_torch.scripts.bench_attention --digest [--device cuda|cpu]

prints, instead, the sha256 of the out and lse bytes of K1 at [2, 12, 499,
499, 64] and K3 at [2, 12, 4499, 4499, 64] (``DIGEST_CASES``), f32 and bf16,
dropout 0 and 0.1, on seeded inputs with the same 10% key mask: two builds
that print the same digest compute the same bits. Run this file with
``PYTHONPATH`` set to another checkout to digest that checkout's kernels.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.serving.engine import resolve_device
from mer_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_TF32X3

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (name, B, H, S, Dh): scripts/bench_attention.py:67-80, then 16,384 frames
SHAPES = [
    ("roberta_b32_s64", 32, 12, 64, 64),
    ("roberta_b32_s128", 32, 12, 128, 64),
    ("roberta_b32_s256", 32, 12, 256, 64),
    ("wav2vec2_b8_s499", 8, 12, 499, 64),
    ("roberta_512", 8, 12, 512, 64),
    ("wav2vec2_512", 8, 12, 512, 64),
    ("long_1024", 8, 12, 1024, 64),
    ("long_2048", 8, 12, 2048, 64),
    ("long_4096", 4, 12, 4096, 64),
    ("long_8192", 2, 12, 8192, 64),
    ("long_16384", 1, 12, 16384, 64),
]
KEY_MASK_FRACTION = 0.1  # scripts/bench_attention.py:85
# (B, H, S, Dh): the fusion model's dialogue buckets (S 8-33, where K1 and K2 take several (b*h) slices a block
# up to 32 rows), then B*H 96-24 at Dh 64 up to K2's kernel range (FUSED_KERNEL_MAX, 2,048); the backward also at
# the text and wav2vec2 fine-tune batch (16 x 12 heads) at 48-499 keys, 48 closing the gap above the dialogue
# buckets. The forward at Dh 64 only at STREAM_THRESHOLD (4,096 keys): K1 and K3 launch one design there, and
# timed alike at every Dh-64 row of 256-4,096 keys (0.98-1.00 when the crossover still ran those rows)
FUSION_ROWS = [(32, 8, s, 96) for s in (8, 16, 24, 33)]
CROSSOVER_FORWARD = FUSION_ROWS + [(2, 12, 4096, 64)]
CROSSOVER_BACKWARD = FUSION_ROWS + [(16, 12, s, 64) for s in (48, 64, 128, 256, 499)] + [
    (8, 12, 512, 64), (4, 12, 1024, 64), (2, 12, 2048, 64)]
# (B, H, S, Dh): K1's template against its Hopper forward (bf16, Dh 64)
CROSSOVER_DESIGNS = [(32, 12, s, 64) for s in (64, 99, 128, 199, 256, 499)] + [(8, 12, 1024, 64)]
CROSSOVER_RATES = (0.0, 0.1)
# --digest: (kernel, B, H, Sq, Sk) at head dim 64: K1 at the wav2vec2 export's frames, K3 at the 90 s clips'
DIGEST_CASES = [("K1", 2, 12, 499, 499), ("K3", 2, 12, 4499, 4499)]


def kernel_names(s: int) -> tuple[str, str]:
    """(forward, backward) kernels the dispatch picks at ``s`` keys."""
    return ("K3" if s > fa.STREAM_THRESHOLD else "K1"), ("K4" if s > fa.BWD_FUSED_MAX else "K2")


def bound_ms(b: int, h: int, s: int, dh: int, dtype: torch.dtype, backward: bool) -> tuple[float, str]:
    """Least time (ms) of the forward, or of forward + backward, and what sets
    it: each input read once and each output written once at the HBM rate
    (forward: q, k, v, mask -> out, lse; backward: q, k, v, out, g, lse, mask
    -> dq, dk, dv), against the products at the dtype's dense peak (2 in the
    forward, 5 in the backward; f32 at head dim 64, the 3xTF32 designs of K1,
    K3 and K4, at ``PEAK_TF32X3``)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    tensor, stats, mask = b * h * s * dh * esize, b * h * s * 4, b * s
    nbytes = 4 * tensor + stats + mask
    rate = PEAK_TF32X3 if dtype == torch.float32 and dh == 64 else PEAK_FLOPS[dtype]
    seconds = 4 * b * h * s * s * dh / rate
    if backward:  # K4 (above BWD_FUSED_MAX keys, every bench shape) at head dim 64 in f32: 3xTF32 as well
        nbytes += 8 * tensor + stats + mask
        seconds += 10 * b * h * s * s * dh / (rate if s > fa.BWD_FUSED_MAX else PEAK_FLOPS[dtype])
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, seconds * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def device_ms(fn, reps: int, replays: int) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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


def events_ms(fn, reps: int) -> float:
    """Time per call of ``reps`` eager calls between CUDA events, after one
    warm-up call: at the long shapes a call takes milliseconds and the host's
    launch cost is noise."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def timing_inputs(b: int, h: int, s: int, dh: int, dtype: torch.dtype, device: torch.device):
    """q, k, v, g [b, h, s, dh] of unit normals in ``dtype`` and a key mask [b, s] ignoring each key with
    probability ``KEY_MASK_FRACTION``, drawn from seed 0 on ``device`` (on the card in milliseconds where numpy
    takes seconds at the long shapes)."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, g = (torch.randn(b, h, s, dh, generator=gen, device=device).to(dtype) for _ in range(4))
    return q, k, v, g, torch.rand(b, s, generator=gen, device=device) < KEY_MASK_FRACTION


def bench_shape(name: str, b: int, h: int, s: int, dh: int, dtype: torch.dtype, device: torch.device) -> dict:
    q, k, v, g, mask = timing_inputs(b, h, s, dh, dtype, device)
    attend = ~mask[:, None, None, :]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def grads_of(forward):
        def step():
            for t in leaves:
                t.grad = None
            forward().backward(g)
        return step

    port_forward = lambda: fa.FlashAttention.apply(*leaves, mask, None, 0.0)[0]
    sdpa_forward = lambda: torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=attend)
    flops = 4 * b * h * s * s * dh
    if device.type != "cuda":
        timer = lambda fn: host_ms(fn, 1)
    elif flops > 1e11:
        timer = lambda fn: events_ms(fn, 2)
    else:
        timer = lambda fn: device_ms(fn, 5, 4)
    row = {"shape": name, "B": b, "H": h, "S": s, "Dh": dh, "dtype": str(dtype).removeprefix("torch."),
           "clock": "device" if device.type == "cuda" else "host (cpu)"}
    fwd_name, bwd_name = kernel_names(s)
    row["kernels"] = f"{fwd_name} + {bwd_name}"
    with torch.no_grad():
        row["kernel_fwd_ms"] = timer(port_forward)
    row["kernel_fwdbwd_ms"] = timer(grads_of(port_forward))
    try:
        with torch.no_grad():
            row["sdpa_fwd_ms"] = timer(sdpa_forward)
        row["sdpa_fwdbwd_ms"] = timer(grads_of(sdpa_forward))
    except torch.OutOfMemoryError:  # the yardstick only; the port's numbers stand without it
        row.setdefault("sdpa_fwd_ms", None)
        row["sdpa_fwdbwd_ms"] = None
        torch.cuda.empty_cache()
    row["bound_fwd_ms"], row["bound_fwd_by"] = bound_ms(b, h, s, dh, dtype, backward=False)
    row["bound_fwdbwd_ms"], row["bound_fwdbwd_by"] = bound_ms(b, h, s, dh, dtype, backward=True)
    return row


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:].copy_(t.reshape(-1))
    return flat[1:].view(t.shape)


def crossover_row(direction: str, b: int, h: int, s: int, dh: int, rate: float, device: torch.device) -> dict:
    """Both kernels of one side of a threshold at ``s`` keys on the same
    inputs: K1 against K3 (``direction`` "forward") or K2 against K4
    ("backward"), or K1's template against its Hopper forward ("designs",
    SDPA's forward beside them), bf16, device ms per call (host ms on the
    CPU)."""
    dtype = torch.bfloat16
    q, k, v, g, mask = timing_inputs(b, h, s, dh, dtype, device)
    seed = (0x5EED, s) if rate else None
    timer = (lambda fn: device_ms(fn, 5, 4)) if device.type == "cuda" else (lambda fn: host_ms(fn, 1))
    row = {"direction": direction, "B": b, "H": h, "S": s, "Dh": dh, "dtype": "bfloat16", "dropout": rate,
           "clock": "device" if device.type == "cuda" else "host (cpu)"}
    if direction == "forward":
        names, calls = ("K1", "K3"), (fa.flash_attention_forward, fa.flash_attention_stream)
        if s > fa.STREAM_THRESHOLD:
            raise ValueError(f"K1 takes at most STREAM_THRESHOLD = {fa.STREAM_THRESHOLD} keys, not {s}")
        fns = [lambda c=c: c(q, k, v, mask, seed, rate) for c in calls]
    elif direction == "designs":
        names = ("template", "K1")
        k1 = lambda: fa.flash_attention_forward(q, k, v, mask, seed, rate)
        # on the card the template through the route argument of K1's C entry; on the CPU both are the plain version
        fns = [(lambda: fa._k1(q, k, v, mask, seed, rate, route=0)) if device.type == "cuda" else k1, k1]
        # the template as a caller reaches it without the hook: q, k, v one element off 16-byte alignment
        views = [unaligned(t) for t in (q, k, v)]
        row["template_unaligned_ms"] = timer(lambda: fa.flash_attention_forward(*views, mask, seed, rate))
        row["sdpa_ms"] = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=~mask[:, None, None, :], dropout_p=rate))
    else:
        names, calls = ("K2", "K4"), (fa.flash_attention_fused_backward, fa.flash_attention_tiled_backward)
        out, lse = fa.flash_attention_stream(q, k, v, mask, seed, rate)
        fns = [lambda c=c: c(q, k, v, mask, out, lse, g, seed, rate) for c in calls]
    for name, fn in zip(names, fns):
        row[f"{name}_ms"] = timer(fn)
    row["kernels"] = f"{names[0]} | {names[1]}"
    row["faster"] = names[0] if row[f"{names[0]}_ms"] <= row[f"{names[1]}_ms"] else names[1]
    return row


def crossover(device: torch.device) -> list[dict]:
    """The rows of ``--crossover``: K1 | K3 at ``CROSSOVER_FORWARD`` key
    counts up to the forward's threshold, K2 | K4 at ``CROSSOVER_BACKWARD``,
    K1's template | its Hopper forward at ``CROSSOVER_DESIGNS``."""
    rows = []
    for direction, shapes in (("forward", CROSSOVER_FORWARD), ("backward", CROSSOVER_BACKWARD),
                              ("designs", CROSSOVER_DESIGNS)):
        for b, h, s, dh in shapes:
            for rate in CROSSOVER_RATES:
                rows.append(crossover_row(direction, b, h, s, dh, rate, device))
                print(json.dumps(rows[-1]), flush=True)
    return rows


def digest(device: torch.device) -> list[dict]:
    """The rows of ``--digest``: per case, dtype and dropout rate the sha256
    of out's and lse's bytes."""
    rows = []
    for name, b, h, sq, sk in DIGEST_CASES:
        call = fa.flash_attention_forward if name == "K1" else fa.flash_attention_stream
        rng = np.random.default_rng(0)
        q, k, v = (rng.normal(size=(b, h, n, 64)).astype(np.float32) for n in (sq, sk, sk))
        mask = torch.from_numpy(rng.random((b, sk)) < KEY_MASK_FRACTION).to(device)
        for dtype_name, dtype in DTYPES.items():
            tensors = [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)]
            for rate in CROSSOVER_RATES:
                out, lse = call(*tensors, mask, (0x5EED, sk) if rate else None, rate)
                sha = hashlib.sha256(out.float().cpu().numpy().tobytes())
                sha.update(lse.cpu().numpy().tobytes())
                rows.append({"kernel": name, "B": b, "H": h, "Sq": sq, "Sk": sk, "Dh": 64, "dtype": dtype_name,
                             "dropout": rate, "sha256": sha.hexdigest()})
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.scripts.bench_attention")
    p.add_argument("--shapes", default=",".join(n for n, *_ in SHAPES), help="comma-separated shape names")
    p.add_argument("--dtypes", default="float32,bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--crossover", action="store_true",
                   help="time K1 | K3 and K2 | K4 on either side of the dispatch thresholds instead")
    p.add_argument("--digest", action="store_true", help="print the sha256 of K1's and K3's outputs instead")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.digest:
        return digest(device)
    if args.crossover:
        print(f"attention crossover on {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
        return crossover(device)
    wanted = args.shapes.split(",")
    unknown = set(wanted) - {n for n, *_ in SHAPES}
    if unknown:
        raise SystemExit(f"unknown shapes {sorted(unknown)}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock, no device time)"
    print(f"attention bench on {where}")
    rows = []
    for name, b, h, s, dh in SHAPES:
        if name not in wanted:
            continue
        for dtype_name in args.dtypes.split(","):
            rows.append(bench_shape(name, b, h, s, dh, DTYPES[dtype_name], device))
            print(json.dumps(rows[-1]), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
