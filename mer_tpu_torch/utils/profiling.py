"""Profiling, the analytic FLOP models, and the card's peaks.

Counterpart of ``mer_tpu/utils/profiling.py``: :func:`trace` captures a
``torch.profiler`` trace (CPU, and CUDA when a card is present) into a
directory as a Chrome trace, with the port's spans (``utils/tracing.py``)
of every thread; the FLOP models count the matrix FLOPs (2 per
multiply-add) of each pipeline's forward from the model's dims, so a bench
can report achieved TFLOP/s and the share of the card's peak (:func:`mfu`).
Elementwise, softmax and LayerNorm work is excluded, as MFU conventionally
does; a backward is about twice its forward.

The card's peaks live here and nowhere else in the port: the NVIDIA H100 SXM
data sheet's dense rates, which assume the card's full 700 W power limit (a
card set lower runs slower under load: report ``nvidia-smi``'s power limit
beside any share of these). ``chip_smoke.py`` and the scripts import them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from mer_tpu_torch.utils import tracing

CARD = "NVIDIA H100 SXM"  # the part the peaks below are for (data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12  # tensor cores, bf16 and fp16
PEAK_F32 = 67e12  # CUDA cores, float32 FMA
PEAK_TF32 = 495e12  # tensor cores, TF32
# An f32 product as three TF32 products (3xTF32: lo hi + hi lo + hi hi), the f32 rate of K1, K3, K4 and K6's
# f32 designs at head dim 64 (K6: every f32 call)
PEAK_TF32X3 = PEAK_TF32 / 3
PEAK_INT8 = 1979e12  # tensor cores, int8 (TOP/s)
PEAK_FLOPS = {torch.bfloat16: PEAK_BF16, torch.float32: PEAK_F32}  # each dtype's plain rate


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the body into ``log_dir`` as a
    Chrome trace (``trace_<pid>_<ns>.json``; CUDA activity too when a card is
    present), yielding the profiler; a no-op yielding None when ``log_dir`` is
    None or empty. The spans of threads the profiler does not record (the
    prefetcher's producer) are written into the file on their own ``tid``,
    placed on the trace's clock by the spans it did record
    (:func:`write_thread_spans`)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    tracing.reset()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    write_thread_spans(path, tracing.spans())


def write_thread_spans(path: str, records) -> int:
    """Add to the Chrome trace at ``path`` each finished span of ``records``
    whose name has no event there (``mer.<name>``: the threads the profiler
    did not record), as a complete event on its thread's ``tid`` with its
    ``attrs`` as ``args``, and name those threads. Returns the number added
    (0 where no span of the trace's own pairs with an event: nothing places
    the others)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    # the host's ranges; a range's copy on a card's timeline ("gpu_user_annotation") starts when its kernels do
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    found = tracing.clock_offset_us(records, ((e["name"], e["ts"]) for e in ranges))
    if found is None:
        return 0
    offset = found[0]
    named = {e["name"] for e in ranges}
    pid = next(e["pid"] for e in ranges if e["name"].startswith(tracing.PREFIX))
    added, threads = 0, {}
    for r in records:
        if r.end_ns is None or tracing.PREFIX + r.name in named:
            continue
        threads[r.thread] = r.thread_name
        events.append({"ph": "X", "cat": "mer_span", "name": tracing.PREFIX + r.name, "pid": pid, "tid": r.thread,
                       "ts": r.start_ns / 1000.0 + offset, "dur": (r.end_ns - r.start_ns) / 1000.0,
                       "args": dict(r.attrs)})
        added += 1
    for tid, name in threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"{name} (mer spans)"}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return added


# -- analytic FLOP accounting (MFU) ------------------------------------------------------


def transformer_encoder_flops(n_tokens: int, seq_len: int, d: int, dff: int, n_layers: int) -> float:
    """Post-LN encoder stack: per token per layer 4 d^2-projections (q, k,
    v, out) + 2 FFN matmuls (d <-> dff), plus score / PV attention math (2
    matmuls over seq_len)."""
    per_token_layer = 8 * d * d + 4 * d * dff + 4 * seq_len * d
    return float(n_layers) * n_tokens * per_token_layer


def _encoder_dims(encoders) -> tuple[int, int, int, int]:
    """(count, d_model, dim_feedforward, layers) of a modality's stack of ``TransformerEncoder``s."""
    layer = encoders[0].layers[0]
    return len(encoders), layer.linear1.in_features, layer.linear1.out_features, len(encoders[0].layers)


def m2fnet_forward_flops(model, batch_dialogues: int, dialogue_len: int) -> float:
    """Matmul FLOPs of one M2FNet forward (``models/m2fnet.py``) over a [B,
    U, .] batch, from the model's own modules."""
    tokens = batch_dialogues * dialogue_len
    fl = 0.0
    for enabled, encoders, proj in ((model.audio_enabled, getattr(model, "audio_encoders", None),
                                     getattr(model, "audio_proj", None)),
                                    (model.text_enabled, getattr(model, "text_encoders", None),
                                     getattr(model, "text_proj", None))):
        if enabled:
            n, d, dff, layers = _encoder_dims(encoders)
            fl += n * transformer_encoder_flops(tokens, dialogue_len, d, dff, layers)
            fl += tokens * 2 * proj.in_features * proj.out_features
    first, last = model.output_layer[0], model.output_layer[-1]
    if model.fam_enabled:
        d = model.audio_proj.out_features  # the fusion width (FAM needs both modalities)
        # FAM layer: 4 d^2 projections + score/PV + Linear(2d -> d)
        fl += len(model.fusion_layers) * tokens * (8 * d * d + 4 * dialogue_len * d + 4 * d * d)
    fl += tokens * 2 * (first.in_features * first.out_features + last.in_features * last.out_features)
    return fl


def roberta_forward_flops(cfg, batch: int, seq_len: int, with_head: bool = False) -> float:
    """RoBERTa encoder forward (``models/roberta.py``, a ``RobertaConfig``);
    embeddings are lookups (no matmul FLOPs)."""
    fl = transformer_encoder_flops(batch * seq_len, seq_len, cfg.hidden_size, cfg.intermediate_size,
                                   cfg.num_hidden_layers)
    if with_head:
        fl += batch * 2 * (cfg.hidden_size * cfg.hidden_size + cfg.hidden_size * cfg.num_labels)
    return fl


def wav2vec2_forward_flops(cfg, batch: int, n_samples: int) -> float:
    """wav2vec2 conv frontend + encoder forward (``models/wav2vec2.py``, a
    ``Wav2Vec2Config``). Conv FLOPs: per output frame 2 k c_in c_out per
    layer."""
    fl = 0.0
    length, c_in = n_samples, 1
    for c_out, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
        fl += batch * length * 2 * k * c_in * c_out
        c_in = c_out
    frames = length
    fl += batch * frames * 2 * c_in * cfg.hidden_size  # feature projection
    # positional conv embedding (grouped conv)
    fl += batch * frames * 2 * cfg.num_conv_pos_embeddings * cfg.hidden_size * \
        cfg.hidden_size / cfg.num_conv_pos_embedding_groups
    fl += transformer_encoder_flops(batch * frames, frames, cfg.hidden_size, cfg.intermediate_size,
                                    cfg.num_hidden_layers)
    return fl


def mfu(flops: float, seconds: float, peak: float = PEAK_BF16) -> tuple[float, float]:
    """(achieved TFLOP/s, fraction of ``peak``; by default the card's dense
    bf16 peak)."""
    achieved = flops / max(seconds, 1e-12)
    return achieved / 1e12, achieved / peak
