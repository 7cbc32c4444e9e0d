"""The yardstick's arithmetic: the card's peaks, the models' matrix FLOPs and
the kernels' least times.

Frozen copies, from commit 88254f0, of ``mer_tpu_torch/utils/profiling.py``
(the data-sheet peaks and the FLOP models: 2 FLOPs per multiply-add of
every matrix product and convolution; elementwise, softmax and norm work
left out) and of ``chip_smoke.py``'s ``attention_bound`` and ``w2v_bound``
(bytes at the HBM rate, each input read once and each output written once,
against FLOPs at the dtype's peak; the larger is the bound). Here they take
plain numbers, so that a later change to the program cannot move them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12  # tensor cores, bf16 (NVIDIA H100 SXM data sheet, dense, at 700 W)
PEAK_F32 = 67e12  # CUDA cores, float32
PEAK_TF32X3 = 495e12 / 3  # an f32 product as three TF32 products
ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
PEAK = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": PEAK_F32}

# the wav2vec2 conv frontend (ops/w2v_conv.py's geometry)
W2V_CHANNELS = 512
W2V_L0_TAPS, W2V_L0_STRIDE = 10, 5
W2V_TAIL_TAPS = (3, 3, 3, 3, 2, 2)
W2V_TAIL_STRIDES = (2, 2, 2, 2, 2, 2)


def transformer_encoder_flops(n_tokens: int, seq_len: int, d: int, dff: int, n_layers: int) -> float:
    """Post-LN encoder stack: per token per layer the q, k, v, out
    projections, the two FFN products and the score and PV products."""
    return float(n_layers) * n_tokens * (8 * d * d + 4 * d * dff + 4 * seq_len * d)


def conv_out_length(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


def wav2vec2_conv_flops(cfg: dict, n_samples: int) -> list[float]:
    """Each conv layer's FLOPs for one clip of ``n_samples``."""
    out, length, c_in = [], n_samples, 1
    for c_out, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        length = conv_out_length(length, k, s)
        out.append(max(length, 0) * 2.0 * k * c_in * c_out)
        c_in = c_out
    return out


def wav2vec2_frames(cfg: dict, n_samples: int) -> int:
    length = n_samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        length = conv_out_length(length, k, s)
    return max(length, 0)


def wav2vec2_forward_flops(cfg: dict, n_samples: int) -> float:
    """One clip of ``n_samples`` at its own length through the conv
    frontend, the feature projection, the positional conv and the encoder."""
    h = cfg["hidden_size"]
    frames = wav2vec2_frames(cfg, n_samples)
    fl = sum(wav2vec2_conv_flops(cfg, n_samples))
    fl += frames * 2.0 * cfg["conv_dim"][-1] * h
    fl += frames * 2.0 * cfg["num_conv_pos_embeddings"] * h * h / cfg["num_conv_pos_embedding_groups"]
    fl += transformer_encoder_flops(frames, frames, h, cfg["intermediate_size"], cfg["num_hidden_layers"])
    return fl


def classifier_head_flops(cfg: dict) -> float:
    """The Linear-Tanh-Linear head on one pooled vector."""
    h = cfg["hidden_size"]
    return 2.0 * (h * h + h * cfg["num_labels"])


def wav2vec2_train_flops(cfg: dict, n_samples: int) -> float:
    """A training step's FLOPs for one clip: the forward, and a backward at
    twice it, less the first conv's input gradient (the waveform needs none)."""
    fwd = wav2vec2_forward_flops(cfg, n_samples) + classifier_head_flops(cfg)
    return 3.0 * fwd - wav2vec2_conv_flops(cfg, n_samples)[0]


def roberta_forward_flops(cfg: dict, n_tokens: int) -> float:
    """One sequence of ``n_tokens`` through the encoder (embeddings are lookups)."""
    return transformer_encoder_flops(n_tokens, n_tokens, cfg["hidden_size"], cfg["intermediate_size"],
                                     cfg["num_hidden_layers"])


def m2fnet_forward_flops(cfg: dict, n_utterances: int) -> float:
    """One dialogue of ``n_utterances`` through M2FNet: both modality stacks,
    the projections, the fusion layers and the classifier."""
    u = n_utterances
    fl = 0.0
    for mod in ("AUDIO", "TEXT"):
        m = cfg[mod]
        fl += m["n_transformers"] * transformer_encoder_flops(u, u, m["embedding_size"], cfg["dim_feedforward"],
                                                              m["n_encoder_layers"])
        fl += u * 2.0 * m["embedding_size"] * cfg["FAM"]["embedding_size"]
    d = cfg["FAM"]["embedding_size"]
    fl += cfg["FAM"]["n_layers"] * u * (8 * d * d + 4 * u * d + 4 * d * d)
    c = cfg["CLASSIFIER"]
    fl += u * 2.0 * (2 * d * c["hidden_size"] + c["hidden_size"] * c["output_size"])
    return fl


def attention_bound_s(forward: bool, b: int, h: int, sq: int, sk: int, dh: int, dtype: str) -> float:
    """Least seconds of one attention call: a forward reads q, k, v and the
    key mask and writes out and the row statistics (2 products); a backward
    reads q, k, v, out, g, the statistics and the mask and writes dq, dk, dv
    (5 products). f32 at head dim 64 counts at the 3xTF32 rate (the port's
    forward and its key-tiled backward), other f32 at the CUDA-core rate."""
    esize = ESIZE[dtype]
    rows_q, rows_k = (2, 2) if forward else (4, 4)
    nbytes = (rows_q * b * h * sq * dh + rows_k * b * h * sk * dh) * esize + b * h * sq * 4 + b * sk
    flops = (4 if forward else 10) * b * h * sq * sk * dh
    tf32 = dtype == "float32" and dh == 64 and (forward or sk > 33)
    return max(nbytes / HBM_BYTES_PER_S, flops / (PEAK_TF32X3 if tf32 else PEAK[dtype]))


def w2v_tail_lengths(t0: int) -> list[int]:
    out, t = [], t0
    for k, s in zip(W2V_TAIL_TAPS, W2V_TAIL_STRIDES):
        t = conv_out_length(t, k, s)
        out.append(t)
    return out


def w2v_layer0_bound_s(b: int, n_samples: int, dtype: str) -> float:
    """Least seconds of the first conv with its GroupNorm and GELU on [b,
    n_samples]: the wave, taps, gain and shift in, [b, T0, 512] out; 2 x 10 x
    512 FLOPs a frame and 8 a value for the statistics, affine and GELU."""
    esize, c = ESIZE[dtype], W2V_CHANNELS
    t0 = conv_out_length(n_samples, W2V_L0_TAPS, W2V_L0_STRIDE)
    nbytes = (b * n_samples + W2V_L0_TAPS * c + b * t0 * c) * esize + 2 * c * 4
    flops = b * t0 * c * (2 * W2V_L0_TAPS + 8)
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK[dtype])


def w2v_tail_bound_s(b: int, t0: int, dtype: str) -> float:
    """Least seconds of conv layers 1-6 on [b, t0, 512]: the input and the
    weights in, the last layer's frames out; 2 x k x 512 x 512 FLOPs a frame
    of each layer (f32 at the 3xTF32 rate)."""
    esize, c = ESIZE[dtype], W2V_CHANNELS
    lengths = w2v_tail_lengths(t0)
    nbytes = (b * t0 * c + sum(W2V_TAIL_TAPS) * c * c + b * lengths[-1] * c) * esize
    flops = 2.0 * c * c * b * sum(k * t for k, t in zip(W2V_TAIL_TAPS, lengths))
    peak = PEAK_TF32X3 if dtype == "float32" else PEAK[dtype]
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)
