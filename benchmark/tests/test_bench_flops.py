"""The yardstick's FLOP and byte counts against hand counts at small shapes."""

import math

import pytest

from benchmark.harness import flops

TINY = {"conv_dim": [2, 2], "conv_kernel": [3, 2], "conv_stride": [2, 2], "hidden_size": 4,
        "intermediate_size": 8, "num_hidden_layers": 1, "num_conv_pos_embeddings": 2,
        "num_conv_pos_embedding_groups": 2, "num_labels": 3}


def test_encoder_flops():
    # 2 tokens, 3 keys, d 4, dff 8, one layer: 8 d^2 + 4 d dff + 4 L d per token
    assert flops.transformer_encoder_flops(2, 3, 4, 8, 1) == 2 * (8 * 16 + 4 * 4 * 8 + 4 * 3 * 4)


def test_wav2vec2_flops():
    # 11 samples: conv 0 (k 3, s 2) -> 5 frames of 2 x 3 x 1 x 2; conv 1 (k 2, s 2) -> 2 frames of 2 x 2 x 2 x 2
    assert flops.wav2vec2_conv_flops(TINY, 11) == [5 * 12.0, 2 * 16.0]
    frames = 2
    projection = frames * 2 * 2 * 4
    pos = frames * 2 * 2 * 4 * 4 / 2
    encoder = flops.transformer_encoder_flops(frames, frames, 4, 8, 1)
    assert flops.wav2vec2_forward_flops(TINY, 11) == 5 * 12 + 2 * 16 + projection + pos + encoder
    head = 2 * (16 + 12)
    assert flops.wav2vec2_train_flops(TINY, 11) == 3 * (flops.wav2vec2_forward_flops(TINY, 11) + head) - 60


def test_m2fnet_flops():
    cfg = {"dim_feedforward": 8, "AUDIO": {"n_transformers": 1, "embedding_size": 4, "n_encoder_layers": 1},
           "TEXT": {"n_transformers": 1, "embedding_size": 4, "n_encoder_layers": 1},
           "FAM": {"embedding_size": 4, "n_layers": 1}, "CLASSIFIER": {"hidden_size": 4, "output_size": 3}}
    u = 3
    per_mod = flops.transformer_encoder_flops(u, u, 4, 8, 1) + u * 2 * 16
    fam = u * (8 * 16 + 4 * u * 4 + 4 * 16)
    head = u * 2 * (2 * 4 * 4 + 4 * 3)
    assert flops.m2fnet_forward_flops(cfg, u) == 2 * per_mod + fam + head


@pytest.mark.parametrize("forward", [True, False])
def test_attention_bound(forward):
    b, h, sq, sk, dh = 1, 2, 3, 5, 8
    rows = 2 if forward else 4
    nbytes = (rows * b * h * sq * dh + rows * b * h * sk * dh) * 2 + b * h * sq * 4 + b * sk
    fl = (4 if forward else 10) * b * h * sq * sk * dh
    want = max(nbytes / 3.35e12, fl / 989e12)
    assert math.isclose(flops.attention_bound_s(forward, b, h, sq, sk, dh, "bfloat16"), want)
    # a long-key call is bound by its products
    big = flops.attention_bound_s(forward, 2, 12, 4499, 4499, 64, "bfloat16")
    assert math.isclose(big, (4 if forward else 10) * 2 * 12 * 4499 * 4499 * 64 / 989e12)


def test_frontend_bounds():
    b, n = 2, 16000
    t0 = (n - 10) // 5 + 1
    nbytes = (b * n + 10 * 512 + b * t0 * 512) * 2 + 2 * 512 * 4
    assert math.isclose(flops.w2v_layer0_bound_s(b, n, "bfloat16"),
                        max(nbytes / 3.35e12, b * t0 * 512 * 28 / 989e12))
    lengths = flops.w2v_tail_lengths(t0)
    assert lengths[0] == (t0 - 3) // 2 + 1 and len(lengths) == 6
    fl = 2 * 512 * 512 * b * sum(k * t for k, t in zip((3, 3, 3, 3, 2, 2), lengths))
    nbytes = (b * t0 * 512 + 16 * 512 * 512 + b * lengths[-1] * 512) * 2
    assert math.isclose(flops.w2v_tail_bound_s(b, t0, "bfloat16"), max(nbytes / 3.35e12, fl / 989e12))
