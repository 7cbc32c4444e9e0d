"""The port's wav2vec2 model against the JAX package's, on the CPU.

The conv stack keeps the base geometry (512 channels, so the conv frontend is
the one the kernels serve) over a narrow transformer: 2 layers, hidden 64,
4 heads, FFN 128, positional conv k = 16 in 4 groups. Weights are ``mer_tpu``'s
initial ones with numpy-seeded noise on every leaf (so no bias is 0 and no norm
the identity), carried over by ``audio_state_dict_from_jax``; waveforms are
numpy-seeded, at most 8,000 samples, with ragged lengths.

- ``audio_state_dict_from_jax`` reads both encoder layouts and is the inverse
  of ``convert_hf_wav2vec2``, weight-norm fold included;
- logits and ``embed`` within 1e-4 of ``mer_tpu``'s in f32 (rtol and atol);
- garbage in the padded samples does not move a fully valid clip;
- a clip of 0 samples and one shorter than the receptive field give what
  ``mer_tpu`` gives: no valid frame, a zero embedding, finite logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu_torch.models import audio_state_dict_from_jax
from mer_tpu_torch.models.wav2vec2 import (
    AudioERC,
    Wav2Vec2Config,
    audio_erc_from_seed,
    fold_pos_conv_weight_norm,
)

NARROW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
CFG = Wav2Vec2Config(**NARROW)
JAX_CFG = jax_w2v.Wav2Vec2Config(**NARROW)
WIDTH = 8000


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _waves(lengths, seed=0):
    rng = np.random.default_rng(seed)
    waves = rng.normal(size=(len(lengths), WIDTH)).astype(np.float32) * 0.1
    for i, n in enumerate(lengths):
        waves[i, n:] = 0.0
    return waves, np.asarray(lengths, np.int32)


@pytest.fixture(scope="module")
def models():
    """(mer_tpu's AudioERC, its params as numpy, the port's model holding them)."""
    jax_model = jax_w2v.AudioERC(JAX_CFG)
    waves, lengths = _waves([WIDTH, WIDTH])
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(waves[:, :800]), jnp.asarray(lengths))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    port = AudioERC(CFG)
    port.load_state_dict(audio_state_dict_from_jax(params), strict=True)
    return jax_model, params, port.eval()


def _both(models, waves, lengths):
    """((logits, embeddings) of mer_tpu, of the port)."""
    jax_model, params, port = models
    args = jnp.asarray(waves), jnp.asarray(lengths)
    want = (np.asarray(jax_model.apply({"params": params}, *args)),
            np.asarray(jax_model.apply({"params": params}, *args, method=jax_w2v.AudioERC.embed)))
    with torch.no_grad():
        t_args = torch.from_numpy(waves), torch.from_numpy(lengths)
        got = port(*t_args).numpy(), port.embed(*t_args).numpy()
    return want, got


def test_config_and_output_lengths_equal_jax():
    assert Wav2Vec2Config.base() == Wav2Vec2Config()
    for field in ("conv_dim", "conv_kernel", "conv_stride", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "intermediate_size", "num_conv_pos_embeddings",
                  "num_conv_pos_embedding_groups", "layer_norm_eps", "num_labels"):
        assert getattr(Wav2Vec2Config.base(), field) == getattr(jax_w2v.Wav2Vec2Config.base(), field), field
    lengths = np.array([160000, 32000, 40005, 1052, 400, 399, 300, 0])
    want = np.asarray(jax_w2v.Wav2Vec2Config.base().feat_extract_output_lengths(jnp.asarray(lengths)))
    got = Wav2Vec2Config.base().feat_extract_output_lengths(torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == 499 and want[4] == 1 and (want[5:] <= 0).all()
    assert Wav2Vec2Config.base().feat_extract_output_lengths(32000) == 99


def test_state_dict_from_both_jax_layouts(models):
    _, params, port = models
    sd = audio_state_dict_from_jax(params)
    own = port.state_dict()
    assert set(sd) == set(own) and all(sd[k].shape == own[k].shape and sd[k].dtype == torch.float32 for k in sd)
    assert "wav2vec2.encoder.layers.1.attention.q_proj.weight" in sd
    assert sd["wav2vec2.feature_extractor.conv_layers.0.conv.weight"].shape == (512, 1, 10)
    assert sd["wav2vec2.encoder.pos_conv_embed.conv.weight"].shape == (64, 16, 16)

    backbone = dict(params["wav2vec2"])
    layers = [backbone.pop(f"layer_{i}") for i in range(CFG.num_hidden_layers)]
    backbone["layers_scan"] = {"layer": jax.tree.map(lambda *xs: np.stack(xs), *layers)}
    scanned = audio_state_dict_from_jax({**params, "wav2vec2": backbone})
    assert set(scanned) == set(sd)
    for k in sd:
        torch.testing.assert_close(scanned[k], sd[k], rtol=0, atol=0)
    # mer_tpu's own scan-layout init has the same tree
    scan_model = jax_w2v.AudioERC(JAX_CFG, scan_layers=True)
    waves, lengths = _waves([800, 800])
    scan_params = scan_model.init(jax.random.PRNGKey(0), jnp.asarray(waves[:, :800]), jnp.asarray(lengths))["params"]
    assert set(audio_state_dict_from_jax(jax.tree.map(np.asarray, scan_params))) == set(sd)


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_inverse_of_convert_hf_and_weight_norm_fold(models, layout):
    """The port's ``state_dict`` with the positional conv as a weight-norm pair
    -> ``convert_hf_wav2vec2`` -> ``audio_state_dict_from_jax`` gives it back,
    and the port folds the same pair on load."""
    _, _, port = models
    own = port.state_dict()
    pc = "encoder.pos_conv_embed.conv."
    hf = {k.removeprefix("wav2vec2."): v for k, v in own.items() if k.startswith("wav2vec2.")}
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(size=tuple(hf[pc + "weight"].shape)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 2.0, size=(1, 1, v.shape[2])).astype(np.float32))
    del hf[pc + "weight"]
    names = ("weight_g", "weight_v") if layout == "weight_g" else \
        ("parametrizations.weight.original0", "parametrizations.weight.original1")
    hf[pc + names[0]], hf[pc + names[1]] = g, v
    folded = g * v / v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()

    _, params, _ = models
    back = audio_state_dict_from_jax({**params, "wav2vec2": jax_w2v.convert_hf_wav2vec2(hf, JAX_CFG)})
    back = {k.removeprefix("wav2vec2."): t for k, t in back.items() if k.startswith("wav2vec2.")}
    assert set(back) == set(hf) - {pc + n for n in names} | {pc + "weight"}
    for k, t in back.items():
        torch.testing.assert_close(t, folded if k == pc + "weight" else hf[k], rtol=1e-6, atol=1e-7)

    assert set(fold_pos_conv_weight_norm(hf)) == set(back)
    fresh = AudioERC(CFG)
    fresh.load_state_dict({**{f"wav2vec2.{k}": t for k, t in hf.items()},
                           **{k: t for k, t in own.items() if k.startswith("head_")}}, strict=True)
    torch.testing.assert_close(fresh.wav2vec2.encoder.pos_conv_embed.conv.weight.detach(), folded, rtol=1e-6, atol=1e-7)
    # a pretrained file: bare or prefixed names, pretraining-only keys ignored, a missing key refused
    other = AudioERC(CFG)
    other.load_backbone({**hf, "masked_spec_embed": torch.zeros(64), "quantizer.codevectors": torch.zeros(3)})
    for k, t in fresh.wav2vec2.state_dict().items():
        torch.testing.assert_close(other.wav2vec2.state_dict()[k], t, rtol=0, atol=0)
    other.load_backbone({f"wav2vec2.{k}": t for k, t in hf.items()})
    with pytest.raises(RuntimeError, match="Missing key"):
        other.load_backbone({k: t for k, t in hf.items() if "feature_projection" not in k})


def test_logits_and_embeddings_match_jax_ragged(models):
    waves, lengths = _waves([WIDTH, 5003, 2999], seed=3)
    (want_logits, want_emb), (logits, emb) = _both(models, waves, lengths)
    assert logits.shape == want_logits.shape == (3, 7) and emb.shape == want_emb.shape == (3, 64)
    np.testing.assert_allclose(emb, want_emb, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=1e-4)


def test_frame_features_match_jax_on_valid_frames(models):
    jax_model, params, port = models
    waves, lengths = _waves([WIDTH, 4100], seed=4)
    want, want_len = jax_w2v.Wav2Vec2Model(JAX_CFG).apply({"params": params["wav2vec2"]}, jnp.asarray(waves),
                                                          jnp.asarray(lengths))
    with torch.no_grad():
        got, got_len = port.wav2vec2(torch.from_numpy(waves), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape == (2, 24, 64)
    for i, n in enumerate(np.asarray(want_len)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], rtol=1e-4, atol=1e-4)


def test_padding_garbage_does_not_move_a_fully_valid_clip(models):
    """``tests/test_wav2vec2.py:95``: pooling and attention see valid frames only."""
    _, _, port = models
    waves, lengths = _waves([WIDTH, 5000], seed=5)
    garbage = waves.copy()
    garbage[1, lengths[1]:] = 5.0
    with torch.no_grad():
        a = port.embed(torch.from_numpy(waves), torch.from_numpy(lengths))
        b = port.embed(torch.from_numpy(garbage), torch.from_numpy(lengths))
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=0, atol=1e-6)


def test_empty_and_too_short_clips_match_jax(models):
    """0 samples (a missing wav's length) and 300 samples (< the 400-sample
    receptive field): every key masked, the pool divides by max(len, 1)."""
    waves, lengths = _waves([WIDTH, 0, 300], seed=6)
    (want_logits, want_emb), (logits, emb) = _both(models, waves, lengths)
    assert np.isfinite(logits).all() and np.isfinite(want_logits).all()
    assert not emb[1:].any() and not want_emb[1:].any() and emb[0].any()
    np.testing.assert_allclose(emb, want_emb, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=1e-4)


def test_bf16_compute_keeps_f32_parameters(models):
    _, _, port = models
    bf16 = AudioERC(CFG, torch.bfloat16)
    bf16.load_state_dict(port.state_dict())
    waves, lengths = _waves([WIDTH, 5003], seed=7)
    with torch.no_grad():
        want = port.embed(torch.from_numpy(waves), torch.from_numpy(lengths))
        got = bf16.embed(torch.from_numpy(waves), torch.from_numpy(lengths))
        logits = bf16(torch.from_numpy(waves), torch.from_numpy(lengths))
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert got.dtype == torch.float32 and logits.dtype == torch.bfloat16
    assert (got - want).abs().max().item() < 0.1 * want.abs().max().item()


def test_seeded_model_is_reproducible_and_leaves_the_global_generator():
    torch.manual_seed(123)
    before = torch.get_rng_state()
    a, b, c = (audio_erc_from_seed(s, CFG) for s in (0, 0, 1))
    assert torch.equal(torch.get_rng_state(), before)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.head_out.weight, c.head_out.weight)
    w = a.wav2vec2.feature_extractor.conv_layers[1].conv.weight
    assert abs(w.std().item() * (3 * 512) ** 0.5 - 1) < 0.05 and not a.head_dense.bias.any()
