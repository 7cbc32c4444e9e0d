"""The port's int8 serving engines against the JAX package's, on the CPU.

With narrow models in both packages holding the same weights (``mer_tpu``'s
jitted init plus seeded noise, carried with ``*_state_dict_from_jax``):

- ``quantize_weight`` bit-equal to ``mer_tpu``'s, and every quantized site of
  the M2FNet, RoBERTa and wav2vec2 trees the same int8 values and scales as
  ``mer_tpu``'s tree (the conv frontend, the positional conv and the
  embedding tables left float);
- ``int8_dense`` in a8w8 (dynamic and static) and w8 within 1e-6 of the
  largest |value| of ``mer_tpu``'s;
- every dense site of ``M2FNetInt8`` (a8w8 dynamic, a8w8 static with
  ``mer_tpu``'s calibrated scales, w8), fed ``mer_tpu``'s input at that site,
  within 1e-5 of the largest |value| of ``mer_tpu``'s output there: the
  modes, scales, weights and biases site by site, free of the rounding
  flips that blur an end-to-end comparison (planted faults, per-tensor
  activation scales in a8w8 and static scales 2% off, read 0.015 and 0.017
  at their worst site);
- ``M2FNetInt8`` logits against ``mer_tpu``'s engine with its attention
  (``quant.py:376``) restated as the port's op computes it (bf16 q, k, v; f32
  scores; P and the output rounded to bf16): w8 within 1e-5 of the largest
  |logit|; a8w8 within 0.017. Over eight fixture seeds the a8w8 reading is
  under 3e-7 on five and 0.0079-0.0145 on three (one activation a rounding step
  apart, after the engines' float sums differ in order, moves a product by
  its two scales), and the planted per-tensor fault reads 0.019-0.037: the
  limit lies between. Against ``mer_tpu``'s engine as it is, dynamic, w8
  and calibrated, within 0.05, a third of the 0.15 envelope against the
  float model (``tests/test_serving_quant.py:91``), and no tighter:
  ``mer_tpu``'s attention rounds its bf16 scores to bf16 when run op by op
  but not always under ``jax.jit`` (its own eager and jitted a8w8 logits
  part by 0.018 here); the readings over the eight seeds are 0.018-0.023
  dynamic and 0.020-0.043 calibrated (the two calibration passes see
  activations that differ by that rounding). The readings come from
  ``python tests/int8_fusion_readings.py``. ``RobertaInt8`` and
  ``Wav2Vec2Int8`` embeddings and logits within 0.025 of ``mer_tpu``'s jitted
  engines (a tenth of the encoders' 0.25), and all three within their
  envelopes of the port's own float models;
- the calibration rules of ``tests/test_serving_quant.py:204-287``: path keys
  survive a rebuilt tree, identity keys on a rebuilt tree raise, an empty
  sink leaves every site dynamic, and a baked site gets ``mer_tpu``'s static
  scale;
- the padding that ``torch._int_mm`` needs on the card, exact;
- ``--int8`` on ``python -m mer_tpu_torch.test`` and ``.serve`` and on the
  text and wav2vec2 exporters.
"""

import contextlib
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mer_tpu import serving as jax_serving
from mer_tpu.serving import quant as jax_quant
from mer_tpu.models import roberta as jax_roberta
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.models.m2fnet import M2FNet as JaxM2FNet
from mer_tpu_torch import serve as serve_entry
from mer_tpu_torch import test as eval_entry
from mer_tpu_torch.core import CONFIG_PATH, load_config
from mer_tpu_torch.feature_extractors import fe_common
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import embeddings as w2v_embeddings
from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH
from mer_tpu_torch.feature_extractors.text import embeddings as text_embeddings
from mer_tpu_torch.models import (M2FNet, audio_state_dict_from_jax, init_random_, save_reference_checkpoint,
                                  state_dict_from_jax, text_state_dict_from_jax)
from mer_tpu_torch.models.roberta import RobertaConfig, TextERC, text_erc_from_seed
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config, audio_erc_from_seed
from mer_tpu_torch.serving import (M2FNetInt8, RobertaInt8, Wav2Vec2Int8, apply_calibration, calibration,
                                   int8_dense, quantize_m2fnet, quantize_roberta, quantize_tree, quantize_wav2vec2,
                                   quantize_weight, quantized_bytes)
from mer_tpu_torch.serving import quant as port_quant
from mer_tpu_torch.serving.quant import cublas_int8_operands, module_tree, tree_leaves

D = 32
TEXT = dict(vocab_size=200, hidden_size=D, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
W2V = dict(conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=D, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
FUSION_REL, ENCODER_REL = 0.15, 0.25  # the float envelopes of tests/test_serving_quant.py
FUSION_PORT_REL = 0.05  # the fusion engine against mer_tpu's as it is (module docstring)
A8W8_RESTATED_REL = 0.017  # the a8w8 fusion engine against mer_tpu's with the port's attention numerics (docstring)
W8_RESTATED_REL = 1e-5  # the w8 fusion engine against mer_tpu's with the port's attention numerics
SITE_REL = 1e-5  # each dense site of the fusion engine, fed mer_tpu's input there, against mer_tpu's output


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _perturbed(params, seed: int):
    """``params`` (from a jitted ``init``: flax's eager init takes seconds a model) plus seeded noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _block():
    return load_config(CONFIG_PATH).model.override(
        TEXT__embedding_size=D, AUDIO__embedding_size=D, FAM__embedding_size=D, TEXT__n_head=4, AUDIO__n_head=4,
        FAM__n_head=4, TEXT__n_encoder_layers=2, AUDIO__n_encoder_layers=2, FAM__n_layers=2,
        CLASSIFIER__hidden_size=D)


def fusion_case(seed: int) -> dict:
    """Narrow M2FNets of both packages holding the same weights, and their inputs, from ``seed``."""
    block = _block()
    jax_model = JaxM2FNet.from_config(block)
    rng = np.random.default_rng(seed)
    text, audio = (rng.normal(size=(4, 9, D)).astype(np.float32) for _ in range(2))
    mask = np.zeros((4, 9), bool)
    mask[:, 7:] = True
    params = _perturbed(jax.jit(jax_model.init)(jax.random.PRNGKey(seed), text, audio, mask)["params"], seed)
    port = M2FNet.from_config(block).eval()
    port.load_state_dict(state_dict_from_jax(params, block), strict=True)
    inputs = tuple(torch.from_numpy(a) for a in (text, audio, mask))
    with torch.inference_mode():
        float_logits = port(*inputs).numpy()
    return {"jax_model": jax_model, "params": params, "port": port, "np": (text, audio, mask), "torch": inputs,
            "float": float_logits}


@pytest.fixture(scope="module")
def fusion():
    return fusion_case(0)


@pytest.fixture(scope="module")
def encoders():
    text_jax = jax_roberta.TextERC(jax_roberta.RobertaConfig(**TEXT))
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 200, size=(4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[2, 8:] = 0
    text_params = _perturbed(jax.jit(text_jax.init)(jax.random.PRNGKey(0), ids, mask)["params"], 1)
    text_port = TextERC(RobertaConfig(**TEXT)).eval()
    text_port.load_state_dict(text_state_dict_from_jax(text_params), strict=True)

    audio_jax = jax_w2v.AudioERC(jax_w2v.Wav2Vec2Config(**W2V))
    waves = (rng.normal(size=(3, 1600)) * 0.1).astype(np.float32)
    lengths = np.array([1600, 1200, 800], np.int32)
    audio_params = _perturbed(jax.jit(audio_jax.init)(jax.random.PRNGKey(0), waves, lengths)["params"], 2)
    audio_port = AudioERC(Wav2Vec2Config(**W2V)).eval()
    audio_port.load_state_dict(audio_state_dict_from_jax(audio_params), strict=True)
    return {"text": (text_jax, text_params, text_port, (ids, mask)),
            "audio": (audio_jax, audio_params, audio_port, (waves, lengths))}


# -- primitives --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 32), (4, 16, 8)])
def test_quantize_weight_bit_equal(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel: the 1e-12 scale floor
    got, want = quantize_weight(torch.from_numpy(w)), jax_serving.quantize_weight(jnp.asarray(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("mode", ["a8w8", "w8", "static"])
def test_int8_dense_matches(mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) * 0.02).astype(np.float32)
    b = (rng.normal(size=(40,)) * 0.01).astype(np.float32)
    kw = {"weight_only": mode == "w8"}
    jkw, tkw = dict(kw), dict(kw)
    if mode == "static":
        jkw["act_scale"], tkw["act_scale"] = jnp.float32(0.031), torch.tensor(0.031)
    want = np.asarray(jax_serving.int8_dense(jnp.asarray(x), jax_serving.quantize_weight(jnp.asarray(w)),
                                             jnp.asarray(b), **jkw))
    got = int8_dense(torch.from_numpy(x), quantize_weight(torch.from_numpy(w)), torch.from_numpy(b), **tkw)
    assert got.shape == (2, 37, 40) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("m, k, n", [(3, 13, 7), (40, 64, 8), (17, 24, 300)])
def test_cublas_operand_padding_exact(m, k, n):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    b = quantize_weight(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)))["q"]
    pa, pb = cublas_int8_operands(a, b)
    assert pa.shape[0] > 16 and pa.shape[1] % 8 == 0 and pb.shape[1] % 8 == 0 and pb.t().is_contiguous()
    got = torch._int_mm(pa, pb)[:m, :n]
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))


# -- the quantized trees -----------------------------------------------------------------


def _same_site(got: dict, want: dict) -> None:
    np.testing.assert_array_equal(got["kernel_q"]["q"].numpy(), np.asarray(want["kernel_q"]["q"]))
    np.testing.assert_array_equal(got["kernel_q"]["scale"].numpy(), np.asarray(want["kernel_q"]["scale"]))
    np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(want["bias"]))


def test_m2fnet_tree_matches(fusion):
    got, want = quantize_m2fnet(fusion["port"]), jax_serving.quantize_m2fnet(fusion["params"])
    for i in range(2):
        for mod in ("audio", "text"):
            g, w = got[f"{mod}_encoders"]["0"]["layers"][str(i)], want[f"{mod}_encoders_0"][f"layers_{i}"]
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _same_site(g["self_attn"][name], w["self_attn"][name])
            for name in ("linear1", "linear2"):
                _same_site(g[name], w[name])
        fam_g, fam_w = got["fusion_layers"][str(i)], want[f"fusion_layers_{i}"]
        _same_site(fam_g["linear"], fam_w["linear"])
        _same_site(fam_g["multihead_attention"]["v_proj"], fam_w["multihead_attention"]["v_proj"])
    _same_site(got["output_layer"]["0"], want["classifier_0"])
    _same_site(got["output_layer"]["3"], want["classifier_out"])
    _same_site(got["audio_proj"], want["audio_proj"])
    count = lambda tree: ("kernel_q" in tree) + sum(count(v) for v in tree.values() if isinstance(v, dict))
    assert count(got) == count(want) > 0
    f32_bytes = sum(p.numel() * 4 for p in fusion["port"].parameters())
    assert quantized_bytes(got) < 0.35 * f32_bytes
    assert quantized_bytes(quantize_m2fnet(fusion["port"], weight_only=True)) == quantized_bytes(got)


def test_encoder_trees_match(encoders):
    _, text_params, text_port, _ = encoders["text"]
    got, want = quantize_roberta(text_port)["roberta"], jax_serving.quantize_roberta(text_params)["roberta"]
    for i in range(2):
        g, w = got["encoder"]["layer"][str(i)], want[f"layer_{i}"]
        for name in ("query", "key", "value"):
            _same_site(g["attention"]["self"][name], w["attention"][name])
        _same_site(g["attention"]["output"]["dense"], w["attention_output"])
        _same_site(g["intermediate"]["dense"], w["intermediate"])
        _same_site(g["output"]["dense"], w["output"])
    assert got["embeddings"]["word_embeddings"]["weight"].dtype == torch.float32

    _, audio_params, audio_port, _ = encoders["audio"]
    got, want = quantize_wav2vec2(audio_port), jax_serving.quantize_wav2vec2(audio_params)
    for i in range(2):
        g, w = got["wav2vec2"]["encoder"]["layers"][str(i)], want["wav2vec2"][f"layer_{i}"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _same_site(g["attention"][name], w[name])
        _same_site(g["feed_forward"]["intermediate_dense"], w["intermediate"])
    _same_site(got["wav2vec2"]["feature_projection"]["projection"], want["wav2vec2"]["feature_projection"])
    _same_site(got["head_out"], want["head_out"])
    frontend = got["wav2vec2"]["feature_extractor"]["conv_layers"]["0"]["conv"]
    assert set(frontend) == {"weight"} and frontend["weight"].dtype == torch.float32
    assert "kernel_q" not in got["wav2vec2"]["encoder"]["pos_conv_embed"]["conv"]


# -- the engines -------------------------------------------------------------------------


def _port_attention_jax(q, k, v, num_heads: int, key_padding_mask):
    """``mer_tpu``'s int8 attention restated with the port's numerics: q, k,
    v rounded to bf16, f32 scores (q scaled in f32), f32 softmax, P and the
    output rounded to bf16."""
    b, sq, d = q.shape
    heads = lambda x: x.reshape(b, x.shape[1], num_heads, d // num_heads).transpose(0, 2, 1, 3)
    bf16 = lambda x: x.astype(jnp.bfloat16).astype(jnp.float32)
    q, k, v = (bf16(heads(x)) for x in (q, k, v))
    s = jnp.einsum("bhqd,bhkd->bhqk", q * (d // num_heads) ** -0.5, k, precision="highest")
    s = s + jnp.where(key_padding_mask, -1e30, 0.0)[:, None, None, :]
    out = bf16(jnp.einsum("bhqk,bhkd->bhqd", bf16(jax.nn.softmax(s, axis=-1)), v, precision="highest"))
    return out.transpose(0, 2, 1, 3).reshape(b, sq, d)


def _restated():
    return mock.patch.object(jax_quant, "_attention", _port_attention_jax)


def _port_logits(fusion, qparams):
    with torch.inference_mode():
        return M2FNetInt8(fusion["port"]).apply(qparams, *fusion["torch"]).numpy()


@pytest.mark.parametrize("weight_only", [False, True])
def test_m2fnet_int8_matches_mer_tpu(fusion, weight_only):
    jqp = jax_serving.quantize_m2fnet(fusion["params"], weight_only)
    engine = jax_serving.M2FNetInt8(fusion["jax_model"])
    with _restated():
        restated = np.asarray(jax.jit(engine.apply)(jqp, *fusion["np"]))[:, :7]
    want = np.asarray(jax.jit(jax_serving.M2FNetInt8(fusion["jax_model"]).apply)(jqp, *fusion["np"]))[:, :7]
    got = _port_logits(fusion, quantize_m2fnet(fusion["port"], weight_only))
    assert got.shape == (4, 9, 7)
    assert _rel(got[:, :7], restated) < (W8_RESTATED_REL if weight_only else A8W8_RESTATED_REL)
    assert _rel(got[:, :7], want) < FUSION_PORT_REL
    assert _rel(got[:, :7], fusion["float"][:, :7]) < FUSION_REL


def site_outputs(fusion, mode: str) -> tuple[list, list]:
    """(``mer_tpu``'s, the port's) output of every dense site of the fusion
    engine in call order, in ``mode`` (a8w8, static: ``mer_tpu``'s calibrated
    scales at the same sites, or w8), each port site fed ``mer_tpu``'s input there."""
    weight_only = mode == "w8"
    jax_engine, engine = jax_serving.M2FNetInt8(fusion["jax_model"]), M2FNetInt8(fusion["port"])
    jqp, qp = jax_serving.quantize_m2fnet(fusion["params"], weight_only), quantize_m2fnet(fusion["port"], weight_only)
    if mode == "static":
        with jax_serving.calibration(jqp) as jsink:
            jax_engine.apply(jqp, *fusion["np"])
        with torch.inference_mode(), calibration(qp) as sink:
            engine.apply(qp, *fusion["torch"])
        assert len(sink) == len(jsink)
        jqp = jax_serving.apply_calibration(jqp, jsink)
        qp = apply_calibration(qp, dict(zip(sink, jsink.values())))  # the same sites, called in the same order
    inputs, want, got = [], [], []
    jax_dense, port_dense = jax_quant._dense, port_quant._dense

    def recorded(x, node):
        y = jax_dense(x, node)
        inputs.append(np.array(x))
        want.append(np.asarray(y))
        return y

    def fed(x, node):
        given = torch.from_numpy(inputs[len(got)])
        assert given.shape == x.shape
        y = port_dense(given, node)
        got.append(y.numpy())
        return y

    with mock.patch.object(jax_quant, "_dense", recorded):
        jax_engine.apply(jqp, *fusion["np"])
    with mock.patch.object(port_quant, "_dense", fed), torch.inference_mode():
        engine.apply(qp, *fusion["torch"])
    return want, got


@pytest.mark.parametrize("mode", ["a8w8", "static", "w8"])
def test_m2fnet_int8_sites_match_mer_tpu(fusion, mode):
    want, got = site_outputs(fusion, mode)
    # 6 sites a layer of the 2 + 2 encoder layers, the 2 projections, 5 a fusion layer, the 2 classifier layers
    assert len(got) == len(want) == 2 * 2 * 6 + 2 + 2 * 5 + 2
    for g, w in zip(got, want):
        assert _rel(g, w) < SITE_REL


def test_m2fnet_int8_calibrated_matches_mer_tpu(fusion):
    engine = M2FNetInt8(fusion["port"])
    qp = quantize_m2fnet(fusion["port"])
    with torch.inference_mode(), calibration(qp) as sink:
        engine.apply(qp, *fusion["torch"])
    assert all(isinstance(k, tuple) for k in sink)
    static = apply_calibration(qp, sink)
    count = lambda tree, key: (key in tree) + sum(count(v, key) for v in tree.values() if isinstance(v, dict))
    assert count(static, "act_scale") == count(static, "kernel_q") == len(sink) > 0
    got = _port_logits(fusion, static)[:, :7]
    jqp, jax_engine = jax_serving.quantize_m2fnet(fusion["params"]), jax_serving.M2FNetInt8(fusion["jax_model"])
    with jax_serving.calibration(jqp) as jsink:  # op by op, as the calibration pass must run
        jax_engine.apply(jqp, *fusion["np"])
    assert len(jsink) == len(sink)
    want = np.asarray(jax.jit(jax_engine.apply)(jax_serving.apply_calibration(jqp, jsink), *fusion["np"]))
    assert _rel(got, want[:, :7]) < FUSION_PORT_REL
    assert _rel(got, fusion["float"][:, :7]) < FUSION_REL


def test_m2fnet_int8_rejects_partial_modality():
    with pytest.raises(ValueError, match="full-modality"):
        M2FNetInt8(M2FNet(d_model_audio=D, d_model_text=D, d_model_fam=D, n_head_audio=4, n_head_text=4,
                          n_head_fam=4, fam_enabled=False))


def test_roberta_int8_matches_mer_tpu(encoders):
    jax_model, params, port, (ids, mask) = encoders["text"]
    jax_engine, engine = jax_serving.RobertaInt8(jax_model), RobertaInt8(port)
    jqp = jax_serving.quantize_roberta(params)
    qp = quantize_roberta(port)
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.inference_mode():
        got = (engine.embed(qp, t_ids, t_mask).numpy(), engine.apply(qp, t_ids, t_mask).numpy())
        floats = (port.embed(t_ids, t_mask).numpy(), port(t_ids, t_mask).numpy())
    want = (np.asarray(jax.jit(jax_engine.embed)(jqp, ids, mask)), np.asarray(jax.jit(jax_engine.apply)(jqp, ids, mask)))
    for g, w, f in zip(got, want, floats):
        assert g.shape == w.shape and g.dtype == np.float32
        assert _rel(g, w) < ENCODER_REL / 10
        assert _rel(g, f) < ENCODER_REL


def test_wav2vec2_int8_matches_mer_tpu(encoders):
    jax_model, params, port, (waves, lengths) = encoders["audio"]
    jax_engine, engine = jax_serving.Wav2Vec2Int8(jax_model), Wav2Vec2Int8(port)
    jqp = jax_serving.quantize_wav2vec2(params)
    qp = quantize_wav2vec2(port)
    t_waves, t_lengths = torch.from_numpy(waves), torch.from_numpy(lengths)
    with torch.inference_mode():
        got = (engine.embed(qp, t_waves, t_lengths).numpy(), engine.apply(qp, t_waves, t_lengths).numpy())
        floats = (port.embed(t_waves, t_lengths).numpy(), port(t_waves, t_lengths).numpy())
    want = (np.asarray(jax.jit(jax_engine.embed)(jqp, waves, lengths)),
            np.asarray(jax.jit(jax_engine.apply)(jqp, waves, lengths)))
    for g, w, f in zip(got, want, floats):
        assert g.shape == w.shape and g.dtype == np.float32
        assert _rel(g, w) < ENCODER_REL / 10
        assert _rel(g, f) < ENCODER_REL


# -- calibration rules -------------------------------------------------------------------


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def test_path_keyed_calibration_survives_rebuild(fusion):
    engine, qp = M2FNetInt8(fusion["port"]), quantize_m2fnet(fusion["port"])
    with torch.inference_mode(), calibration(qp) as sink:
        engine.apply(qp, *fusion["torch"])
    assert all(not isinstance(k, int) for k in sink)
    static = apply_calibration(_clone(qp), sink)
    count = lambda tree, key: (key in tree) + sum(count(v, key) for v in tree.values() if isinstance(v, dict))
    assert count(static, "act_scale") == count(static, "kernel_q") > 0


def test_identity_keyed_calibration_on_a_rebuilt_tree_raises(fusion):
    engine, qp = M2FNetInt8(fusion["port"]), quantize_m2fnet(fusion["port"])
    with torch.inference_mode(), calibration() as sink:
        engine.apply(qp, *fusion["torch"])
    assert all(isinstance(k, int) for k in sink)
    rebuilt = _clone(qp)
    with pytest.raises(ValueError, match="did not match"):
        apply_calibration(rebuilt, sink)
    out = apply_calibration(rebuilt, sink, allow_partial=True)
    with torch.inference_mode():
        assert torch.isfinite(engine.apply(out, *fusion["torch"])).all()
    assert "act_scale" in apply_calibration(qp, sink)["audio_proj"]  # the same tree object matches by identity


def test_static_scales_match_mer_tpu():
    """The same path-keyed sink baked into the same tree by both packages:
    the same ``act_scale`` (headroom x amax / 127), and a site observed at
    zero left dynamic."""
    rng = np.random.default_rng(0)
    tree = {"enc": {name: {"kernel": rng.normal(size=(8, 8)).astype(np.float32), "bias": np.zeros(8, np.float32)}
                    for name in ("dense", "silent")}}
    sink = {("enc", "dense"): 2.5, ("enc", "silent"): 0.0}
    got = apply_calibration(quantize_tree(tree), sink, headroom=1.5)["enc"]
    want = jax_serving.apply_calibration(jax_quant.quantize_tree(tree), sink, headroom=1.5)["enc"]
    np.testing.assert_allclose(got["dense"]["act_scale"].numpy(), np.asarray(want["dense"]["act_scale"]), rtol=1e-7)
    assert "act_scale" not in got["silent"] and "act_scale" not in want["silent"]


def test_uncalibrated_sites_stay_dynamic(fusion):
    qp = quantize_m2fnet(fusion["port"])
    out = apply_calibration(qp, {})
    count = lambda tree: ("act_scale" in tree) + sum(count(v) for v in tree.values() if isinstance(v, dict))
    assert count(out) == 0
    with torch.inference_mode():
        np.testing.assert_array_equal(M2FNetInt8(fusion["port"]).apply(out, *fusion["torch"]).numpy(),
                                      M2FNetInt8(fusion["port"]).apply(qp, *fusion["torch"]).numpy())
    with pytest.raises(RuntimeError, match="nested"), calibration(), calibration():
        pass


def test_module_tree_layout(fusion):
    tree = module_tree(fusion["port"])
    mha = tree["fusion_layers"]["0"]["multihead_attention"]
    assert set(mha) == {"q_proj", "k_proj", "v_proj", "out_proj"}
    assert mha["k_proj"]["kernel"].shape == (D, D)
    packed = fusion["port"].fusion_layers[0].multihead_attention.in_proj_weight
    np.testing.assert_array_equal(mha["k_proj"]["kernel"].numpy(), packed[D:2 * D].detach().numpy().T)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tree))


# -- the entry points --------------------------------------------------------------------


@pytest.fixture(scope="module")
def fusion_entry(tmp_path_factory):
    """A narrow f32 config whose checkpoint holds seeded weights."""
    tmp = tmp_path_factory.mktemp("torch_int8")
    raw = load_config(CONFIG_PATH).override(model=_block().to_dict(), tpu__compute_dtype="float32").to_dict()
    raw["checkpoint"]["load_path"] = raw["checkpoint"]["save_path"] = str(tmp / "m2fnet.pth")
    config = str(tmp / "config.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(raw, f)
    model = init_random_(M2FNet.from_config(load_config(config).model), torch.Generator().manual_seed(0))
    save_reference_checkpoint(raw["checkpoint"]["load_path"], model)
    return {"config": config, "ckpt": raw["checkpoint"]["load_path"]}


def test_eval_entry_int8(fusion_entry, capsys):
    argv = ["--synthetic", "--config", fusion_entry["config"], "--checkpoint", fusion_entry["ckpt"], "--device", "cpu"]
    int8 = eval_entry.main([*argv, "--int8"])
    f32 = eval_entry.main(argv)
    assert "(int8, cpu)" in capsys.readouterr().out
    assert 0.0 <= int8["accuracy"] <= 1.0 and abs(int8["accuracy"] - f32["accuracy"]) < 0.05


def test_serve_entry_int8(fusion_entry, capsys):
    report = serve_entry.main(["--synthetic", "--config", fusion_entry["config"], "--requests", "10", "--max-batch",
                               "4", "--device", "cpu", "--int8"])
    assert report["mode"] == "int8" and report["requests"] == 10
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("online serving: ")]
    assert json.loads(line[0].split(": ", 1)[1]) == report


def _fe_config(src: str, tmp, name: str) -> tuple[str, str]:
    with open(src) as f:
        raw = yaml.safe_load(f)
    raw["checkpoint"]["save_path"] = str(tmp / name / "checkpoint.ckpt")
    path = str(tmp / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, raw["checkpoint"]["save_path"]


@pytest.mark.parametrize("extractor", ["text", "audio_wav2vec2"])
def test_exporters_int8(meld_like_root_with_wavs, tmp_path, monkeypatch, capsys, extractor):
    """The exporters with ``--int8`` against their float export, from the
    same checkpoint (narrow models; wav2vec2 on the base conv schedule)."""
    root, sizes = meld_like_root_with_wavs
    if extractor == "text":
        cfg = RobertaConfig(**{**TEXT, "vocab_size": 1000, "max_position_embeddings": 520})
        monkeypatch.setattr(fe_common.RobertaConfig, "base", classmethod(lambda cls: cfg))
        model, entry, src, flags = text_erc_from_seed(1, cfg), text_embeddings, TEXT_CONFIG_PATH, ["--toy-tokenizer"]
    else:
        cfg = Wav2Vec2Config(**{**W2V, "conv_dim": (16,) * 7, "conv_kernel": Wav2Vec2Config.conv_kernel,
                                "conv_stride": Wav2Vec2Config.conv_stride})
        monkeypatch.setattr(fe_common.Wav2Vec2Config, "base", classmethod(lambda cls: cfg))
        model, entry, src, flags = audio_erc_from_seed(1, cfg), w2v_embeddings, W2V_CONFIG_PATH, []
    config, ckpt = _fe_config(src, tmp_path, extractor)
    os.makedirs(os.path.dirname(ckpt))
    torch.save({"epoch": 0, "model_state_dict": model.state_dict()}, ckpt)
    argv = ["--config", config, "--data-root", root, "--random-init", "--f32", "--device", "cpu", *flags]
    int8 = entry.main([*argv, "--int8"], save_dir=str(tmp_path / "int8"))
    assert "int8 serving engine enabled" in capsys.readouterr().out
    f32 = entry.main(argv, save_dir=str(tmp_path / "f32"))
    for mode, table in int8.items():
        assert table.shape == f32[mode].shape == (sizes[mode], D)
        assert _rel(table, f32[mode]) < ENCODER_REL
