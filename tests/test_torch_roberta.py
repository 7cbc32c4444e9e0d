"""The port's RoBERTa text extractor model against the JAX package's, on the CPU.

A narrow config (hidden 32, 2 layers, 2 heads, vocabulary 100) with
numpy-perturbed weights in both packages, token batches with pads inside
(so the position ids matter):

- ``TextERC`` logits and ``embed`` against ``mer_tpu``'s with the weights
  through ``text_state_dict_from_jax``, in the unrolled and the scanned
  layout: f32 within 1e-4, bf16 within 5e-2;
- the port's ``state_dict`` carries Hugging Face's names: ``mer_tpu``'s
  ``convert_hf_roberta(prefix="roberta.")`` and
  ``convert_hf_classification_head(prefix="classifier_head.")`` give back the
  JAX params exactly, and a Hugging Face ``RobertaModel`` of the same config
  loads the backbone's keys;
- ``create_position_ids`` equals ``mer_tpu``'s; ``large()`` builds;
- dropout: train differs from eval, repeats under the same seeds, and the
  attention mask keeps its rate.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mer_tpu.models import roberta as jax_roberta
from mer_tpu_torch.models import set_attention_generator, text_state_dict_from_jax
from mer_tpu_torch.models.roberta import (
    RobertaConfig,
    TextERC,
    create_position_ids,
    text_erc_from_seed,
)
from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.utils import seed_dropout, seed_step

NARROW = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=70)
CFG = RobertaConfig(**NARROW)
JAX_CFG = jax_roberta.RobertaConfig(**NARROW)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tokens(b=4, s=16, seed=0):
    """ids [b, s] with <s> first and ragged pad tails (one row full), and the mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, NARROW["vocab_size"], size=(b, s)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones((b, s), np.int32)
    for row, n in enumerate(rng.integers(2, s, size=b - 1), start=1):
        ids[row, n:], mask[row, n:] = CFG.pad_token_id, 0
    return ids, mask


def _jax_params(scan_layers: bool, seed=0):
    model = jax_roberta.TextERC(JAX_CFG, scan_layers=scan_layers)
    ids, mask = _tokens()
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _port(params, dtype=torch.float32) -> TextERC:
    model = TextERC(CFG, dtype)
    model.load_state_dict(text_state_dict_from_jax(params), strict=True)
    return model.eval()


def _inputs(ids, mask):
    return torch.from_numpy(ids).long(), torch.from_numpy(mask)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_logits_and_embed_match_jax_f32(scan_layers):
    params = _jax_params(scan_layers)
    jax_model = jax_roberta.TextERC(JAX_CFG, scan_layers=scan_layers)
    port = _port(params)
    for seed, (b, s) in enumerate([(4, 16), (3, 64)]):
        ids, mask = _tokens(b, s, seed)
        want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
        want_embed = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                                                method=jax_roberta.TextERC.embed))
        with torch.no_grad():
            got, got_embed = port(*_inputs(ids, mask)), port.embed(*_inputs(ids, mask))
        assert got.shape == (b, 7) and got_embed.shape == (b, 32) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got_embed.numpy(), want_embed, rtol=1e-4, atol=1e-4)


def test_logits_match_jax_bf16():
    params = _jax_params(False, seed=1)
    ids, mask = _tokens(4, 16, seed=5)
    want = np.asarray(jax_roberta.TextERC(JAX_CFG, dtype=jnp.bfloat16)
                      .apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))
    port = _port(params, torch.bfloat16)
    with torch.no_grad():
        got = port(*_inputs(ids, mask))
    assert got.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in port.parameters())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=5e-2)
    assert port.set_compute_dtype(torch.float32).roberta.dtype == torch.float32


@pytest.mark.parametrize("scan_layers", [False, True])
def test_state_dict_reads_back_through_the_jax_converters(scan_layers):
    params = _jax_params(scan_layers, seed=2)
    sd = _port(params).state_dict()
    assert "roberta.encoder.layer.1.attention.self.query.weight" in sd
    assert "roberta.encoder.layer.0.attention.output.LayerNorm.bias" in sd and "classifier_head.out_proj.bias" in sd
    back = {"roberta": jax_roberta.convert_hf_roberta(sd, JAX_CFG, prefix="roberta.", scan_layers=scan_layers),
            "classifier_head": jax_roberta.convert_hf_classification_head(sd, prefix="classifier_head.")}
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got, want = flat(back), flat(params)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_backbone_keys_are_hugging_faces():
    """A Hugging Face ``RobertaModel`` of the narrow config (built locally,
    nothing loaded) and the port's backbone name their weights alike, and
    ``load_backbone`` takes its ``state_dict`` (the pooler and buffers ignored)."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.RobertaModel(transformers.RobertaConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=70, type_vocab_size=1, pad_token_id=1), add_pooling_layer=True).eval()
    port = TextERC(CFG)
    own = set(port.roberta.state_dict())
    assert own <= set(hf.state_dict()) and any(k.startswith("pooler.") for k in hf.state_dict())
    port.load_backbone({f"roberta.{k}": v for k, v in hf.state_dict().items()})
    ids, mask = _tokens(3, 16, seed=3)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask)).last_hidden_state
        got = port.eval().roberta(*_inputs(ids, mask))
    real = torch.from_numpy(mask).bool()
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-4)  # padded queries are never read
    with pytest.raises(RuntimeError, match="Missing key"):
        port.load_backbone({k: v for k, v in hf.state_dict().items() if "LayerNorm" not in k})


def test_position_ids_and_configs():
    ids, _ = _tokens(4, 16, seed=4)
    want = np.asarray(jax_roberta.create_position_ids(jnp.asarray(ids), 1))
    got = create_position_ids(torch.from_numpy(ids).long(), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[torch.from_numpy(ids) == 1] == 1).all() and got[0].tolist() == list(range(2, 18))
    for name in ("base", "large"):
        assert getattr(RobertaConfig, name)() == RobertaConfig(**vars(getattr(jax_roberta.RobertaConfig, name)()))
    with torch.device("meta"):
        large = TextERC(RobertaConfig.large())
        base = TextERC(RobertaConfig.base())
    assert len(large.roberta.encoder.layer) == 24 and large.classifier_head.dense.weight.shape == (1024, 1024)
    assert sum(p.numel() for p in base.parameters()) == 124_651_015  # roberta-base without its pooler + the head


def test_seeded_model_is_reproducible_and_scaled_as_jax_initialises():
    torch.manual_seed(7)
    before = torch.get_rng_state()
    a, b, c = (text_erc_from_seed(s, CFG) for s in (0, 0, 1))
    assert torch.equal(torch.get_rng_state(), before)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.classifier_head.dense.weight, c.classifier_head.dense.weight)
    jax_params = jax_roberta.TextERC(JAX_CFG).init(jax.random.PRNGKey(0), *map(jnp.asarray, _tokens()))["params"]
    for got, want in ((a.roberta.embeddings.word_embeddings.weight, jax_params["roberta"]["word_embeddings"]["embedding"]),
                      (a.roberta.encoder.layer[0].intermediate.dense.weight,
                       jax_params["roberta"]["layer_0"]["intermediate"]["kernel"])):
        assert abs(got.std().item() / float(np.asarray(want).std()) - 1) < 0.1
    assert not a.classifier_head.dense.bias.any() and (a.roberta.embeddings.LayerNorm.weight == 1).all()


def test_dropout_is_on_in_train_mode_only_and_repeats_under_the_same_seeds():
    port = _port(_jax_params(False, seed=3))
    generator = seed_dropout(0)
    set_attention_generator(port, generator)
    args = _inputs(*_tokens(4, 16, seed=6))
    with torch.no_grad():
        eval_out = port(*args)
        port.train()
        outs = []
        for step in (0, 1, 0):
            seed_step(0, step, generator)
            outs.append(port(*args))
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], eval_out, atol=1e-3)
    assert torch.equal(port.eval()(*args), eval_out)  # eval applies none
    with pytest.raises(ValueError, match="torch.Generator"):
        set_attention_generator(port.train(), None)
        port(*args)


def test_attention_dropout_reaches_the_attention_with_its_rate(monkeypatch):
    """Every layer hands ``attention_dropout`` and two fresh seed words to the
    attention; the mask those draw keeps 1 - rate of the probabilities."""
    port = _port(_jax_params(False, seed=4)).train()
    set_attention_generator(port, seed_dropout(1))
    calls = []
    forward = fa.flash_attention_forward
    monkeypatch.setattr(fa, "flash_attention_forward",
                        lambda q, k, v, m, seed, rate: calls.append((seed, rate, q.shape)) or forward(q, k, v, m, seed, rate))
    with torch.no_grad():
        port(*_inputs(*_tokens(8, 64, seed=7)))
    assert [c[1] for c in calls] == [CFG.attention_dropout] * 2 and calls[0][0] != calls[1][0]
    keep = torch.cat([(fa.dropout_factor(seed, (8, 2, 64, 64), rate) > 0).flatten() for seed, rate, _ in calls])
    assert abs(keep.float().mean().item() - (1 - CFG.attention_dropout)) < 5e-3
    assert calls[0][2] == (8, 2, 64, 16)
