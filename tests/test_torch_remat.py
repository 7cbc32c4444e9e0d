"""Rematerialisation (``--remat``, ``--remat-policy``) against plain training and the JAX package's, on the CPU.

Narrow models (4 layers, hidden 32, 4 heads; wav2vec2 on the base conv
schedule at 32 channels):

- with dropout on, the gradients of ``full``, ``dots`` and ``dots_no_batch``
  equal the plain model's bit for bit, RoBERTa and wav2vec2, and so does
  the loss: the recompute draws the forward's masks (``F.dropout``'s from
  the restored default generator, the attention's from its rewound seed
  generator); a recompute that drew new attention seeds changes them;
- with dropout off, each policy's gradients against ``mer_tpu``'s remat
  model (``remat=True``, the same policy) on the same weights, within 1e-5
  of each tensor's largest |entry|;
- the attention forward runs again in each recompute (one more per layer
  under every policy: the kernel's output buffer is recomputed, never
  cached), and an unknown policy raises ``mer_tpu``'s ``ValueError``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mer_tpu.models import roberta as jax_roberta
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.utils.remat import resolve_remat_policy as jax_resolve
from mer_tpu_torch.models import audio_state_dict_from_jax, set_attention_generator, text_state_dict_from_jax
from mer_tpu_torch.models.roberta import RobertaConfig, TextERC, text_erc_from_seed
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config, audio_erc_from_seed
from mer_tpu_torch.objectives.classification import cross_entropy
from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.utils import seed_dropout, seed_step
from mer_tpu_torch.utils.remat import REMAT_POLICIES, resolve_remat_policy

TEXT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=4, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
W2V = dict(conv_dim=(32,) * 7, hidden_size=32, num_hidden_layers=4, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
LABELS = np.array([1, 4, 0, 6], np.int64)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _text_inputs():
    rng = np.random.default_rng(0)
    mask = (np.arange(16)[None, :] < np.array([[16], [9], [5], [12]])).astype(np.int32)
    ids = (rng.integers(3, 100, (4, 16)) * mask + (1 - mask)).astype(np.int32)
    ids[:, 0] = 0
    return ids, mask


def _audio_inputs():
    rng = np.random.default_rng(1)
    return rng.normal(size=(4, 3200)).astype(np.float32), np.array([3200, 2500, 1200, 3000], np.int32)


def _port_inputs(kind):
    if kind == "text":
        ids, mask = _text_inputs()
        return torch.from_numpy(ids).long(), torch.from_numpy(mask)
    waves, lengths = _audio_inputs()
    return torch.from_numpy(waves), torch.from_numpy(lengths)


def _train_step(kind, remat, policy, dropout=True, model=None):
    """(loss, gradients) of one train-mode step from the seeded weights, the
    dropout streams seeded for step 3."""
    if model is None:
        cfg = dict(TEXT if kind == "text" else W2V)
        if not dropout:
            cfg.update(hidden_dropout=0.0, attention_dropout=0.0)
        model = text_erc_from_seed(0, RobertaConfig(**cfg)) if kind == "text" else \
            audio_erc_from_seed(0, Wav2Vec2Config(**cfg))
    model.set_remat(remat, policy).train()
    generator = seed_dropout(0)
    set_attention_generator(model, generator)
    seed_step(0, 3, generator)
    loss = cross_entropy(model(*_port_inputs(kind)), torch.from_numpy(LABELS))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _one_thread(fn, *args, **kwargs):
    """``fn`` on one torch thread: several threads may split a product's sums
    differently from call to call (MKL's dynamic scheduling), which the
    bit-for-bit comparisons here would see."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kwargs)
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def plain():
    return {kind: _one_thread(_train_step, kind, False, None) for kind in ("text", "audio")}


@pytest.mark.parametrize("kind", ["text", "audio"])
@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_gradients_equal_plain_with_dropout_on(plain, kind, policy):
    loss, grads = _one_thread(_train_step, kind, True, policy)
    want_loss, want = plain[kind]
    assert loss == want_loss
    for name, g in want.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=0, msg=lambda m: f"{policy} {name}: {m}")


def test_a_recompute_with_fresh_attention_seeds_would_differ(plain, monkeypatch):
    """The control: without rewinding the attention generator the recompute
    draws new seed words, and the gradients part from the plain ones."""
    from mer_tpu_torch.models import layers

    monkeypatch.setattr(layers, "attention_generators", lambda *modules: [])
    _, grads = _one_thread(_train_step, "text", True, None)
    _, want = plain["text"]
    assert max((grads[n] - g).abs().max().item() for n, g in want.items()) > 1e-4


def _jax_grads(kind, policy, params):
    if kind == "text":
        model = jax_roberta.TextERC(jax_roberta.RobertaConfig(**TEXT, hidden_dropout=0.0, attention_dropout=0.0),
                                    remat=True, remat_policy=policy)
        inputs = tuple(map(jnp.asarray, _text_inputs()))
    else:
        model = jax_w2v.AudioERC(jax_w2v.Wav2Vec2Config(**W2V, hidden_dropout=0.0, attention_dropout=0.0),
                                 remat=True, remat_policy=policy)
        inputs = tuple(map(jnp.asarray, _audio_inputs()))

    def loss(p):
        logits = model.apply({"params": p}, *inputs, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits.astype(jnp.float32)),
                                             jnp.asarray(LABELS)[:, None], 1))

    return jax.jit(jax.grad(loss))(params)


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(5)
    out = {}
    for kind in ("text", "audio"):
        if kind == "text":
            model = jax_roberta.TextERC(jax_roberta.RobertaConfig(**TEXT))
            init_inputs = tuple(map(jnp.asarray, _text_inputs()))
        else:
            model = jax_w2v.AudioERC(jax_w2v.Wav2Vec2Config(**W2V))
            init_inputs = tuple(map(jnp.asarray, _audio_inputs()))
        params = jax.jit(model.init)(jax.random.PRNGKey(0), *init_inputs)["params"]
        out[kind] = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    return out


@pytest.mark.parametrize("kind", ["text", "audio"])
@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_gradients_match_jax_remat_model(jax_params, kind, policy):
    params = jax_params[kind]
    convert = text_state_dict_from_jax if kind == "text" else audio_state_dict_from_jax
    cfg = dict(TEXT if kind == "text" else W2V, hidden_dropout=0.0, attention_dropout=0.0)
    model = TextERC(RobertaConfig(**cfg)) if kind == "text" else AudioERC(Wav2Vec2Config(**cfg))
    model.load_state_dict(convert(params), strict=True)
    _, grads = _train_step(kind, True, policy, model=model)
    want = convert(jax.tree.map(np.asarray, _jax_grads(kind, policy, params)))
    assert grads.keys() == want.keys()
    for name, w in want.items():
        scale = max(w.abs().max().item(), 1e-12)
        assert (grads[name] - w).abs().max().item() <= 1e-5 * max(scale, 1.0), name


@pytest.mark.parametrize("policy", [None, *REMAT_POLICIES])
def test_attention_forward_runs_again_in_each_recompute(monkeypatch, policy):
    calls = {"n": 0}
    reference = fa.flash_attention_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return reference(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    _train_step("text", policy is not None, policy)
    layers = TEXT["num_hidden_layers"]
    assert calls["n"] == (2 * layers if policy is not None else layers)


def test_unknown_policy_raises_as_jax():
    with pytest.raises(ValueError) as want:
        jax_resolve("everything")
    with pytest.raises(ValueError) as got:
        resolve_remat_policy("everything")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown remat policy"):
        text_erc_from_seed(0, RobertaConfig(**TEXT)).set_remat(True, "everything")
    assert resolve_remat_policy("full") is None and jax_resolve("full") is None
