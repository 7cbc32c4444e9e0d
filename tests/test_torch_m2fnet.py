"""The port's M2FNet against the JAX package's, on the same weights.

A ``mer_tpu`` M2FNet is initialised from a seed; ``state_dict_from_jax``
carries its params into the port, whose eval logits must agree within 1e-4
(float32, CPU). The port's ``state_dict`` must equal the JAX package's own
torch export (``export_m2fnet_state_dict``) key for key and value for value.
In bf16 the port keeps the encoder skips in f32, as mer_tpu does.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mer_tpu.core.config import Config as JaxConfig
from mer_tpu.models import M2FNet as JaxM2FNet
from mer_tpu.models.torch_export import export_m2fnet_state_dict
from mer_tpu_torch.core import Config
from mer_tpu_torch.models import (
    M2FNet,
    load_reference_checkpoint,
    save_reference_checkpoint,
    set_attention_generator,
    state_dict_from_jax,
)

B, U = 3, 9


def _model_cfg(d=32, heads=4, audio=True, text=True, fam=True, n_classifier=2, n_transformers=1, layers=2):
    enc = lambda on: {"enabled": on, "embedding_size": d, "n_head": heads,
                      "n_transformers": n_transformers, "n_encoder_layers": layers}
    return {
        "dropout": 0.4,
        "AUDIO": enc(audio), "TEXT": enc(text),
        "FAM": {"enabled": fam, "embedding_size": d, "n_head": heads, "n_layers": 2},
        "CLASSIFIER": {"hidden_size": d, "output_size": 7, "n_layers": n_classifier},
    }


def _inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    text = rng.normal(size=(B, U, d)).astype(np.float32)
    audio = rng.normal(size=(B, U, d)).astype(np.float32)
    mask = np.arange(U)[None, :] >= np.array([[U], [4], [0]])
    mask[2, 0] = False  # all-padding dialogue keeps key 0 attendable
    return text, audio, mask


@functools.cache
def _both(overrides: tuple, scan_layers: bool, seed: int = 0):
    """JAX model, its params (JAX and numpy), the port with those weights,
    and inputs; cached, as the logits and state_dict tests share configs."""
    cfg = _model_cfg(**dict(overrides))
    jax_model = JaxM2FNet.from_config(JaxConfig(cfg), scan_layers=scan_layers)
    text, audio, mask = _inputs(cfg["TEXT"]["embedding_size"])
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(text), jnp.asarray(audio),
                            jnp.asarray(mask))["params"]
    params_np = jax.tree.map(np.asarray, params)
    port = M2FNet.from_config(Config(cfg))
    port.load_state_dict(state_dict_from_jax(params_np, Config(cfg)), strict=True)
    return jax_model, params, params_np, port.eval(), (text, audio, mask)


CONFIGS = [
    pytest.param(dict(), False, id="default-unrolled"),
    pytest.param(dict(), True, id="default-scan"),
    pytest.param(dict(d=48, heads=4), False, id="dh12"),
    pytest.param(dict(n_classifier=3), False, id="classifier3"),
    pytest.param(dict(n_transformers=2), False, id="two-transformers"),
    pytest.param(dict(fam=False), False, id="no-fam"),
    pytest.param(dict(audio=False, fam=False), False, id="text-only"),
    pytest.param(dict(text=False, fam=False, d=48), True, id="audio-only-dh12"),
]


@pytest.mark.parametrize("overrides, scan_layers", CONFIGS)
def test_logits_match_jax(overrides, scan_layers):
    jax_model, params, _, port, (text, audio, mask) = _both(tuple(overrides.items()), scan_layers)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(text), jnp.asarray(audio),
                                      jnp.asarray(mask), deterministic=True))
    with torch.inference_mode():
        got = port(torch.from_numpy(text), torch.from_numpy(audio), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (B, U, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("overrides, scan_layers", CONFIGS)
def test_state_dict_equals_jax_export(overrides, scan_layers):
    jax_model, _, params_np, port, _ = _both(tuple(overrides.items()), scan_layers)
    want = export_m2fnet_state_dict(params_np, jax_model)
    got = port.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_reference_checkpoint_roundtrip(tmp_path):
    *_, port, (text, audio, mask) = _both((("n_classifier", 3),), False)
    path = tmp_path / "m2fnet.pth"
    save_reference_checkpoint(path, port, epoch=3)
    assert torch.load(path, weights_only=True)["epoch"] == 3
    back = M2FNet.from_config(Config(_model_cfg(n_classifier=3)))
    back.load_state_dict(load_reference_checkpoint(path), strict=True)
    args = [torch.from_numpy(a) for a in (text, audio, mask)]
    with torch.inference_mode():
        torch.testing.assert_close(back.eval()(*args), port(*args), rtol=0, atol=0)


@pytest.mark.parametrize("toggles, message", [
    (dict(audio=False, text=False, fam=False), "At least one"),
    (dict(audio=False), "Fusion Attention Module"),
])
def test_invalid_toggles_raise_like_jax(toggles, message):
    with pytest.raises(ValueError, match=message):
        M2FNet.from_config(Config(_model_cfg(**toggles)))
    jax_model = JaxM2FNet.from_config(JaxConfig(_model_cfg(**toggles)))
    text, audio, mask = _inputs(32)
    with pytest.raises(ValueError, match=message):
        jax_model.init(jax.random.PRNGKey(0), jnp.asarray(text), jnp.asarray(audio), jnp.asarray(mask))


def test_training_mode_attention_dropout_raises():
    """Train mode with dropout raises until the model has an attention
    generator; then each forward draws new masks from it, and reseeding it
    and the global generator (nn.Dropout) repeats a forward exactly."""
    port = M2FNet.from_config(Config(_model_cfg())).train()
    text, audio, mask = (torch.from_numpy(a) for a in _inputs(32))
    with pytest.raises(ValueError, match="Generator"):
        port(text, audio, mask)

    def forward(reseed: bool):
        if reseed:
            torch.manual_seed(1)
            set_attention_generator(port, torch.Generator().manual_seed(2))
        return port(text, audio, mask)

    first = forward(reseed=True)
    assert torch.isfinite(first).all() and not torch.equal(first, forward(reseed=False))
    torch.testing.assert_close(forward(reseed=True), first, rtol=0, atol=0)


def test_bf16_keeps_the_skip_in_f32_as_jax_does():
    """Serving in bf16 (weights cast to bf16, f32 embeddings): the sums of the
    encoder skips are f32, as in mer_tpu, whose f32 embeddings plus a bf16
    encoder output promote to f32 (mer_tpu/models/m2fnet.py:181,188). Against
    mer_tpu's bf16 logits (f32 params, bf16 compute) the port is within 0.05
    (three bf16 ulps of logits below 4), and closer on average than with the
    embeddings cast to bf16 before the skip, as the port did before."""
    jax_model, params, _, port, (text, audio, mask) = _both((), False)
    jax_bf16 = JaxM2FNet.from_config(JaxConfig(_model_cfg()), dtype=jnp.bfloat16)
    want = np.asarray(jax_bf16.apply({"params": params}, jnp.asarray(text), jnp.asarray(audio),
                                     jnp.asarray(mask), deterministic=True).astype(jnp.float32))
    bf16 = copy.deepcopy(port).to(torch.bfloat16)
    seen = []
    bf16.dropout.register_forward_pre_hook(lambda module, args: seen.append(args[0].dtype))
    text, audio, mask = (torch.from_numpy(a) for a in (text, audio, mask))
    with torch.inference_mode():
        after = bf16(text, audio, mask).float().numpy()
        skip_dtypes = seen[0], seen[2]  # nn.Dropout's first call on each modality: the skip sum
        before = bf16(text.bfloat16(), audio.bfloat16(), mask).float().numpy()
    assert skip_dtypes == (torch.float32, torch.float32) and set(seen[3:]) == {torch.bfloat16}
    err_after, err_before = np.abs(after - want), np.abs(before - want)
    assert err_after.max() <= 0.05
    assert err_after.mean() < err_before.mean()
