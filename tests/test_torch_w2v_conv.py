"""The port's wav2vec2 conv frontend (kernels K7 and K6) against the JAX package's, on the CPU.

Numpy-seeded waveforms and weights go through ``mer_tpu``'s Pallas kernels in
interpret mode and its ``ConvFeatureExtractor``, and through the port's
wrappers (CPU tensors: the plain versions) and its ``ConvFeatureExtractor``:

- K7, ``layer0_gn`` against ``layer0_gn_pallas``: f32 within 1e-4 (rtol and
  atol; the Pallas kernel's variance is the one-pass ``E[y^2] - mean^2``, the
  plain version's ``F.group_norm`` two-pass; ``tests/test_w2v_conv_pallas.py:71``);
- K6, ``conv_stack_fused`` on ``mer_tpu``'s own layer-0 output against
  ``mer_tpu``'s ``conv_stack_fused``: f32 within 2e-5 (``:35``);
- the whole stack against ``ConvFeatureExtractor.apply``: f32 within 1e-4;
- bf16: within 2e-2 of the largest value (``:44``), all three;
- lengths 16,000 (1 s), 4,005 (T0 = 800, the wave's last samples unused) and
  1,052 (a window's tail in the remainder of a layer whose last frame survives,
  ``tests/test_wav2vec2.py:125``), where the frame counts are
  209 -> 104 -> 51 -> 25 -> 12 -> 6 -> 3;
- a geometry other than the base one is refused by the kernels' checks.

The ``cuda`` legs hold each kernel against its plain version on a card (TF32
off) and skip here; on a machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_w2v_conv.py
"""

import numpy as np
import pytest
import torch

from mer_tpu_torch.models.wav2vec2 import ConvFeatureExtractor, Wav2Vec2Config
from mer_tpu_torch.ops import w2v_conv

CFG = Wav2Vec2Config.base()
LENGTHS = (16000, 4005, 1052)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jx():
    """``mer_tpu``'s side (imported here so the cuda legs run without JAX)."""
    import jax.numpy as jnp

    from mer_tpu.models import wav2vec2
    from mer_tpu.ops import w2v_conv_pallas

    return jnp, wav2vec2, w2v_conv_pallas


def _inputs(b, n_samples, seed=0):
    """A waveform batch and a conv-stack param tree in ``mer_tpu``'s layout
    (kernels [k, in, out], N(0, 1 / fan_in); a GroupNorm that is not the identity)."""
    rng = np.random.default_rng(seed)
    wave = rng.normal(size=(b, n_samples)).astype(np.float32)
    params, c_in = {}, 1
    for i, (c_out, k) in enumerate(zip(CFG.conv_dim, CFG.conv_kernel)):
        params[f"conv_{i}"] = {"kernel": (rng.normal(size=(k, c_in, c_out)) / np.sqrt(k * c_in)).astype(np.float32)}
        c_in = c_out
    params["group_norm"] = {"scale": (1 + 0.1 * rng.normal(size=c_in)).astype(np.float32),
                            "bias": (0.1 * rng.normal(size=c_in)).astype(np.float32)}
    return wave, params


def _torch_weights(params):
    """[out, in, k] conv weights, gamma, beta."""
    weights = [torch.from_numpy(params[f"conv_{i}"]["kernel"].transpose(2, 1, 0).copy()) for i in range(7)]
    return weights, torch.from_numpy(params["group_norm"]["scale"]), torch.from_numpy(params["group_norm"]["bias"])


def _port_extractor(params):
    model = ConvFeatureExtractor(CFG)
    weights, gamma, beta = _torch_weights(params)
    sd = {f"conv_layers.{i}.conv.weight": w for i, w in enumerate(weights)}
    sd.update({"conv_layers.0.layer_norm.weight": gamma, "conv_layers.0.layer_norm.bias": beta})
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _assert_bf16_close(got: torch.Tensor, want) -> None:
    a, b = np.asarray(want).astype(np.float64), got.float().numpy().astype(np.float64)
    assert a.shape == b.shape
    rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-9)
    assert rel < 2e-2, rel


@pytest.mark.parametrize("n_samples", LENGTHS)
def test_layer0_gn_matches_pallas_f32(jx, n_samples):
    jnp, _, pallas = jx
    wave, params = _inputs(2 if n_samples == 16000 else 1, n_samples, seed=n_samples)
    want = np.asarray(pallas.layer0_gn_pallas(params, jnp.asarray(wave), CFG, dtype=jnp.float32, interpret=True))
    weights, gamma, beta = _torch_weights(params)
    got = w2v_conv.layer0_gn(torch.from_numpy(wave), weights[0], gamma, beta, eps=CFG.layer_norm_eps)
    assert got.shape == want.shape == (len(wave), (n_samples - 10) // 5 + 1, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert w2v_conv.layer0_gn.launches == 0  # a CPU tensor takes the plain version


@pytest.mark.parametrize("n_samples", LENGTHS)
def test_conv_tail_matches_pallas_f32(jx, n_samples):
    jnp, _, pallas = jx
    wave, params = _inputs(2 if n_samples == 16000 else 1, n_samples, seed=n_samples + 1)
    want = np.asarray(pallas.conv_stack_fused(params, jnp.asarray(wave), CFG, dtype=jnp.float32, interpret=True))
    x0 = np.array(pallas._layer0(params, jnp.asarray(wave), CFG, jnp.float32))  # what mer_tpu's kernel is fed
    got = w2v_conv.conv_stack_fused(torch.from_numpy(x0), _torch_weights(params)[0][1:])
    assert got.shape == want.shape == (len(wave), w2v_conv.tail_lengths(x0.shape[1])[-1], 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert w2v_conv.conv_stack_fused.launches == 0


@pytest.mark.parametrize("n_samples", LENGTHS)
def test_conv_feature_extractor_matches_jax_f32(jx, n_samples):
    jnp, wav2vec2, _ = jx
    wave, params = _inputs(2, n_samples, seed=n_samples + 2)
    want = np.asarray(wav2vec2.ConvFeatureExtractor(CFG).apply({"params": params}, jnp.asarray(wave)))
    with torch.no_grad():
        got = _port_extractor(params)(torch.from_numpy(wave))
    assert got.shape == want.shape and int(CFG.feat_extract_output_lengths(n_samples)) == got.shape[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bf16_matches_jax(jx):
    """bf16 compute: the wave is cast to bf16 before layer 0 in both packages."""
    jnp, wav2vec2, pallas = jx
    wave, params = _inputs(1, 4005, seed=7)
    weights, gamma, beta = _torch_weights(params)
    x0 = w2v_conv.layer0_gn(torch.from_numpy(wave), weights[0], gamma, beta, dtype=torch.bfloat16)
    assert x0.dtype == torch.bfloat16
    _assert_bf16_close(x0, pallas.layer0_gn_pallas(params, jnp.asarray(wave), CFG, dtype=jnp.bfloat16, interpret=True)
                       .astype(jnp.float32))
    jax_x0 = pallas._layer0(params, jnp.asarray(wave), CFG, jnp.bfloat16)
    tail = w2v_conv.conv_stack_fused(torch.from_numpy(np.array(jax_x0.astype(jnp.float32))).to(torch.bfloat16),
                                     weights[1:])
    assert tail.dtype == torch.bfloat16
    _assert_bf16_close(tail, pallas.conv_stack_fused(params, jnp.asarray(wave), CFG, dtype=jnp.bfloat16,
                                                     interpret=True).astype(jnp.float32))
    with torch.no_grad():
        stack = _port_extractor(params)(torch.from_numpy(wave), torch.bfloat16)
    _assert_bf16_close(stack, wav2vec2.ConvFeatureExtractor(CFG, dtype=jnp.bfloat16)
                       .apply({"params": params}, jnp.asarray(wave)).astype(jnp.float32))


def test_plain_versions_take_any_geometry_and_the_kernels_refuse_it(jx):
    jnp, wav2vec2, _ = jx
    small = wav2vec2.Wav2Vec2Config(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2))
    rng = np.random.default_rng(3)
    wave = rng.normal(size=(2, 800)).astype(np.float32)
    kernels = [rng.normal(size=(k, c_in, 16)).astype(np.float32) * 0.3 for k, c_in in ((10, 1), (3, 16), (2, 16))]
    params = {f"conv_{i}": {"kernel": k} for i, k in enumerate(kernels)}
    params["group_norm"] = {"scale": np.ones(16, np.float32), "bias": np.zeros(16, np.float32)}
    want = np.asarray(wav2vec2.ConvFeatureExtractor(small).apply({"params": params}, jnp.asarray(wave)))
    weights = [torch.from_numpy(k.transpose(2, 1, 0).copy()) for k in kernels]
    x0 = w2v_conv.layer0_gn(torch.from_numpy(wave), weights[0], torch.ones(16), torch.zeros(16))
    got = w2v_conv.conv_stack_fused(x0, weights[1:], (2, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="base layer-0 geometry"):
        w2v_conv.check_layer0_geometry(weights[0], 5)
    with pytest.raises(ValueError, match="base conv geometry"):
        w2v_conv.check_tail_geometry(weights[1:], (2, 2))
    base = [torch.zeros(512, 512, k) for k in w2v_conv.TAIL_TAPS]
    w2v_conv.check_tail_geometry(base, w2v_conv.TAIL_STRIDES)
    with pytest.raises(ValueError, match="base conv geometry"):  # tests/test_w2v_conv_pallas.py:56's geometry
        w2v_conv.check_tail_geometry(base[:4] + [torch.zeros(512, 512, 3), base[5]], w2v_conv.TAIL_STRIDES)
    with pytest.raises(ValueError, match="base layer-0 geometry"):
        w2v_conv.check_layer0_geometry(torch.zeros(512, 1, 8), 5)


def test_tail_lengths_and_stacked_weights():
    assert w2v_conv.tail_lengths(31999) == [15999, 7999, 3999, 1999, 999, 499]
    assert w2v_conv.tail_lengths(6399)[-1] == 99 and w2v_conv.tail_lengths(209) == [104, 51, 25, 12, 6, 3]
    _, params = _inputs(1, 16, seed=5)
    w3, w2 = w2v_conv.stack_tail_weights(_torch_weights(params)[0][1:], torch.float32)
    assert w3.shape == (4, 512, 1536) and w2.shape == (2, 512, 1024)
    for i in range(1, 7):  # the transpose of _stack_weights' layout, kernel.reshape(k * c_in, c_out)
        got = (w3[i - 1] if i < 5 else w2[i - 5]).numpy()
        np.testing.assert_array_equal(got, params[f"conv_{i}"]["kernel"].reshape(-1, 512).T)


# -- on a card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernels K6 and K7 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b, n_samples", [(4, 32000), (2, 40005), (1, 160000), (3, 1052)])
def test_kernels_match_plain_versions(cuda, b, n_samples, dtype, tol):
    wave, params = _inputs(b, n_samples, seed=b)
    weights, gamma, beta = ([w.to(cuda) for w in ws] if isinstance(ws, list) else ws.to(cuda)
                            for ws in _torch_weights(params))
    wave = torch.from_numpy(wave).to(cuda)
    before = w2v_conv.layer0_gn.launches, w2v_conv.conv_stack_fused.launches
    x0 = w2v_conv.layer0_gn(wave, weights[0], gamma, beta, dtype=dtype)
    out = w2v_conv.conv_stack_fused(x0, weights[1:])
    torch.cuda.synchronize()
    assert (w2v_conv.layer0_gn.launches, w2v_conv.conv_stack_fused.launches) == (before[0] + 1, before[1] + 1)
    want0 = w2v_conv.layer0_gn_reference(wave, weights[0], gamma, beta, dtype=dtype)
    want = w2v_conv.conv_tail_reference(x0, weights[1:])
    for got, ref, atol in ((x0, want0, tol), (out, want, 2e-5 if dtype == torch.float32 else tol)):
        assert got.shape == ref.shape and got.dtype == dtype
        scale = 1.0 if dtype == torch.float32 else ref.float().abs().max().item()
        torch.testing.assert_close(got.float(), ref.float(), rtol=atol if dtype == torch.float32 else 0,
                                   atol=atol * scale)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_cuda(cuda):
    wave = torch.zeros(1, 800, device=cuda)
    with pytest.raises(ValueError, match="base layer-0 geometry"):
        w2v_conv.layer0_gn(wave, torch.zeros(16, 1, 10, device=cuda), torch.ones(16, device=cuda),
                           torch.zeros(16, device=cuda))
    with pytest.raises(ValueError, match="base conv geometry"):
        w2v_conv.conv_stack_fused(torch.zeros(1, 100, 16, device=cuda), [torch.zeros(16, 16, 3, device=cuda)], (2,))
    with pytest.raises(ValueError, match="forward-only"):
        w2v_conv.layer0_gn(wave.requires_grad_(), torch.zeros(512, 1, 10, device=cuda),
                           torch.ones(512, device=cuda), torch.zeros(512, device=cuda))
    base = [torch.zeros(512, 512, k, device=cuda) for k in w2v_conv.TAIL_TAPS]
    with pytest.raises(ValueError, match="no frame"):
        w2v_conv.conv_stack_fused(torch.zeros(1, 50, 512, device=cuda), base)
