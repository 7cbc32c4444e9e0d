"""wav2vec2's positional conv as one op (``mer_tpu_torch.ops.pos_conv``): its
plain version, its gradients and routes on the CPU; kernel K9 on a card.

CPU (no card needed):

- the plain version against ``F.conv1d`` (padding 64, last frame dropped) at
  the base geometry [2, T, 768], 16 groups, k 128, T from 1 to 499, with the
  frames past each clip's length zeroed as the encoder zeroes them: in f32,
  and with bf16-rounded operands and an f32 sum (one bf16 rounding apart);
- the op's dx, dW and db against autograd through ``F.conv1d``;
- ``gradcheck`` in f64 on a narrow conv (2 groups of 16 channels, k 8 and 7);
- a CPU tensor takes the plain route; the node is ``ConvolutionPositionalBackward``;
  the route a CUDA input would take, by dtype, channels a group and taps;
- a narrow wav2vec2 model's logits and every gradient against ``mer_tpu``'s.

The ``cuda`` legs skip here; on a machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_pos_conv.py

There the kernel's forward, dx, dW and db are held against the plain version
at the fine-tune's and the export's shapes and at ragged ones, two calls give
the same bits, and CUDA f32 takes the stock route, bf16 the kernel, another
geometry the stock route.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mer_tpu_torch.ops import pos_conv as pc

C, GROUPS, K = 768, 16, 128
FRAMES = (1, 63, 64, 127, 128, 129, 499)
RUNG_FRAMES = (99, 149, 199, 249, 299, 349, 399, 449, 499)  # 2-10 s at 16 kHz, the fine-tune's wave buckets
BF16_REL = 1e-2  # y and dx in bf16: |err| <= this x the plain version's largest |value| (one rounding is 2^-8)
F32_REL = 1e-4  # dW, db in f32 over the same bf16 operands: the sums' order alone


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, t, c=C, groups=GROUPS, k=K, seed=0, dtype=torch.float32):
    """x [b, t, c] with the frames past each clip's length zeroed, weight [c, c / groups, k] (N(0, 1 / fan_in)),
    bias [c]."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=gen)
    for i in range(1, b):  # the first clip fills the width, the others are shorter
        x[i, t - t // (i + 2):] = 0
    w = torch.randn(c, c // groups, k, generator=gen) / np.sqrt(k * c // groups)
    bias = 0.1 * torch.randn(c, generator=gen)
    return x.to(dtype), w.to(dtype), bias.to(dtype)


def _conv1d(x, w, bias, groups):
    """The stock conv of ``ConvPositionalEmbedding`` before the op: [B, T, C] -> [B, T, C]."""
    y = F.conv1d(x.transpose(1, 2), w, bias, padding=w.shape[-1] // 2, groups=groups)
    return y[:, :, :x.shape[1]].transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", FRAMES)
def test_plain_version_against_conv1d(t, dtype):
    x, w, bias = _inputs(2, t, seed=t)
    got = pc.positional_conv_reference(x.to(dtype), w, bias, GROUPS)
    assert got.dtype == dtype and got.shape == (2, t, C)
    if dtype == torch.float32:
        torch.testing.assert_close(got, _conv1d(x, w, bias, GROUPS), rtol=1e-4, atol=1e-5)
        return
    # bf16 operands, f32 sum, one rounding: f32 conv1d over the rounded values, rounded once
    r = lambda v: v.to(dtype).float()
    want = _conv1d(r(x), r(w), r(bias), GROUPS)
    err = (got.float() - want).abs()
    assert (err <= 2 ** -8 * want.abs() + 1e-6).all(), err.max().item()


@pytest.mark.parametrize("t", [64, 129])
def test_gradients_against_conv1d_autograd(t):
    x, w, bias = _inputs(2, t, seed=10 + t)
    g = torch.randn(2, t, C, generator=torch.Generator().manual_seed(t))
    leaves = [v.clone().requires_grad_() for v in (x, w, bias)]
    got = torch.autograd.grad(pc.positional_conv(*leaves, GROUPS), leaves, g)
    ref = [v.clone().requires_grad_() for v in (x, w, bias)]
    want = torch.autograd.grad(_conv1d(*ref, GROUPS), ref, g)
    for name, a, b in zip(("dx", "dW", "db"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item(), msg=name)


@pytest.mark.parametrize("k", [8, 7])
def test_gradcheck_f64_narrow(k):
    x, w, bias = _inputs(2, 11, c=32, groups=2, k=k, seed=k, dtype=torch.float64)
    leaves = [v.requires_grad_() for v in (x, w, bias)]
    assert torch.autograd.gradcheck(lambda *a: pc.positional_conv(*a, 2), leaves)
    # and the op is the conv
    with torch.no_grad():
        torch.testing.assert_close(pc.positional_conv(x, w, bias, 2), _conv1d(x, w, bias, 2))


def test_cpu_route_and_node_name():
    x, w, bias = _inputs(1, 9, c=32, groups=2, k=8)
    before = dict(pc.positional_conv.routes), pc.positional_conv.launches
    y = pc.positional_conv(x, w.requires_grad_(), bias, 2)
    assert pc.positional_conv.routes == {**before[0], "plain": before[0]["plain"] + 1}
    assert pc.positional_conv.launches == before[1]
    assert y.grad_fn.name() == "ConvolutionPositionalBackward" and y.grad_fn.name().startswith("Convolution")
    assert pc.route(x.bfloat16(), w, 2) == "plain"
    with pytest.raises(ValueError, match="expected x"):
        pc.positional_conv(x, w[:16], bias, 2)


@pytest.mark.parametrize("dtype, c, k, want", [
    (torch.bfloat16, 768, 128, "kernel"),  # wav2vec2-base: 16 groups of 48 channels
    (torch.float32, 768, 128, "stock"),
    (torch.float16, 768, 128, "stock"),
    (torch.bfloat16, 1024, 128, "stock"),  # 16 groups of 64 (wav2vec2-large's geometry)
    (torch.bfloat16, 768, 64, "stock"),
])
def test_route_of_a_card_input(dtype, c, k, want):
    """The route an input on the card takes, read from its dtype and shapes alone (no card needed)."""
    x = types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=(2, 9, c))
    assert pc.route(x, torch.empty(c, c // GROUPS, k), GROUPS) == want


def test_transposed_taps_reverse_and_transpose_each_group():
    w = torch.randn(32, 16, 8, generator=torch.Generator().manual_seed(3))
    t = pc.transposed_taps(w, 2)
    for g in range(2):
        for i in range(16):
            for o in range(16):
                torch.testing.assert_close(t[16 * g + i, o], w[16 * g + o, i].flip(0), rtol=0, atol=0)
    torch.testing.assert_close(pc.transposed_taps(t, 2), w, rtol=0, atol=0)


def test_forward_taps_layout():
    w = torch.randn(C, C // GROUPS, K, generator=torch.Generator().manual_seed(4))
    taps = pc.forward_taps(w, GROUPS)
    assert taps.shape == (GROUPS, K, 6, 48, 8) and taps.dtype == torch.bfloat16 and taps.is_contiguous()
    g, j, c, o, e = 5, 77, 4, 31, 6  # B[n = out][k = in] of group g, tap j: in channel 8 c + e
    assert taps[g, j, c, o, e] == w[48 * g + o, 8 * c + e, j].to(torch.bfloat16)


# -- the model against mer_tpu: logits and every gradient ------------------------------------------


def test_wav2vec2_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    from mer_tpu.models import wav2vec2 as jax_w2v
    from mer_tpu_torch.models import audio_state_dict_from_jax
    from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config

    narrow = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=4, intermediate_size=128,
                  num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    rng = np.random.default_rng(7)
    lengths = np.asarray([4000, 2500], np.int32)
    waves = rng.normal(size=(2, 4000)).astype(np.float32) * 0.1
    waves[1, lengths[1]:] = 0
    jax_model = jax_w2v.AudioERC(jax_w2v.Wav2Vec2Config(**narrow))
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(waves[:, :800]), jnp.asarray(lengths))["params"]
    params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32), params)
    r = rng.normal(size=(2, 7)).astype(np.float32)

    loss = lambda p: jnp.sum(jax_model.apply({"params": p}, jnp.asarray(waves), jnp.asarray(lengths)) * r)
    want = audio_state_dict_from_jax(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    port = AudioERC(Wav2Vec2Config(**narrow)).eval()
    port.load_state_dict(audio_state_dict_from_jax(params), strict=True)
    logits = port(torch.from_numpy(waves), torch.from_numpy(lengths))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(
        jax_model.apply({"params": params}, jnp.asarray(waves), jnp.asarray(lengths))), rtol=1e-4, atol=1e-4)
    (logits * torch.from_numpy(r)).sum().backward()
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    # the attention's key biases have a zero true gradient (rounding noise on both sides): one limit for all leaves,
    # from the largest gradient
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5 * scale, err_msg=name)


# -- on a card ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel K9 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _kernel_against_plain(device, b, t, c, groups, seed):
    x, w, bias = _inputs(b, t, c=c, groups=groups, seed=seed)
    x = x.to(device, torch.bfloat16)
    w, bias = w.to(device), bias.to(device)
    leaves = [v.clone().requires_grad_() for v in (x, w, bias)]
    routes, launches = dict(pc.positional_conv.routes), pc.positional_conv.launches
    y = pc.positional_conv(*leaves, groups)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed + 1)).to(device, torch.bfloat16)
    got = (y, *torch.autograd.grad(y, leaves, dy))
    assert pc.positional_conv.routes["kernel"] == routes["kernel"] + 1
    assert pc.positional_conv.launches == launches + 3
    want = (pc.positional_conv_reference(x, w, bias, groups),
            *pc.positional_conv_reference_backward(dy, x, w, groups))
    for name, a, ref, rel in zip(("y", "dx", "dW", "db"), got, want, (BF16_REL, BF16_REL, F32_REL, F32_REL)):
        assert a.shape == ref.shape, name
        assert _rel(a, ref) <= rel, (name, _rel(a, ref))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("t", RUNG_FRAMES + (1, 63, 64, 129, 257, 4499))
def test_kernel_matches_plain_version_base(cuda, t):
    _kernel_against_plain(cuda, 16 if t < 1000 else 2, t, C, GROUPS, seed=t)


@pytest.mark.cuda
@pytest.mark.parametrize("t", RUNG_FRAMES[::2])
def test_kernel_matches_plain_version_export_batch(cuda, t):
    _kernel_against_plain(cuda, 32, t, C, GROUPS, seed=100 + t)


@pytest.mark.cuda
def test_two_calls_give_the_same_bits(cuda):
    a = _kernel_against_plain(cuda, 16, 499, C, GROUPS, seed=5)
    b = _kernel_against_plain(cuda, 16, 499, C, GROUPS, seed=5)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_card_routes(cuda):
    x, w, bias = _inputs(2, 50, seed=1)
    x, w, bias = x.to(cuda), w.to(cuda), bias.to(cuda)
    before = dict(pc.positional_conv.routes)
    leaves = [v.clone().requires_grad_() for v in (x, w, bias)]
    y32 = pc.positional_conv(*leaves, GROUPS)
    assert pc.positional_conv.routes["stock"] == before["stock"] + 1 and y32.dtype == torch.float32
    torch.testing.assert_close(y32, pc.positional_conv_reference(x, w, bias, GROUPS), rtol=1e-4, atol=1e-4)
    dy = torch.randn(y32.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    got = torch.autograd.grad(y32, leaves, dy)
    for name, a, ref in zip(("dx", "dW", "db"), got, pc.positional_conv_reference_backward(dy, x, w, GROUPS)):
        torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item(), msg=name)
    pc.positional_conv(x.bfloat16(), w, bias, GROUPS)
    assert pc.positional_conv.routes["kernel"] == before["kernel"] + 1
    narrow = pc.positional_conv(x[..., :32].bfloat16(), w[:32, :16, :8].contiguous(), bias[:32], 2)
    assert pc.positional_conv.routes["stock"] == before["stock"] + 2 and narrow.shape == (2, 50, 32)
    xl, wl, bl = _inputs(2, 50, c=1024, groups=16, seed=3)  # 64 channels a group (wav2vec2-large's geometry)
    large = pc.positional_conv(xl.to(cuda, torch.bfloat16), wl.to(cuda), bl.to(cuda), 16)
    assert pc.positional_conv.routes["stock"] == before["stock"] + 3 and large.shape == (2, 50, 1024)
