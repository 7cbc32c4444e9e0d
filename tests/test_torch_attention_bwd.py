"""The port's attention backward and dropout against the JAX package's.

The plain backward ``flash_attention_backward_reference`` is held against the
TPU kernel K2 (``mer_tpu.ops.flash_attention._flash_bwd_fused``) in interpret
mode and against ``jax.vjp`` of ``_attention_reference``, in float32 within
5e-5 (sums over up to 40 keys or rows of products of unit-scale values), with
and without a mask, Sq != Sk, head dims 50 and 7, and an lse cotangent. The
autograd Function is checked with ``gradcheck`` in float64, dropout on and
off.

Dropout cannot be compared with JAX: its in-kernel dropout draws from the TPU
hardware generator and has no interpret mode (``flash_attention.py:174-175``;
``test_jax_dropout_has_no_interpret_mode`` pins that). So the Philox mask is
checked on its own: the generator against its published known-answer
vectors, the keep rate against binomial bounds, the mask's independence of
tiling, and forward/backward consistency against autograd through the plain
forward. On the card (``cuda`` marker) the kernels are held against these
plain versions, exactly for the mask:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bwd.py
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.ops.attention import dot_product_attention

# (B, H, Sq, Sk, Dh)
CASES = [
    (3, 2, 8, 8, 12),
    (2, 2, 24, 33, 12),   # Sq != Sk
    (2, 3, 9, 9, 7),      # odd head dim
    (2, 2, 5, 40, 50),    # more keys than one 32-key tile; dh of the mel config
]
TOL = 5e-5  # float32: sums of at most 40 products of unit-scale values


def _inputs(case, seed=0, mask_kind="dialogue"):
    b, h, sq, sk, dh = case
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, h, sq, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, dh)).astype(np.float32) for _ in range(2))
    mask = None
    if mask_kind == "dialogue":
        lengths = rng.integers(1, sk + 1, size=b)
        mask = np.arange(sk)[None, :] >= lengths[:, None]
        mask[0] = True
        mask[0, 0] = False  # all-padding row, key 0 attendable (collate guard)
    elif mask_kind == "fully_masked":
        mask = rng.random((b, sk)) < 0.3
        mask[0] = True  # every key of batch row 0 ignored
    return q, k, v, g, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from mer_tpu.ops.attention import _attention_reference
    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_bwd_fused, _flash_impl, flash_attention

    def bias_of(mask, b, sk):
        m = np.zeros((b, sk), bool) if mask is None else mask
        return jnp.where(jnp.asarray(m), _NEG_INF, 0.0).astype(jnp.float32)

    def k2(q, k, v, mask, g, g_lse=None):
        bias = bias_of(mask, q.shape[0], k.shape[2])
        q, k, v, g = (jnp.asarray(a) for a in (q, k, v, g))
        out, lse = _flash_impl(q, k, v, bias, interpret=True, return_stats=True)
        grads = _flash_bwd_fused(q, k, v, bias, out, lse, g, interpret=True,
                                 g_lse=None if g_lse is None else jnp.asarray(g_lse))
        return [np.asarray(x) for x in grads]

    def vjp_reference(q, k, v, mask, g):
        m = None if mask is None else jnp.asarray(mask)
        f = lambda q, k, v: _attention_reference(q, k, v, key_padding_mask=m, dropout_rate=0.0,
                                                 dropout_rng=None, deterministic=True)
        _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(x) for x in vjp(jnp.asarray(g))]

    return {"k2": k2, "vjp": vjp_reference, "flash_attention": flash_attention, "jnp": jnp}


def _plain_grads(q, k, v, g, mask, seed=None, rate=0.0, g_lse=None):
    q, k, v, g, mask = _t(q, k, v, g, mask)
    out, lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    return fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)


@pytest.mark.parametrize("mask_kind", ["dialogue", "none"])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_k2_interpret(case, mask_kind, jax_side):
    q, k, v, g, mask = _inputs(case, mask_kind=mask_kind)
    want = jax_side["k2"](q, k, v, mask, g)
    for got, w in zip(_plain_grads(q, k, v, g, mask), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=TOL)


@pytest.mark.parametrize("mask_kind", ["dialogue", "none", "fully_masked"])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp_of_reference(case, mask_kind, jax_side):
    """Includes a fully masked row, where recomputing P from the lse would
    give 1 per key; the reference's softmax gives 1/Sk (the TPU kernel pads
    keys to 128, so its fully masked rows differ and it is not compared)."""
    q, k, v, g, mask = _inputs(case, seed=1, mask_kind=mask_kind)
    want = jax_side["vjp"](q, k, v, mask, g)
    for got, w in zip(_plain_grads(q, k, v, g, mask), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=TOL)


def test_plain_backward_lse_cotangent_matches_k2(jax_side):
    case = CASES[1]
    q, k, v, g, mask = _inputs(case, seed=2)
    g_lse = np.random.default_rng(3).normal(size=case[:3]).astype(np.float32)
    want = jax_side["k2"](q, k, v, mask, g, g_lse)
    for got, w in zip(_plain_grads(q, k, v, g, mask, g_lse=torch.from_numpy(g_lse)), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=TOL)


def test_jax_dropout_has_no_interpret_mode(jax_side):
    jnp = jax_side["jnp"]
    x = jnp.zeros((1, 1, 4, 8), jnp.float32)
    with pytest.raises(ValueError, match="no interpret mode"):
        jax_side["flash_attention"](x, x, x, dropout_rate=0.1, dropout_seed=jnp.zeros(2, jnp.int32),
                                    interpret=True)


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_function_gradcheck_float64(rate):
    """Gradients of both outputs (out and lse) of the autograd Function. No
    fully masked row here: its scores round to -1e30 whatever q and k are, so
    finite differences see a constant there."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 5, 6))).requires_grad_() for _ in range(3))
    mask = torch.tensor([[False, False, True, True, False], [True, True, True, True, False]])
    seed = (123, 456) if rate else None
    assert torch.autograd.gradcheck(lambda q, k, v: fa.FlashAttention.apply(q, k, v, mask, seed, rate),
                                    (q, k, v))


@pytest.mark.parametrize("mask_kind", ["dialogue", "fully_masked"])
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_function_backward_equals_autograd_of_plain_forward(rate, mask_kind):
    """The Function's backward (the plain backward on the CPU) against
    torch.autograd through the plain forward with the same seed: the
    dropout mask the backward regenerates is the forward's. float32, 5e-5."""
    q, k, v, g, mask = _t(*_inputs(CASES[3], seed=5, mask_kind=mask_kind))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    seed = (7, 2 ** 32 - 1) if rate else None
    out, _ = fa.FlashAttention.apply(q, k, v, mask, seed, rate)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(fa.flash_attention_reference(q, k, v, mask, seed, rate)[0], (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    assert fa.flash_attention_backward.launches == 0


# Random123's known-answer vectors for philox4x32_10 (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = fa.philox4x32([torch.tensor(c) for c in counter], key)
    assert [int(w) for w in got] == list(want)


@pytest.mark.parametrize("rate", [0.1, 0.4])
def test_dropout_keep_rate_within_binomial_bounds(rate):
    factor = fa.dropout_factor((11, 22), (4, 8, 64, 64), rate)
    n = factor.numel()
    kept = int((factor > 0).sum())
    sigma = math.sqrt(n * rate * (1 - rate))
    assert abs(kept - n * (1 - rate)) < 5 * sigma
    values = torch.unique(factor).tolist()
    assert values[0] == 0.0 and values[1:] == [pytest.approx(1 / (1 - rate))]


def test_dropout_mask_independent_of_tiling():
    """A pure function of (seed, bh, row, col): tiles drawn with offsets, of
    sizes that do not divide the block, reassemble into the whole."""
    seed, shape, rate = (5, 9), (2, 3, 33, 40), 0.4
    whole = fa.dropout_factor(seed, shape, rate)
    tiled = torch.empty_like(whole)
    for r0 in range(0, 33, 16):
        for c0 in range(0, 40, 32):
            rows, cols = min(16, 33 - r0), min(32, 40 - c0)
            tiled[:, :, r0:r0 + rows, c0:c0 + cols] = fa.dropout_factor(seed, (2, 3, rows, cols), rate,
                                                                       row0=r0, col0=c0)
    torch.testing.assert_close(tiled, whole, rtol=0, atol=0)
    assert not torch.equal(whole, fa.dropout_factor((5, 10), shape, rate))


def test_dot_product_attention_dropout_draws_from_its_generator():
    q, k, v, g, mask = _t(*_inputs(CASES[0], seed=6))
    gen = torch.Generator().manual_seed(3)
    seed = tuple(torch.randint(0, 1 << 32, (2,), generator=torch.Generator().manual_seed(3)).tolist())
    global_state = torch.get_rng_state()
    out = dot_product_attention(q, k, v, key_padding_mask=mask, dropout_rate=0.4, generator=gen)
    assert torch.equal(torch.get_rng_state(), global_state)  # the global RNG is untouched
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v, mask, seed, 0.4)[0], rtol=0, atol=0)
    # the next call draws new seed words
    again = dot_product_attention(q, k, v, key_padding_mask=mask, dropout_rate=0.4, generator=gen)
    assert not torch.equal(out, again)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel against plain version, same inputs, |got - want| <= atol + rtol |want|:
# f32 (1e-4, 1e-5), sums in another order; bf16 (2e-2, 2**-7): both sides
# round an f32 value to bf16, and the two f32 values, summed in other orders,
# may fall on either side of a rounding boundary: one bf16 ulp, at most
# 2**-7 |want| (dv of a key that every row of a short dialogue attends to
# reaches |dv| ~ 10, where an ulp is 0.0625)
CARD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2.0 ** -7)}
CARD_CASES = CASES + [(32, 8, 33, 33, 96), (4, 2, 70, 70, 128), (1, 1, 1, 1, 1), (1, 2, 40, 2048, 64)]


def _excess(got, want, dtype) -> float:
    """Largest |got - want| beyond the CARD_TOL allowance (<= 0 passes)."""
    atol, rtol = CARD_TOL[dtype]
    got, want = got.float(), want.float()
    return ((got - want).abs() - atol - rtol * want.abs()).max().item()


def _card_inputs(case, dtype, device, seed, mask_kind):
    q, k, v, g, mask = _inputs(case, seed=seed, mask_kind=mask_kind)
    # main-path scale (unit-variance activations through U(+-1/sqrt(D)) weights)
    q, k, v, g = (torch.from_numpy(a / math.sqrt(3)).to(device, dtype) for a in (q, k, v, g))
    return q, k, v, g, None if mask is None else torch.from_numpy(mask).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("mask_kind", ["dialogue", "fully_masked", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_plain_versions(case, dtype, mask_kind, rate, cuda):
    q, k, v, g, mask = _card_inputs(case, dtype, cuda, 7, mask_kind)
    seed = (0xDEADBEEF, 17) if rate else None
    g_lse = torch.randn(case[:3], device=cuda) if mask_kind == "none" else None
    launches = (fa.flash_attention_forward.launches, fa.flash_attention_backward.launches,
                fa.flash_attention_tiled_backward.launches)
    out, lse = fa.flash_attention_forward(q, k, v, mask, seed, rate)
    grads = fa.flash_attention_backward(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    ref = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    assert _excess(out, ref_out, dtype) <= 0
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for got, want in zip(grads, ref):
        assert got.dtype == dtype
        assert _excess(got, want, dtype) <= 0
    fused = case[3] <= fa.BWD_FUSED_MAX  # above it the backward's dispatch takes K4
    assert (fa.flash_attention_forward.launches, fa.flash_attention_backward.launches,
            fa.flash_attention_tiled_backward.launches) == (launches[0] + 1, launches[1] + fused,
                                                            launches[2] + 1 - fused)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 8, 33, 33), (2, 3, 70, 100)])
def test_kernel_dropout_masks_equal_plain_mask_exactly(shape, cuda):
    """v = identity makes out[i, j] = P_ij D_ij, g = identity makes
    dv[j, i] = P_ij D_ij: the kernels' masks read off exactly."""
    b, h, sq, sk = shape
    seed, rate = (1234, 98765), 0.4
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, cuda) > 0
    eye = lambda n: torch.eye(n, device=cuda).expand(b, h, n, n).contiguous()
    # forward, head dim Sk: v = I
    q, k = torch.randn(b, h, sq, sk, device=cuda), torch.randn(b, h, sk, sk, device=cuda)
    out, _ = fa.flash_attention_forward(q, k, eye(sk), None, seed, rate)
    assert torch.equal(out > 0, want)
    # backward, head dim Sq: g = I
    q, k, v = torch.randn(b, h, sq, sq, device=cuda), *torch.randn(2, b, h, sk, sq, device=cuda)
    out, lse = fa.flash_attention_forward(q, k.contiguous(), v.contiguous(), None, seed, rate)
    _, _, dv = fa.flash_attention_backward(q, k.contiguous(), v.contiguous(), None, out, lse, eye(sq), seed, rate)
    assert torch.equal(dv.transpose(2, 3) > 0, want)


@pytest.mark.cuda
def test_kernel_backward_reproduces_bitwise(cuda):
    q, k, v, g, mask = _card_inputs((32, 8, 33, 33, 96), torch.float32, cuda, 8, "dialogue")
    out, lse = fa.flash_attention_forward(q, k, v, mask, (3, 4), 0.4)
    first = fa.flash_attention_backward(q, k, v, mask, out, lse, g, (3, 4), 0.4)
    second = fa.flash_attention_backward(q, k, v, mask, out, lse, g, (3, 4), 0.4)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_kernel_backward_raises_beyond_its_range(cuda):
    """K2's kernel refuses more than FUSED_KERNEL_MAX keys; the backward hands
    such calls, as every call above BWD_FUSED_MAX keys, to K4 and never
    launches K2 there."""
    q = torch.zeros(1, 1, 4, 8, device=cuda)
    k = torch.zeros(1, 1, fa.FUSED_KERNEL_MAX + 1, 8, device=cuda)
    out, lse = fa.flash_attention_forward(q, k, k)
    g = torch.zeros_like(q)
    dq, dk, dv, drop = fa._backward_args(q, k, k, None, out, lse, g, None, 0.0, None)
    delta, route = torch.empty(q.shape[:3], device=cuda), ctypes.c_int(-1)
    with pytest.raises(RuntimeError, match="flash_attention_bwd launch failed"):
        fa._launch("flash_attention_bwd", q, [q.data_ptr(), k.data_ptr(), k.data_ptr(), None, out.data_ptr(),
                                              lse.data_ptr(), g.data_ptr(), None, dq.data_ptr(), dk.data_ptr(),
                                              dv.data_ptr(), delta.data_ptr(), ctypes.addressof(route)], k.shape[2],
                   drop)
    launches = fa.flash_attention_backward.launches, fa.flash_attention_tiled_backward.launches
    fa.flash_attention_backward(q, k, k, None, out, lse, g)
    assert (fa.flash_attention_backward.launches, fa.flash_attention_tiled_backward.launches) == (
        launches[0], launches[1] + 1)
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_forward(q, q, q, None, None, 0.4)


@pytest.mark.cuda
def test_gradients_through_the_model_on_card_match_cpu(cuda):
    """Every attention of the model trains on the card: in train mode
    (dropout 0, f32) the gradients of each in-projection, which reach it only
    through attention's q, k and v, equal the CPU's. Before the autograd
    Function the kernel's output had no grad_fn and these were None."""
    from mer_tpu_torch.models import M2FNet, init_random_

    model = init_random_(M2FNet(d_model_audio=48, d_model_text=48, d_model_fam=48, n_head_audio=4,
                                n_head_text=4, n_head_fam=4, n_layers_audio=2, n_layers_text=2,
                                n_layers_fam=2, hidden_size_classifier=48, dropout=0.0),
                         torch.Generator().manual_seed(0)).train()
    rng = np.random.default_rng(0)
    text, audio = (torch.from_numpy(rng.normal(size=(4, 16, 48)).astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(np.arange(16)[None, :] >= np.array([[16], [9], [3], [1]]))
    grads = {}
    for device in ("cpu", cuda):
        model.to(device).zero_grad()
        before = fa.flash_attention_backward.launches
        model(text.to(device), audio.to(device), mask.to(device)).square().sum().backward()
        # copies: moving the model moves the .grad tensors it holds
        grads[str(device)] = {n: p.grad.to("cpu", copy=True) for n, p in model.named_parameters() if "in_proj" in n}
    assert fa.flash_attention_backward.launches - before == 2 + 2 + 2
    assert len(grads["cpu"]) == 2 * (2 + 2 + 2)
    for name, want in grads["cpu"].items():
        got = grads[str(cuda)][name]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        # f32 sums in another order through up to 4 layers: relative to the
        # tensor's largest entry
        assert scale > 0 and err <= 1e-3 * scale, f"{name}: max abs diff {err}, max |grad| {scale}"
