"""The port's attention (mer_tpu_torch.ops) against the JAX package's.

The plain version ``flash_attention_reference`` is held against the TPU
kernel K1 (``mer_tpu.ops.flash_attention._flash_impl``) in interpret mode and
against ``_attention_reference``, in float32 within 1e-5, with masks that
include an all-padding row (key 0 kept attendable), Sq != Sk and head dims
that are not powers of two. The JAX side is imported inside a fixture, so
the ``cuda`` legs also run on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import _build
from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.ops.attention import dot_product_attention

# (B, H, Sq, Sk, Dh)
CASES = [
    (3, 2, 8, 8, 12),
    (2, 4, 16, 16, 8),
    (2, 2, 24, 33, 12),   # Sq != Sk
    (2, 3, 9, 9, 7),      # odd head dim
    (2, 2, 5, 40, 50),    # more keys than one 32-key kernel tile; dh of the mel config
]


def _inputs(case, seed=0):
    b, h, sq, sk, dh = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32) for s in (sq, sk, sk))
    lengths = rng.integers(1, sk + 1, size=b)
    mask = np.arange(sk)[None, :] >= lengths[:, None]
    mask[0] = True
    mask[0, 0] = False  # all-padding row, key 0 attendable (collate guard)
    return q, k, v, mask


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.fixture(scope="module")
def jax_attention():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mer_tpu.ops.attention import _attention_reference
    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_impl

    def k1(q, k, v, mask):
        key_bias = jnp.where(jnp.asarray(mask), _NEG_INF, 0.0).astype(jnp.float32)
        out, lse = _flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_bias,
                               interpret=True, return_stats=True)
        return np.asarray(out), np.asarray(lse)

    def reference(q, k, v, mask):
        return np.asarray(_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_padding_mask=jnp.asarray(mask),
            dropout_rate=0.0, dropout_rng=None, deterministic=True))

    return k1, reference


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_k1_interpret(case, jax_attention):
    k1, _ = jax_attention
    q, k, v, mask = _inputs(case)
    out_j, lse_j = k1(q, k, v, mask)
    out_t, lse_t = fa.flash_attention_reference(*_t(q, k, v, mask))
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_attention_reference(case, jax_attention):
    _, reference = jax_attention
    q, k, v, mask = _inputs(case, seed=1)
    out_t, _ = fa.flash_attention_reference(*_t(q, k, v, mask))
    np.testing.assert_allclose(out_t.numpy(), reference(q, k, v, mask), rtol=0, atol=1e-5)


def test_cpu_path_is_the_plain_version_and_never_launches():
    q, k, v, mask = _t(*_inputs(CASES[2]))
    before = fa.flash_attention_forward.launches
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, mask)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    torch.testing.assert_close(dot_product_attention(q, k, v, key_padding_mask=mask), ref_out, rtol=0, atol=0)
    assert fa.flash_attention_forward.launches == before == 0


def test_no_mask_equals_all_false_mask():
    q, k, v, mask = _t(*_inputs(CASES[0]))
    out_none, lse_none = fa.flash_attention_reference(q, k, v, None)
    out_false, lse_false = fa.flash_attention_reference(q, k, v, torch.zeros_like(mask))
    torch.testing.assert_close(out_none, out_false, rtol=0, atol=0)
    torch.testing.assert_close(lse_none, lse_false, rtol=0, atol=0)


def test_dropout_path_is_the_plain_version_with_a_philox_mask():
    """With dropout the CPU path is the plain version on a mask drawn from the
    caller's generator: zero where dropped, the undropped softmax over
    (1 - rate) where kept. It needs a generator and a rate in [0, 1)."""
    q, k, v, mask = _t(*_inputs(CASES[0]))
    seed = tuple(torch.randint(0, 1 << 32, (2,), generator=torch.Generator().manual_seed(9)).tolist())
    out = dot_product_attention(q, k, v, key_padding_mask=mask, dropout_rate=0.1,
                                generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v, mask, seed, 0.1)[0], rtol=0, atol=0)
    probs = torch.softmax(fa._scores(q, k, mask, torch.float32), dim=-1)
    factor = fa.dropout_factor(seed, probs.shape, 0.1)
    torch.testing.assert_close(out, torch.einsum("bhqk,bhkd->bhqd", probs * factor, v), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="Generator"):
        dot_product_attention(q, k, v, key_padding_mask=mask, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        dot_product_attention(q, k, v, dropout_rate=1.0, generator=torch.Generator())


@pytest.mark.parametrize("bad, error", [
    ("head_dim", ValueError), ("dtype", TypeError), ("contiguous", ValueError), ("mask_dtype", ValueError),
])
def test_wrapper_check_rejects_what_the_kernel_does_not_take(bad, error):
    q, k, v, mask = _t(*_inputs(CASES[0]))
    if bad == "head_dim":
        q = k = v = torch.zeros(1, 1, 4, fa.MAX_HEAD_DIM + 1)
        mask = torch.zeros(1, 4, dtype=torch.bool)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        mask = mask.to(torch.uint8)
    with pytest.raises(error):
        fa._check(q, k, v, mask)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 out: within the a priori rounding bound (chip_smoke.py's: parallel_check.sum_bound of the plain version plus
# one ulp of the larger value, element by element; test_bf16_out_bound_fails_a_dropped_key) and within BF16_REL x
# the plain version's largest |out| (tests/test_torch_attention_tc.py)
BF16_REL = 2e-2


def _bf16_out_excess(out, ref_out, plain, q, k, v, mask, seed=None, rate=0.0) -> float:
    """Largest excess of a bf16 forward's out over the rounding bound against its plain version (<= 0 passes)."""
    from mer_tpu_torch.scripts.parallel_check import bf16_out_excess, sum_bound

    return bf16_out_excess(out, ref_out, sum_bound(plain, q, k, v, mask, seed, rate))


@pytest.mark.parametrize("case, rate", [((32, 8, 24, 33, 96), 0.4), ((2, 2, 5, 40, 50), 0.0),
                                        ((2, 3, 100, 301, 64), 0.1)])
def test_bf16_out_bound_fails_a_dropped_key(case, rate):
    """The bf16 limit of the card legs on the plain versions (CPU): K3's plain version (an online softmax that
    rounds P o D against the running max, not the normalised P) lies within the bound of K1's, and K1's with
    the last key of every row dropped (a planted fault) does not."""
    q, k, v, mask = _inputs(case, seed=3)
    q, k, v = (torch.from_numpy(a / math.sqrt(3)).to(torch.bfloat16) for a in (q, k, v))
    mask = torch.from_numpy(mask)
    mask[:, -1] = False  # the last key is attended, so that dropping it is a fault
    seed = (0xFACE, 21) if rate else None
    want, _ = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    other, _ = fa.flash_attention_stream_reference(q, k, v, mask, seed, rate)
    dropped = mask.clone()
    dropped[:, -1] = True
    fault, _ = fa.flash_attention_reference(q, k, v, dropped, seed, rate)
    assert not torch.equal(other, want)
    assert _bf16_out_excess(other, want, fa.flash_attention_reference, q, k, v, mask, seed, rate) <= 0
    assert _bf16_out_excess(fault, want, fa.flash_attention_reference, q, k, v, mask, seed, rate) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(32, 8, 33, 33, 96), (4, 2, 70, 70, 128), (1, 1, 1, 1, 1)])
@pytest.mark.parametrize("dtype, tol_out, tol_lse", [(torch.float32, 2e-5, 2e-5), (torch.bfloat16, 1e-2, 1e-3)])
def test_kernel_matches_plain_version(case, dtype, tol_out, tol_lse, cuda):
    """out within tol_out in f32; in bf16 within the rounding bound and BF16_REL x its largest value (tol_out,
    TOL's elementwise 1e-2, no longer holds it: two correct roundings can break it, chip_smoke.py's
    rounding_witness); lse within tol_lse."""
    q, k, v, mask = _inputs(case, seed=2)
    # main-path scale (unit-variance activations through U(+-1/sqrt(D)) weights)
    q, k, v = (torch.from_numpy(a / math.sqrt(3)).to(cuda, dtype) for a in (q, k, v))
    mask = torch.from_numpy(mask).to(cuda)
    before = fa.flash_attention_forward.launches
    for m in (mask, None):
        out, lse = fa.flash_attention_forward(q, k, v, m)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, m)  # rounds P to bf16 as the kernel does
        assert out.dtype == dtype and lse.dtype == torch.float32
        err = (out.float() - ref_out.float()).abs().max().item()
        if dtype == torch.bfloat16:
            assert _bf16_out_excess(out, ref_out, fa.flash_attention_reference, q, k, v, m) <= 0
            assert err <= BF16_REL * ref_out.float().abs().max().item()
        else:
            assert err <= tol_out
        assert (lse - ref_lse).abs().max().item() <= tol_lse
    assert fa.flash_attention_forward.launches == before + 2


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_cuda(cuda):
    q = torch.zeros(1, 1, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_forward(q, q, q)
    q = torch.zeros(1, 1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="Generator"):
        dot_product_attention(q, q, q, dropout_rate=0.4)


@pytest.mark.cuda
def test_model_forward_on_card_matches_cpu(cuda):
    from mer_tpu_torch.models import M2FNet, init_random_

    model = init_random_(M2FNet(d_model_audio=48, d_model_text=48, d_model_fam=48, n_head_audio=4,
                                n_head_text=4, n_head_fam=4, n_layers_audio=2, n_layers_text=2,
                                n_layers_fam=2, hidden_size_classifier=48),
                         torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    text, audio = (torch.from_numpy(rng.normal(size=(4, 16, 48)).astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(np.arange(16)[None, :] >= np.array([[16], [9], [3], [1]]))
    with torch.inference_mode():
        cpu = model(text, audio, mask)
        before = fa.flash_attention_forward.launches
        gpu = model.to(cuda)(text.to(cuda), audio.to(cuda), mask.to(cuda)).cpu()
    assert fa.flash_attention_forward.launches - before == 2 + 2 + 2
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=1e-4)
