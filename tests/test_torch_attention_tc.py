"""K1 and K2 on the tensor cores: the plain versions' bf16 rounding against the
JAX package, and the kernels against their plain versions on the card.

In bf16 the plain forward rounds the probabilities (after dropout) to v's
dtype before the product with v, as the TPU kernel does (``p.astype(v.dtype)``,
``mer_tpu/ops/flash_attention.py:117``): at a head dim whose 1/sqrt(Dh) is a
power of two it equals ``_flash_impl`` in interpret mode bit for bit, in bf16.
The plain fused backward (K2's) and the plain key-tiled backward (K4's) are one
rule, P o D and dS rounded to the input dtype before their products: at up to
``BLOCK_K`` keys they agree bit for bit, in f32 and bf16.

On the card (``cuda`` marker) K1 and K2 are held against these plain versions
at the fusion, text and wav2vec2 shapes, at the edges of the slice packing
(B*H not a multiple of the slices a block takes, Sq = 8, 17, 33), Sq != Sk and
Dh 50, 64, 96; in bf16 within ``TOL`` and within ``BF16_REL`` of the plain
version's largest |value| per tensor, a limit shown to fail on rolled key
tiles; the dropout masks exactly; f32 K2 bit for bit from run to run:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_tc.py
"""

import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, sq, sk, dh, seed=0, mask_kind="clips"):
    """q, k, v, g at the main path's scale (variance 1/3) and a key mask:
    ``clips`` keeps each row's first L >= Sk/2 keys less a scattered 10% (key
    0 always), ``fully_masked`` also ignores every key of batch row 0,
    ``none`` is no mask."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, h, sq, dh)).astype(np.float32) / math.sqrt(3) for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, dh)).astype(np.float32) / math.sqrt(3) for _ in range(2))
    if mask_kind == "none":
        return q, k, v, g, None
    lengths = rng.integers(sk // 2, sk + 1, size=b)
    mask = (np.arange(sk)[None, :] >= lengths[:, None]) | (rng.random((b, sk)) < 0.1)
    mask[:, 0] = False
    if mask_kind == "fully_masked":
        mask[0] = True
    return q, k, v, g, mask


def _t(*arrays, device="cpu", dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(device, dtype if a.dtype != bool else torch.bool)
            for a in arrays]


# -- the plain versions' rounding, on the CPU ------------------------------------------------


@pytest.fixture(scope="module")
def jax_k1():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_impl

    def k1(q, k, v, mask):
        """_flash_impl in interpret mode on the bf16 values of q, k, v: (out, lse) as f32 numpy."""
        q, k, v = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
        bias = jnp.where(jnp.asarray(mask.numpy()), _NEG_INF, 0.0).astype(jnp.float32)
        out, lse = _flash_impl(q, k, v, bias, interpret=True, return_stats=True)
        return np.asarray(out.astype(jnp.float32)), np.asarray(lse)

    return k1


@pytest.mark.parametrize("shape", [(2, 2, 24, 24, 16), (2, 2, 24, 33, 64), (2, 3, 17, 70, 64)])
def test_plain_forward_bf16_equals_tpu_kernel_bitwise(shape, jax_k1):
    """1/sqrt(Dh) a power of two, so the TPU kernel's q * scale is exact in
    bf16: the plain forward's out equals the TPU kernel's bit for bit (without
    the rounding of P, about 40% of the entries differ by an ulp)."""
    q, k, v, _, mask = _t(*_inputs(*shape, seed=1), dtype=torch.bfloat16)
    want_out, want_lse = jax_k1(q, k, v, mask)
    out, lse = fa.flash_attention_reference(q, k, v, mask)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), want_out)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 9, 40, 50), (2, 2, 33, 33, 96)])
def test_plain_forward_bf16_within_two_ulps_of_tpu_kernel(shape, jax_k1):
    """Dh 50 and 96: the TPU kernel also rounds q * scale to bf16 before its
    product, so the two part by at most two ulps of the largest |out|."""
    q, k, v, _, mask = _t(*_inputs(*shape, seed=2), dtype=torch.bfloat16)
    want_out, _ = jax_k1(q, k, v, mask)
    out, _ = fa.flash_attention_reference(q, k, v, mask)
    np.testing.assert_allclose(out.float().numpy(), want_out, rtol=0, atol=2.0 ** -7 * np.abs(want_out).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, mask_kind, rate", [
    ((2, 2, 24, 33, 12), "clips", 0.0),
    ((2, 3, 64, 512, 64), "fully_masked", 0.3),
    ((1, 2, 40, 200, 50), "none", 0.0),
])
def test_fused_backward_plain_equals_tiled_bitwise(shape, mask_kind, rate, dtype):
    """Up to BLOCK_K keys the key-tiled plain backward takes one tile, and
    the fused one (K2's) follows the same rule: equal bit for bit, with an
    lse cotangent, a fully masked row and dropout."""
    q, k, v, g, mask = _t(*_inputs(*shape, seed=3, mask_kind=mask_kind), dtype=dtype)
    seed = (77, 88) if rate else None
    g_lse = torch.from_numpy(np.random.default_rng(4).normal(size=shape[:3]).astype(np.float32))
    out, lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    fused = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    tiled = fa.flash_attention_tiled_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    for a, b in zip(fused, tiled):
        assert a.dtype == dtype and torch.equal(a, b)


def test_plain_backward_rounds_ds_in_bf16_only():
    """In bf16 dS and P o D are rounded before their products, so the bf16
    gradients differ from the f32 plain version run on the same values by
    more than the final rounding alone; in f32 nothing is rounded (the
    gradients equal autograd through the plain forward, test_torch_attention_bwd)."""
    q, k, v, g, mask = _t(*_inputs(2, 2, 33, 33, 64, seed=5), dtype=torch.bfloat16)
    out, lse = fa.flash_attention_reference(q, k, v, mask)
    got = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g)
    f32 = fa.flash_attention_backward_reference(*(x.float() for x in (q, k, v)), mask, out.float(), lse, g.float())
    unrounded = [x.to(torch.bfloat16) for x in f32]
    assert any(not torch.equal(a, b) for a, b in zip(got, unrounded))
    for a, b in zip(got, f32):
        assert (a.float() - b).abs().max() <= 2.0 ** -6 * b.abs().max()


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel against plain version, same inputs: |got - want| <= atol + rtol |want| (chip_smoke.py's TOL), and in
# bf16 also <= BF16_REL x the plain version's largest |value| of that tensor (chip_smoke.py's ATTENTION_BF16_REL)
CARD_TOL = {("fwd", torch.float32): (2e-5, 0.0), ("fwd", torch.bfloat16): (1e-2, 2.0 ** -8),
            ("bwd", torch.float32): (1e-4, 1e-5), ("bwd", torch.bfloat16): (2e-2, 2.0 ** -7)}
BF16_REL = 2e-2
# (B, H, Sq, Sk, Dh): fusion buckets (Dh 96, 50); slice packing with B*H not a multiple of the slices a block
# takes (Sq 8: 4 a block, 17: 2, 33: 1); Sq != Sk; text and wav2vec2 fine-tuning
CARD_CASES = [(32, 8, 33, 33, 96), (32, 8, 8, 8, 50), (32, 8, 24, 33, 96), (3, 5, 8, 8, 64), (3, 3, 17, 17, 96),
              (5, 3, 33, 33, 50), (2, 3, 17, 300, 64), (2, 2, 100, 33, 50), (16, 12, 256, 256, 64),
              (16, 12, 499, 499, 64)]


def _excess(got, want, key, dtype) -> float:
    """Largest excess over the limits (<= 0 passes)."""
    err, want = (got.float() - want.float()).abs(), want.float()
    atol, rtol = CARD_TOL[key, dtype]
    excess = (err - atol - rtol * want.abs()).max().item()
    if dtype == torch.bfloat16:
        excess = max(excess, (err.max() - BF16_REL * want.abs().max()).item())
    return excess


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind, rate", [("clips", 0.0), ("fully_masked", 0.1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_k1_k2_match_plain_versions(case, dtype, mask_kind, rate, cuda):
    q, k, v, g, mask = _t(*_inputs(*case, seed=6, mask_kind=mask_kind), device=cuda, dtype=dtype)
    seed = (0xFACE, 21) if rate else None
    g_lse = torch.randn(case[:3], device=cuda)
    launches = (fa.flash_attention_forward.launches, fa.flash_attention_backward.launches,
                fa.flash_attention_tiled_backward.launches)
    out, lse = fa.flash_attention_forward(q, k, v, mask, seed, rate)
    grads = fa.flash_attention_backward(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    ref = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    assert out.dtype == dtype and _excess(out, ref_out, "fwd", dtype) <= 0
    assert (lse - ref_lse).abs().max().item() <= (2e-5 if dtype == torch.float32 else 1e-3)
    for got, want in zip(grads, ref):
        assert got.dtype == dtype and _excess(got, want, "bwd", dtype) <= 0
    fused = case[3] <= fa.BWD_FUSED_MAX  # above it the backward's dispatch takes K4
    assert (fa.flash_attention_forward.launches, fa.flash_attention_backward.launches,
            fa.flash_attention_tiled_backward.launches) == (launches[0] + 1, launches[1] + fused,
                                                            launches[2] + 1 - fused)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 8, 8), (3, 3, 17, 17), (2, 2, 33, 40), (1, 2, 70, 128)])
def test_k1_k2_dropout_masks_equal_plain_mask_exactly(shape, dtype, cuda):
    """v = I makes out[i, j] = P_ij D_ij, g = I makes dv[j, i] = P_ij D_ij:
    the packed and unpacked kernels' masks read off exactly."""
    b, h, sq, sk = shape
    seed, rate = (4321, 8765), 0.4
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, cuda) > 0
    eye = lambda n: torch.eye(n, device=cuda, dtype=dtype).expand(b, h, n, n).contiguous()
    randn = lambda *s: torch.randn(*s, device=cuda).to(dtype)
    out, _ = fa.flash_attention_forward(randn(b, h, sq, sk), randn(b, h, sk, sk), eye(sk), None, seed, rate)
    assert torch.equal(out > 0, want)
    q, k, v = randn(b, h, sq, sq), randn(b, h, sk, sq), randn(b, h, sk, sq)
    out, lse = fa.flash_attention_forward(q, k, v, None, seed, rate)
    _, _, dv = fa.flash_attention_backward(q, k, v, None, out, lse, eye(sq), seed, rate)
    assert torch.equal(dv.transpose(2, 3) > 0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3, 3, 17, 17, 96), (16, 12, 256, 256, 64)])
def test_k2_f32_reproduces_bitwise(case, cuda):
    q, k, v, g, mask = _t(*_inputs(*case, seed=7), device=cuda)
    out, lse = fa.flash_attention_forward(q, k, v, mask, (5, 6), 0.1)
    first = fa.flash_attention_backward(q, k, v, mask, out, lse, g, (5, 6), 0.1)
    second = fa.flash_attention_backward(q, k, v, mask, out, lse, g, (5, 6), 0.1)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_bf16_limit_fails_on_rolled_key_tiles(cuda):
    """K1 handed V, and K2 handed K, whose keys past the first 64 are rolled
    by 64 (as a kernel that reads the wrong tile after its first) are off by
    far more than BF16_REL of the largest |value|."""
    q, k, v, g, mask = _t(*_inputs(2, 12, 499, 499, 64, seed=8), device=cuda, dtype=torch.bfloat16)
    wrong = lambda t: torch.cat([t[:, :, :64], t[:, :, 64:].roll(64, 2)], 2).contiguous()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, mask)
    pairs = [(fa.flash_attention_forward(q, k, wrong(v), mask)[0], ref_out)]
    ref = fa.flash_attention_backward_reference(q, k, v, mask, ref_out, ref_lse, g)
    pairs += zip(fa.flash_attention_backward(q, wrong(k), v, mask, ref_out, ref_lse, g), ref)
    for got, want in pairs:
        assert (got.float() - want.float()).abs().max() > 4 * BF16_REL * want.float().abs().max()


def test_bench_crossover_rows_time_both_kernels_on_cpu():
    """The crossover rows name both kernels of a threshold and time each on
    the same inputs (host clock on the CPU, the plain versions); the forward
    sweep reaches its threshold, the backward one K2's kernel range on
    either side of its threshold, and both the fusion buckets up to 33 rows."""
    from mer_tpu_torch.scripts import bench_attention

    assert max(s for _, _, s, _ in bench_attention.CROSSOVER_FORWARD) == fa.STREAM_THRESHOLD
    backward = {s for _, _, s, _ in bench_attention.CROSSOVER_BACKWARD}
    assert max(backward) == fa.FUSED_KERNEL_MAX and fa.BWD_FUSED_MAX in backward
    assert {48, 64, 128, 256, 499} <= backward
    assert {s for _, _, s, _ in bench_attention.FUSION_ROWS} == {8, 16, 24, 33}
    for direction, names in (("forward", ("K1", "K3")), ("backward", ("K2", "K4"))):
        row = bench_attention.crossover_row(direction, 1, 2, 40, 64, 0.1, torch.device("cpu"))
        assert row["kernels"] == " | ".join(names) and row["clock"] == "host (cpu)"
        assert all(row[f"{n}_ms"] > 0 for n in names) and row["faster"] in names
    assert fa.flash_attention_forward.launches == fa.flash_attention_stream.launches == 0
