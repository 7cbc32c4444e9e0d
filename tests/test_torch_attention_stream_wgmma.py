"""K3's Hopper design (bf16, head dim 64), restated on the CPU; the kernel
against its plain version on a card.

The design (``csrc/flash_attention_hopper.cuh``, which K1 launches too; its
own tests: ``tests/test_torch_attention_k1_wgmma.py``) takes each tile's key
biases in log2 units (0, -1e30 log2 e on an ignored key, -inf past Sk, keys
padded to 64; the producer warp makes them from the mask's bytes), walks
64-key tiles with an online softmax in log2 units (exp2
of scale log2 e q.k + bias - m, a running max and a row sum of the undropped
probabilities), multiplies each tile's P o D, rounded to v's dtype, by V, and
writes out = O / l and lse = m ln 2 + ln l (a fully masked row: -1e30 + ln l,
in natural units as the plain version rounds it). Dropout draws the keep bit
of every score in the wgmma accumulator layout: lane (g, t) of warp w holds
rows 16 w + g and + 8 of its warpgroup's 64, columns 8 j + 2 t and + 1;
``mer_philox::keep_bits`` gives lanes l and l ^ 4 one Philox call each per
2 x 2 block and swaps one row's bits.

On the CPU: that algorithm restated (float64 and float32) against
``flash_attention_stream_reference`` and against ``mer_tpu``'s streaming
kernel in interpret mode, with a key mask, a fully masked batch element,
keys past a ragged Sk, Sq != Sk and dropout; the warpgroup's Philox draw
restated lane by lane (every 2 x 2 block drawn once, every score's bits the
plain draw's). On the card (``cuda`` marker), the kernel against its plain
version, its mask read off exactly in 64-key windows, the same bits from two
calls and the bf16 limit failing on rolled key tiles::

    python -m pytest --noconftest -m cuda tests/test_torch_attention_stream_wgmma.py
"""

import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa

TILE = 64
LOG2E = 1.4426950408889634
SEED = (0x1234ABCD, 0x0BADF00D)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, sq, sk, dh=64, seed=0, fully_masked=False):
    """Unit-variance q, k, v over 3 (the main path's scale) and clip masks: element b keeps its first L_b >= Sk / 2
    keys less a scattered 10%, key 0 always, or with ``fully_masked`` element 0 ignores every key."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, dh)) / math.sqrt(3)
    k, v = (rng.normal(size=(b, h, sk, dh)) / math.sqrt(3) for _ in range(2))
    lengths = rng.integers(sk // 2, sk + 1, b)
    mask = (np.arange(sk)[None, :] >= lengths[:, None]) | (rng.random((b, sk)) < 0.1)
    mask[:, 0] = False
    if fully_masked:
        mask[0] = True
    return q, k, v, mask


def _key_biases(mask: np.ndarray) -> torch.Tensor:
    """The key biases of every tile: [B, Sk padded to 64] f32 in log2 units."""
    b, sk = mask.shape
    pad = -(-sk // TILE) * TILE
    bias = torch.full((b, pad), float("-inf"), dtype=torch.float32)
    bias[:, :sk] = torch.where(torch.from_numpy(mask), torch.tensor(fa.NEG_INF, dtype=torch.float32) * LOG2E, 0.0)
    return bias


def _k3_restated(q, k, v, mask, seed=None, rate=0.0, acc=torch.float32):
    """K3's Hopper algorithm tile by tile: q, k, v tensors in their dtype (P o D is rounded to it), ``acc`` the
    arithmetic's dtype. Returns (out in q's dtype, lse in ``acc``)."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    bias = _key_biases(mask.numpy()).to(acc)
    c_log2 = LOG2E / math.sqrt(dh)
    m = torch.full((b, h, sq, 1), float("-inf"), dtype=acc)
    l = torch.zeros((b, h, sq, 1), dtype=acc)
    o = torch.zeros((b, h, sq, dh), dtype=acc)
    kp, vp = (torch.nn.functional.pad(t.to(acc), (0, 0, 0, bias.shape[1] - sk)) for t in (k, v))  # TMA's zero fill
    for k0 in range(0, sk, TILE):
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kp[:, :, k0:k0 + TILE]) * c_log2 \
            + bias[:, None, None, k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if rate:
            n = min(TILE, sk - k0)
            factor = torch.zeros_like(p)
            factor[..., :n] = fa.dropout_factor(seed, (b, h, sq, n), rate, col0=k0).to(acc)
            p = p * factor
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), vp[:, :, k0:k0 + TILE])
        m = m_new
    l = l.clamp_min(1e-30)
    fully = m < 0.5 * fa.NEG_INF * LOG2E
    mask_bias = torch.tensor(fa.NEG_INF, dtype=torch.float32).to(acc)  # the kernel's -1e30f, as the plain version's
    lse = torch.where(fully, mask_bias + torch.log(l), m * math.log(2) + torch.log(l))
    return (o / l).to(q.dtype), lse[..., 0]


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# (B, H, Sq, Sk): a ragged last key tile, Sq != Sk both ways, one tile, a query tile past Sq
CASES = [(2, 2, 150, 301), (2, 1, 300, 130), (1, 2, 70, 64), (2, 1, 129, 200)]


@pytest.mark.parametrize("fully_masked, rate", [(False, 0.0), (True, 0.0), (False, 0.1)])
@pytest.mark.parametrize("case", CASES)
def test_restated_matches_plain_version_f64(case, fully_masked, rate):
    """In float64 the two algebras agree to rounding: out 1e-12, lse 1e-9 (its values run to 1e30 where masked)."""
    q, k, v, mask = _inputs(*case, seed=sum(case), fully_masked=fully_masked)
    q, k, v = _t(q, k, v, dtype=torch.float64)
    seed = SEED if rate else None
    out, lse = _k3_restated(q, k, v, torch.from_numpy(mask), seed, rate, acc=torch.float64)
    want_out, want_lse = fa.flash_attention_stream_reference(q, k, v, torch.from_numpy(mask), seed, rate)
    torch.testing.assert_close(out, want_out, atol=1e-12, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-9, rtol=1e-12)


def test_fully_masked_row_is_the_mean_of_v_and_padding_keys_weigh_nothing():
    q, k, v, mask = _inputs(2, 2, 70, 100, seed=4, fully_masked=True)
    q, k, v = _t(q, k, v)
    out, lse = _k3_restated(q, k, v, torch.from_numpy(mask))
    torch.testing.assert_close(out[0], v[0].mean(1, keepdim=True).expand_as(out[0]), atol=1e-6, rtol=0)
    assert torch.all(lse[0] == torch.tensor(fa.NEG_INF, dtype=torch.float32))
    assert torch.all(lse[1] > fa.FULLY_MASKED_LSE)
    # keys 100..127 of the padded tile are -inf: the last 36 keys' worth of zeros change nothing
    bias = _key_biases(mask)
    assert torch.isinf(bias[:, 100:]).all() and (bias[:, 100:] < 0).all() and torch.isfinite(bias[:, :100]).all()


def test_bf16_restated_within_the_card_limits_of_the_plain_version():
    """With P o D rounded to bf16 in both, the restatement lies within chip_smoke.py's bf16 limits of the plain
    version: out (1e-2, 2^-8) and 2e-2 of its largest |value|, lse 1e-3."""
    q, k, v, mask = _inputs(2, 2, 200, 333, seed=7)
    q, k, v = _t(q, k, v, dtype=torch.bfloat16)
    for seed, rate in ((None, 0.0), (SEED, 0.1)):
        out, lse = _k3_restated(q, k, v, torch.from_numpy(mask), seed, rate)
        want_out, want_lse = fa.flash_attention_stream_reference(q, k, v, torch.from_numpy(mask), seed, rate)
        err = (out.float() - want_out.float()).abs()
        assert (err - 1e-2 - 2 ** -8 * want_out.float().abs()).max() <= 0
        assert err.max() <= 2e-2 * want_out.float().abs().max()
        assert (lse - want_lse).abs().max() <= 1e-3


@pytest.fixture(scope="module")
def jax_k3():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_impl

    def k3(q, k, v, mask):
        bias = jnp.where(jnp.asarray(mask), _NEG_INF, 0.0).astype(jnp.float32)
        out, lse = _flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, interpret=True,
                               force_stream=True, return_stats=True)
        return np.asarray(out), np.asarray(lse)

    return k3


@pytest.mark.parametrize("case", [(2, 2, 100, 600), (1, 2, 700, 600)])
def test_restated_matches_mer_tpu_stream_kernel_interpret(jax_k3, case):
    """f32, 600 keys: two of the TPU kernel's 512-key tiles, ten of the design's 64-key ones, the last ragged;
    Sq < Sk and Sq > Sk. (Not a fully masked row: the TPU kernel averages v over its padded 1,024 keys there, the
    port over the Sk keys, as its plain version and the single-pass kernel do.)"""
    q, k, v, mask = (a.astype(np.float32) if a.dtype == np.float64 else a for a in _inputs(*case, seed=11))
    want_out, want_lse = jax_k3(q, k, v, mask)
    out, lse = _k3_restated(*_t(q, k, v), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("q0", [0, 64])
def test_warpgroup_philox_draw_covers_each_block_once(q0):
    """``keep_bits`` restated lane by lane for the 64 x 64 tile of a block's warpgroup at query row q0: every lane
    of warp w draws the block (col >> 1, (row + 8 (row & 1)) >> 1) for its row row = 16 w + g, each 2 x 2 block of
    the tile is drawn exactly once, and the four bits a lane assembles (its own row of its block, the other row
    from lane ^ 4) are the plain draw's at (row + 8 h, col + c)."""
    rate, bh, k0 = 0.4, 5, 128
    threshold = fa.dropout_threshold(rate)
    drawn, covered = [], torch.zeros(TILE, TILE, dtype=torch.int64)
    for w in range(4):
        for j in range(8):
            lanes = {}
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                row, col = q0 + 16 * w + g, k0 + 8 * j + 2 * t
                parity = row & 1
                pair = (row + 8 * parity) >> 1
                words = [int(x) for x in fa.philox4x32((col >> 1, pair, bh, 0), SEED)]
                keep = [int(x >= threshold) for x in words]
                row0, row1 = keep[0] | keep[1] << 1, keep[2] | keep[3] << 1  # the block's rows 2 pair, 2 pair + 1
                lanes[lane] = (row, col, parity, row0, row1)
                drawn.append((col >> 1, pair))
            for lane, (row, col, parity, row0, row1) in lanes.items():
                mine = row1 if parity else row0
                other = lanes[lane ^ 4]
                got = other[3] if other[2] else other[4]  # what lane ^ 4 sends: its row of the other parity
                bits = got | mine << 2 if parity else mine | got << 2
                for h in range(2):
                    for c in range(2):
                        want = int(fa.philox_bits(SEED, bh, row + 8 * h, col + c)) >= threshold
                        assert (bits >> (2 * h + c)) & 1 == want
                        covered[row + 8 * h - q0, col + c - k0] += 1
    assert torch.equal(covered, torch.ones_like(covered))
    blocks = {(c, r) for c in range(k0 // 2, (k0 + TILE) // 2) for r in range(q0 // 2, q0 // 2 + 32)}
    assert sorted(drawn) == sorted(blocks)


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel K3 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(case, dtype, device, seed, fully_masked=False, dh=64):
    q, k, v, mask = _inputs(*case, dh=dh, seed=seed, fully_masked=fully_masked)
    return [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)] + [torch.from_numpy(mask).to(device)]


def _excess(got, want, q, k, v, mask, seed=None, rate=0.0) -> float:
    """bf16 out: the rounding bound (``parallel_check.sum_bound`` of the plain version plus one ulp of the larger
    value, element by element) and 2e-2 of the plain version's largest |value| (chip_smoke.py's limits)."""
    from mer_tpu_torch.scripts.parallel_check import bf16_out_excess, sum_bound

    sums = sum_bound(fa.flash_attention_stream_reference, q, k, v, mask, seed, rate)
    return max(bf16_out_excess(got, want, sums),
               ((got.float() - want.float()).abs().max() - 2e-2 * want.float().abs().max()).item())


@pytest.mark.cuda
@pytest.mark.parametrize("fully_masked, rate", [(False, 0.0), (True, 0.0), (False, 0.1)])
@pytest.mark.parametrize("case", [(2, 12, 4499, 4499), (2, 12, 2999, 2999), (2, 2, 300, 1000), (2, 2, 1000, 300),
                                  (2, 3, 65, 33), (1, 1, 64, 64)])
def test_k3_matches_plain_version(case, fully_masked, rate, cuda):
    q, k, v, mask = _card(case, torch.bfloat16, cuda, 3, fully_masked)
    seed = (0xF00D, 8) if rate else None
    before = fa.flash_attention_stream.launches
    out, lse = fa.flash_attention_stream(q, k, v, mask, seed, rate)
    torch.cuda.synchronize()
    assert fa.flash_attention_stream.launches == before + 1
    want_out, want_lse = fa.flash_attention_stream_reference(q, k, v, mask, seed, rate)
    assert torch.isfinite(out.float()).all() and _excess(out, want_out, q, k, v, mask, seed, rate) <= 0
    assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, dh", [(torch.float32, 50), (torch.bfloat16, 50)])
def test_k3_older_template_still_holds(dtype, dh, cuda):
    """Head dims other than 64 stay on the forward template K1 shares, in f32 and bf16 (f32 at 64 runs the
    3xTF32 forward: tests/test_torch_attention_tf32.py)."""
    q, k, v, mask = _card((2, 2, 700, 4100), dtype, cuda, 4, dh=dh)
    out, lse = fa.flash_attention_stream(q, k, v, mask)
    want_out, want_lse = fa.flash_attention_stream_reference(q, k, v, mask)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, atol=2e-5, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    else:
        assert _excess(out, want_out, q, k, v, mask) <= 0 and (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 130, 100), (1, 3, 64, 263), (2, 1, 200, 64)])
def test_k3_dropout_mask_read_off_exactly(shape, cuda):
    """With v one-hot on a window of 64 keys, v[j, j - j0] = 1, out[i, j - j0] = P_ij D_ij / l_i: the mask of
    every window, exactly."""
    b, h, sq, sk = shape
    rate, seed = 0.1, (0xC0FFEE, sq * 1000 + sk)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(sk)
    q, k = (torch.randn(b, h, n, 64, device=cuda, generator=gen).to(torch.bfloat16) for n in (sq, sk))
    got = torch.zeros_like(want)
    for j0 in range(0, sk, 64):
        n = min(64, sk - j0)
        v = torch.zeros(b, h, sk, 64, device=cuda, dtype=torch.bfloat16)
        v[:, :, j0:j0 + n, :n] = torch.eye(n, device=cuda, dtype=torch.bfloat16)
        got[..., j0:j0 + n] = fa.flash_attention_stream(q, k, v, None, seed, rate)[0][..., :n] > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k3_reproduces_bitwise(rate, cuda):
    q, k, v, mask = _card((2, 4, 1000, 2049), torch.bfloat16, cuda, 4)
    seed = (3, 4) if rate else None
    first, second = (fa.flash_attention_stream(q, k, v, mask, seed, rate) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_bf16_limit_fails_on_rolled_key_tiles(cuda):
    """K3 handed V whose keys past the first 64 are rolled by 64 (a kernel reading the wrong tile after its first)
    exceeds the 2e-2 limit by far."""
    q, k, v, mask = _card((2, 2, 2000, 2000), torch.bfloat16, cuda, 5)
    want = fa.flash_attention_stream_reference(q, k, v, mask)[0].float()
    wrong = torch.cat([v[:, :, :64], v[:, :, 64:].roll(64, 2)], 2).contiguous()
    got = fa.flash_attention_stream(q, k, wrong, mask)[0].float()
    assert (got - want).abs().max() > 4 * 2e-2 * want.abs().max()
