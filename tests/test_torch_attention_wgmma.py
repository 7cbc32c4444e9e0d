"""The dropout draw shared by every attention kernel, and K4's Hopper design.

Every attention kernel (K1-K4) and every plain version draws the keep bit of
score (row, col) of head bh as word 2 (row & 1) + (col & 1) of one
Philox4x32-10 call at counter (col >> 1, row >> 1, bh, 0): one call per 2 x 2
block of scores (``csrc/philox.cuh``). On the CPU: the plain draw against
those words of ``philox4x32`` (whose known answers
``tests/test_torch_attention_bwd.py`` checks), tiles at odd offsets against
the whole mask, the keep rate at rates 0.1 and 0.4 and in each of a block's
four places within binomial bounds, the backward's dispatch at
``BWD_FUSED_MAX`` and K4's scratch. On the card (``cuda`` marker) the new K4
(bf16, Dh 64: ``wgmma``, TMA, a producer warp; the older design for f32 and
other head dims) against its plain version, its masks read off exactly, its
results bit for bit from run to run, the 2e-2 limit failing on rolled key
tiles, and the K2 | K4 seam:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_wgmma.py
"""

import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa

SEED = (0x1234ABCD, 0x0BADF00D)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def block_mask():
    """The keep mask of a [2, 3, 257, 263] block at rates 0.1 and 0.4."""
    return {rate: fa.dropout_factor(SEED, (2, 3, 257, 263), rate) > 0 for rate in (0.1, 0.4)}


# -- the draw ------------------------------------------------------------------------------


def test_draw_is_the_philox_word_of_the_2x2_block():
    rng = np.random.default_rng(0)
    bh, row, col = (torch.from_numpy(rng.integers(0, n, 500)) for n in (48, 5000, 5000))
    words = fa.philox4x32((col >> 1, row >> 1, bh, torch.zeros_like(bh)), SEED)
    want = torch.stack(words, -1).gather(-1, (2 * (row & 1) + (col & 1))[:, None])[:, 0]
    assert torch.equal(fa.philox_bits(SEED, bh, row, col), want)
    # the four scores of a block read the four words of one call
    r0, c0 = 2 * (row >> 1), 2 * (col >> 1)
    block = [fa.philox_bits(SEED, bh, r0 + dr, c0 + dc) for dr in (0, 1) for dc in (0, 1)]
    assert all(torch.equal(a, b) for a, b in zip(block, words))


@pytest.mark.parametrize("row0, col0, rows, cols", [(1, 3, 6, 7), (7, 0, 9, 4), (0, 5, 1, 1), (255, 261, 2, 2),
                                                    (64, 127, 64, 64)])
def test_tiles_at_odd_offsets_read_the_whole_mask(block_mask, row0, col0, rows, cols):
    whole = fa.dropout_factor(SEED, (2, 3, 257, 263), 0.4)
    tile = fa.dropout_factor(SEED, (2, 3, rows, cols), 0.4, row0=row0, col0=col0)
    assert torch.equal(tile, whole[:, :, row0:row0 + rows, col0:col0 + cols])
    assert torch.equal(whole > 0, block_mask[0.4])
    bits = fa.philox_bits(SEED, torch.arange(6).view(2, 3, 1, 1), torch.arange(row0, row0 + rows).view(-1, 1),
                          torch.arange(col0, col0 + cols))
    assert torch.equal(tile > 0, bits >= fa.dropout_threshold(0.4))


@pytest.mark.parametrize("rate", [0.1, 0.4])
def test_keep_rate_within_binomial_bounds(block_mask, rate):
    """Over the block (405,546 scores) the keep rate lies within 5 binomial
    standard deviations of 1 - rate (a false alarm about once in 1.7e6 runs),
    and so does it at each of a 2 x 2 block's four places (each reads its own
    word of the call, about 101,000 scores each)."""
    keep = block_mask[rate]
    places = [keep[:, :, r::2, c::2] for r in (0, 1) for c in (0, 1)]
    for part in [keep] + places:
        n = part.numel()
        sigma = math.sqrt(rate * (1 - rate) / n)
        assert abs(part.float().mean().item() - (1 - rate)) <= 5 * sigma, (n, part.float().mean().item())
    # the four places are not one word read four times
    assert not torch.equal(places[0], places[3])


# -- the dispatch and K4's scratch on the CPU ---------------------------------------------------------------


def test_backward_dispatch_switches_above_the_dialogue_buckets(monkeypatch):
    """K2 (its plain version here) up to BWD_FUSED_MAX = 33 keys, K4 above."""
    calls = []
    for name in ("flash_attention_backward_reference", "flash_attention_tiled_backward_reference"):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    rng = np.random.default_rng(1)
    for sk in (fa.BWD_FUSED_MAX, fa.BWD_FUSED_MAX + 1):
        q, g = (torch.from_numpy(rng.normal(size=(1, 2, 5, 8))) for _ in range(2))
        k, v = (torch.from_numpy(rng.normal(size=(1, 2, sk, 8))) for _ in range(2))
        out, lse = fa.flash_attention_forward(q, k, v)
        fa.flash_attention_backward(q, k, v, None, out, lse, g)
    assert calls == ["flash_attention_backward_reference", "flash_attention_tiled_backward_reference"]
    assert fa.flash_attention_backward.launches == fa.flash_attention_tiled_backward.launches == 0


def test_tiled_scratch_holds_stats_bias_and_keep_bits():
    """Per query row lse, delta and the fully-masked P, per key its bias (rows
    padded to 64), and with dropout one bit a score of the padded tiles; the
    older design's delta [B, H, Sq] fits in its head."""
    assert fa.tiled_scratch_numel(2, 12, 4499, 4499, False) == 3 * 24 * 4544 + 2 * 4544
    assert fa.tiled_scratch_numel(2, 12, 4499, 4499, True) == 3 * 24 * 4544 + 2 * 4544 + 24 * 4544 * 4544 // 32
    assert fa.tiled_scratch_numel(1, 1, 1, 65, True) == 3 * 64 + 128 + 64 * 128 // 32
    assert all(fa.tiled_scratch_numel(b, h, sq, sk, False) >= b * h * sq
               for b, h, sq, sk in [(1, 1, 1, 1), (3, 5, 64, 7), (2, 12, 4499, 2999)])


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K4 against its plain version, same inputs: f32 |got - want| <= 1e-4 + 1e-5 |want| (chip_smoke.py's TOL); bf16 within
# 2e-2 of the plain version's largest |value| (chip_smoke.py's ATTENTION_BF16_REL: both sides round to bf16 last)
CARD_TOL, CARD_BF16_REL = (1e-4, 1e-5), 2e-2
# (B, H, Sq, Sk, Dh): the 90 s and 60 s buckets of the long-clip path, Sq != Sk both ways, head dims 50 and 128 (the
# older design) beside 64; B = 2: batch element 0 may ignore every key
CARD_CASES = [(2, 12, 4499, 4499, 64), (2, 12, 2999, 2999, 64), (2, 2, 300, 1000, 64), (2, 2, 1000, 300, 64),
              (2, 2, 513, 700, 50), (2, 2, 513, 700, 128), (2, 3, 65, 33, 64)]


def _card_inputs(case, dtype, device, seed, fully_masked=False):
    """Clip masks (element b keeps its first L_b >= Sk / 2 keys less a scattered 10%, key 0 always), or with
    ``fully_masked`` element 0 ignoring every key; q, k, v, g at the main path's scale (variance 1/3)."""
    b, h, sq, sk, dh = case
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, h, sq, dh)) for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, dh)) for _ in range(2))
    lengths = rng.integers(sk // 2, sk + 1, b)
    mask = (np.arange(sk)[None, :] >= lengths[:, None]) | (rng.random((b, sk)) < 0.1)
    mask[:, 0] = False
    if fully_masked:
        mask[0] = True
    to = lambda a: torch.from_numpy(a / math.sqrt(3)).to(device, dtype)
    return to(q), to(k), to(v), to(g), torch.from_numpy(mask).to(device)


def _excess(got, want, dtype) -> float:
    err, want = (got.float() - want.float()).abs(), want.float()
    if dtype == torch.bfloat16:
        return (err.max() - CARD_BF16_REL * want.abs().max()).item()
    return (err - CARD_TOL[0] - CARD_TOL[1] * want.abs()).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fully_masked, rate", [(False, 0.0), (True, 0.1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CARD_CASES)
def test_k4_matches_plain_version(case, dtype, fully_masked, rate, cuda):
    q, k, v, g, mask = _card_inputs(case, dtype, cuda, 3, fully_masked)
    seed = (0xF00D, 8) if rate else None
    g_lse = torch.randn(case[:3], device=cuda)
    out, lse = fa.flash_attention_stream(q, k, v, mask, seed, rate)
    before = fa.flash_attention_tiled_backward.launches
    grads = fa.flash_attention_tiled_backward(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    torch.cuda.synchronize()
    ref = fa.flash_attention_tiled_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    for got, want in zip(grads, ref):
        assert got.dtype == dtype and torch.isfinite(got).all() and _excess(got, want, dtype) <= 0
    assert fa.flash_attention_tiled_backward.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 2, 130, 100), (1, 3, 64, 263), (2, 1, 200, 64)])
def test_k4_dropout_mask_read_off_exactly(shape, dtype, cuda):
    """Head dim 64 (the Hopper design in bf16); with g one-hot on a window of
    64 query rows, dv[j, i - i0] = P_ij D_ij: the mask of every window."""
    b, h, sq, sk = shape
    rate, seed = 0.1, (0xC0FFEE, sq * 1000 + sk)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(sk)
    q, k, v = (torch.randn(b, h, n, 64, device=cuda, generator=gen).to(dtype) for n in (sq, sk, sk))
    out, lse = fa.flash_attention_stream(q, k, v, None, seed, rate)
    got = torch.zeros_like(want)
    for i0 in range(0, sq, 64):
        n = min(64, sq - i0)
        g = torch.zeros(b, h, sq, 64, device=cuda, dtype=dtype)
        g[:, :, i0:i0 + n, :n] = torch.eye(n, device=cuda, dtype=dtype)
        dv = fa.flash_attention_tiled_backward(q, k, v, None, out, lse, g, seed, rate)[2]
        got[:, :, i0:i0 + n] = dv[..., :n].transpose(2, 3) > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_reproduces_bitwise(dtype, cuda):
    q, k, v, g, mask = _card_inputs((2, 4, 1000, 2049, 64), dtype, cuda, 4)
    out, lse = fa.flash_attention_stream(q, k, v, mask, (3, 4), 0.1)
    first = fa.flash_attention_tiled_backward(q, k, v, mask, out, lse, g, (3, 4), 0.1)
    second = fa.flash_attention_tiled_backward(q, k, v, mask, out, lse, g, (3, 4), 0.1)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_bf16_limit_fails_on_rolled_key_tiles(cuda):
    """K4 handed K whose keys past the first 64 are rolled by 64 (a kernel
    reading the wrong tile after its first) exceeds the limit by far."""
    q, k, v, g, mask = _card_inputs((2, 2, 2000, 2000, 64), torch.bfloat16, cuda, 5)
    out, lse = fa.flash_attention_stream_reference(q, k, v, mask)
    ref = fa.flash_attention_tiled_backward_reference(q, k, v, mask, out, lse, g)
    wrong = torch.cat([k[:, :, :64], k[:, :, 64:].roll(64, 2)], 2).contiguous()
    for got, want in zip(fa.flash_attention_tiled_backward(q, wrong, v, mask, out, lse, g), ref):
        assert (got.float() - want.float()).abs().max() > 4 * CARD_BF16_REL * want.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_k4_seam_at_the_threshold(dtype, cuda):
    """K2 and K4 on the same inputs at BWD_FUSED_MAX keys agree within the
    kernel-vs-plain limits; one key more and the dispatch takes K4."""
    for sk in (fa.BWD_FUSED_MAX, fa.BWD_FUSED_MAX + 1):
        q, k, v, g, mask = _card_inputs((4, 12, fa.BWD_FUSED_MAX, sk, 64), dtype, cuda, 6)
        out, lse = fa.flash_attention_forward(q, k, v, mask)
        launches = fa.flash_attention_backward.launches, fa.flash_attention_tiled_backward.launches
        dispatched = fa.flash_attention_backward(q, k, v, mask, out, lse, g)
        fused = sk <= fa.BWD_FUSED_MAX
        assert (fa.flash_attention_backward.launches, fa.flash_attention_tiled_backward.launches) == (
            launches[0] + fused, launches[1] + 1 - fused)
        other = (fa.flash_attention_tiled_backward if fused else fa.flash_attention_fused_backward)(
            q, k, v, mask, out, lse, g)
        for a, b in zip(dispatched, other):
            assert _excess(a, b, dtype) <= 0
