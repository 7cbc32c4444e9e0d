"""K2's one-pass stacked backward, restated on the CPU; the kernel against its
plain version on a card.

The design (``csrc/flash_attention_bwd_stacked.cuh``, which K2's C entry
launches in bf16 and f32 at Sq, Sk <= 64 and head dims 50, 64 and 96 with
16-byte aligned tensors) stacks n = 64 / max(Sq, Sk) consecutive (b*h)
slices in one 64-row tile: in the [B, H, S, Dh] layout they are consecutive
rows of the [B*H*S, Dh] view, which the bf16 design reads as TMA boxes of 64
rows (rows past the tile's slices are the next slices', zeros past the
tensor), or at head dim 50 by 4-byte loads into the same boxes (columns
50-63 and rows past the tile's real ones zero; the gradients' products are
m64n56k16). S = q K^T and dP = g V^T run over the whole tile; a score whose row
and key lie in different slices, or past the tile's real rows, gets P = 0
and dS = 0, so the block-diagonal stack's dQ = dS K, dK = scale dS^T q and
dV = (P o D)^T g are the slices' own, side by side. P uses the key biases in
log2 units (exp2 of scale log2 e s + bias - lse log2 e; 1/Sk on a fully
masked row), delta = rowsum(g o out) - g_lse is taken in the block, and in
bf16 P o D and dS are rounded before their products. Dropout draws one
Philox call per 2 x 2 scores at the drawing lane's block: rows r & ~1, r | 1
of the stack, located in their slice (its bh, its rows within it), so the
draw is the plain one when no block straddles two slices (even Sq and Sk, or
one slice a tile: the bf16 design's rule with dropout at an odd size).

On the CPU: that algorithm restated in float64, float32 and bf16 against
``flash_attention_backward_reference`` and in float32 against ``mer_tpu``'s
K2 (``_flash_bwd_fused``) in interpret mode, at S = 8, 16, 24 and 33 and 24 x
33, head dims 96, 64 and 50, B H not a multiple of n (a partial last tile), a
key mask, a fully masked element, an lse cotangent, dropout 0.4 drawn
slice-locally (the draw equal to ``dropout_factor``), ``_fused_route`` over
dtype, head dim, S and alignment, and CPU calls counting no route; and a
narrow mel-variant M2FNet (audio heads of 50, text and fusion heads of 96,
the shapes whose attention the mel variant's training runs through K1's and
K2's stacked designs) against ``mer_tpu``'s, forward and gradients. On the
card (``cuda`` marker): the stacked design against its plain version at
every K2 shape of the counted main paths (the mel variant's at head dim 50
too) and at [32, 8, 33, 33, 96] in both dtypes, the same bits from two
calls, its dropout mask read off exactly, the bf16 limit failing on rolled
key slices, the K2 | K4 seam at 33 / 34 keys, and
``flash_attention_backward.routes`` naming the design that ran::

    python -m pytest --noconftest -m cuda tests/test_torch_attention_k2_hopper.py
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mer_tpu_torch.ops import flash_attention as fa

TILE = 64
LOG2E = 1.4426950408889634
SEED = (0x1234ABCD, 0x0BADF00D)
RATE = 0.4  # the fusion model's dropout
BF16_REL = 2e-2  # chip_smoke.py's ATTENTION_BF16_REL
CARD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2.0 ** -7)}  # chip_smoke.py's bwd limits
SMS = 132  # the H100's SMs


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, sq, sk, dh, seed=0, mask_kind="dialogue"):
    """q, g [B, H, Sq, Dh], k, v [B, H, Sk, Dh] of variance 1/3 (the main path's projections) and a key mask:
    "dialogue" (element i keeps its first L_i keys, element 0 only key 0), "fully_masked" (element 0 ignores every
    key) or "none"."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, h, sq, dh)) / math.sqrt(3) for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, dh)) / math.sqrt(3) for _ in range(2))
    mask = None
    if mask_kind != "none":
        lengths = rng.integers(1, sk + 1, b)
        mask = np.arange(sk)[None, :] >= lengths[:, None]
        mask[0] = True
        mask[0, 0] = mask_kind == "fully_masked"
    return q, k, v, g, mask


def _case(b, h, sq, sk, dh, dtype, seed=0, mask_kind="dialogue", rate=0.0, g_lse=False):
    """Torch inputs in ``dtype`` with the plain forward's out and lse, the dropout seed and an lse cotangent."""
    q, k, v, g, mask = _inputs(b, h, sq, sk, dh, seed, mask_kind)
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    mask = None if mask is None else torch.from_numpy(mask)
    seed_words = SEED if rate else None
    out, lse = fa.flash_attention_reference(q, k, v, mask, seed_words, rate)
    cot = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(b, h, sq))).to(lse.dtype) if g_lse else None
    return q, k, v, mask, out, lse, g, seed_words, rate, cot


def _most(dtype, sq: int, sk: int, dropout: bool) -> int:
    """The most slices a tile may stack: as many as fit in 64 rows, one in bf16 with dropout at an odd Sq or Sk (a
    lane's 2 x 2 Philox block would straddle two slices)."""
    return 1 if dtype == torch.bfloat16 and dropout and (sq | sk) & 1 else TILE // max(sq, sk)


def _slices_per_tile(dtype, bh: int, sq: int, sk: int, dropout: bool, sms: int = SMS) -> int:
    """The stacked design's slices a tile (``slices_per_tile``, chosen on the card): in bf16 the fewest that keep
    the grid within one block an SM, at most ``_most``; in f32 one."""
    return min(-(-bh // sms), _most(dtype, sq, sk, dropout)) if dtype == torch.bfloat16 else 1


def _tile_factor(seed, rate, tile0, sq, sk, rslice, cslice):
    """D of a stacked 64 x 64 tile as the kernel draws it: score (r, c) takes word 2 (r & 1) + (c & 1) of the
    Philox block its drawing lane located from the block's first row r & ~1 (that row's slice: bh = tile0 + slice,
    rows counted within it) and first key c & ~1 (that key's slice)."""
    r, c = torch.arange(TILE), torch.arange(TILE)
    first_r, first_c = r & ~1, c & ~1
    slice_r = first_r // sq
    pair = (first_r - slice_r * sq) >> 1
    col = first_c - cslice[first_c].clamp(min=0) * sk
    w = fa.philox4x32(((col >> 1)[None, :], pair[:, None], (tile0 + slice_r)[:, None], 0), seed)
    bits = torch.where((r & 1).bool()[:, None], torch.where((c & 1).bool()[None, :], w[3], w[2]),
                       torch.where((c & 1).bool()[None, :], w[1], w[0]))
    return torch.where(bits >= fa.dropout_threshold(rate), 1.0 / (1.0 - rate), 0.0)


def _k2_restated(q, k, v, mask, out, lse, g, seed=None, rate=0.0, g_lse=None, spt=None, acc=torch.float32):
    """The stacked design tile by tile: q, k, v, g, out in their dtype (P o D and dS are rounded to it when it is
    not ``acc``), ``acc`` the arithmetic's dtype, ``spt`` the slices a tile (the design's choice by default).
    Returns (dq, dk, dv) in q's dtype."""
    b, h, sq, dh = q.shape
    sk, bh = k.shape[2], b * h
    spt = spt or _slices_per_tile(q.dtype, bh, sq, sk, rate > 0)
    view = lambda t, s: t.reshape(bh * s, dh).to(acc)
    q2, g2, out2, k2, v2 = view(q, sq), view(g, sq), view(out, sq), view(k, sk), view(v, sk)
    box = lambda t, row: F.pad(t[row:row + TILE], (0, 0, 0, TILE - t[row:row + TILE].shape[0]))  # TMA's zero fill
    lse2, glse2 = lse.reshape(-1).to(acc), None if g_lse is None else g_lse.reshape(-1).to(acc)
    scale = 1.0 / math.sqrt(dh)
    mask_bias2 = torch.tensor(fa.NEG_INF, dtype=torch.float32) * LOG2E  # the kernel's -1e30f log2 e in f32
    dq, dk, dv = torch.zeros_like(q2), torch.zeros_like(k2), torch.zeros_like(v2)
    idx = torch.arange(TILE)
    for tile0 in range(0, bh, spt):
        n = min(spt, bh - tile0)
        rq, rk = n * sq, n * sk
        qt, gt, kt, vt = box(q2, tile0 * sq), box(g2, tile0 * sq), box(k2, tile0 * sk), box(v2, tile0 * sk)
        s, dp = qt @ kt.T, gt @ vt.T
        rslice = torch.where(idx < rq, idx // sq, -2)
        cslice = torch.where(idx < rk, idx // sk, -1)
        rows = tile0 * sq + idx.clamp(max=rq - 1)
        masked = torch.zeros(TILE, dtype=torch.bool)
        if mask is not None:
            key = idx - cslice.clamp(min=0) * sk
            masked = (idx < rk) & mask[((tile0 + cslice.clamp(min=0)) // h).clamp(max=b - 1), key.clamp(max=sk - 1)]
        bias = torch.where(masked, mask_bias2, 0.0).to(acc)
        real = idx < rq
        lse_t = torch.where(real, lse2[rows], 0.0)
        delta = (gt[:, :dh] * box(out2, tile0 * sq)).sum(-1) - (0.0 if glse2 is None else glse2[rows])
        delta = torch.where(real, delta, 0.0)
        p = torch.exp2(s * (scale * LOG2E) + bias[None, :] - (lse_t * LOG2E)[:, None])
        p = torch.where((lse_t < fa.FULLY_MASKED_LSE)[:, None], 1.0 / sk, p)
        p = torch.where(rslice[:, None] == cslice[None, :], p, 0.0)
        d = _tile_factor(seed, rate, tile0, sq, sk, rslice, cslice).to(acc) if rate else torch.ones_like(p)
        pd, ds = p * d, p * (dp * d - delta[:, None])
        if q.dtype != acc:
            pd, ds = pd.to(q.dtype).to(acc), ds.to(q.dtype).to(acc)
        dq[tile0 * sq:tile0 * sq + rq] = (ds @ kt * scale)[:rq]
        dk[tile0 * sk:tile0 * sk + rk] = (ds.T @ qt * scale)[:rk]
        dv[tile0 * sk:tile0 * sk + rk] = (pd.T @ gt)[:rk]
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype))


# (B, H, Sq, Sk, Dh): the buckets 8, 16, 24 and 33 with B H not a multiple of the most slices a tile (15 of 8, 6 of
# 4, 9 of 3 at the odd 21), Sq != Sk (24 x 33), head dims 96 and 64, then the mel variant's head dim 50
CASES = [(3, 5, 8, 8, 96), (2, 3, 16, 16, 96), (2, 2, 24, 24, 64), (2, 2, 33, 33, 96), (3, 2, 24, 33, 96),
         (3, 3, 21, 21, 64), (2, 3, 16, 16, 50), (3, 3, 21, 21, 50), (3, 2, 24, 33, 50)]
VARIANTS = [("dialogue", 0.0, False), ("fully_masked", 0.0, True), ("dialogue", RATE, False),
            ("fully_masked", RATE, True)]
STACKS = ["one", "most"]  # one slice a tile, or the most a tile may stack (bf16's rule with dropout at odd sizes)


def _spt(stack: str, case, rate: float) -> int:
    """The slices a tile of a restated case: the bf16 design's draw at ``_most`` (every dtype's restatement draws as
    the bf16 design does; the f32 design draws each score's block at its own row and key, the plain draw)."""
    return 1 if stack == "one" else _most(torch.bfloat16, case[2], case[3], rate > 0)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("mask_kind, rate, g_lse", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_restated_matches_plain_version_f64(case, mask_kind, rate, g_lse, stack):
    """In float64 the stacked algebra is the plain version's to rounding (1e-12), dropout drawn slice-locally."""
    args = _case(*case, torch.float64, seed=sum(case), mask_kind=mask_kind, rate=rate, g_lse=g_lse)
    got = _k2_restated(*args, spt=_spt(stack, case, rate), acc=torch.float64)
    want = fa.flash_attention_backward_reference(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-12, rtol=0)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("mask_kind, rate, g_lse", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_restated_matches_plain_version_f32(case, mask_kind, rate, g_lse, stack):
    """The f32 arithmetic (f32 sums over the stacked tile, P in log2 units) within 1e-5 of the plain version: sums
    of at most 33 products of values under 1."""
    args = _case(*case, torch.float32, seed=sum(case) + 1, mask_kind=mask_kind, rate=rate, g_lse=g_lse)
    got = _k2_restated(*args, spt=_spt(stack, case, rate))
    want = fa.flash_attention_backward_reference(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("mask_kind, rate, g_lse", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_bf16_restated_within_the_card_limits_of_the_plain_version(case, mask_kind, rate, g_lse, stack):
    """bf16 inputs, f32 arithmetic, P o D and dS rounded to bf16: within the card legs' limits of the plain version
    (2e-2 + 2^-7 |value| element by element, and 2e-2 of the largest |value|)."""
    args = _case(*case, torch.bfloat16, seed=sum(case) + 2, mask_kind=mask_kind, rate=rate, g_lse=g_lse)
    got = _k2_restated(*args, spt=_spt(stack, case, rate))
    want = fa.flash_attention_backward_reference(*args)
    atol, rtol = CARD_TOL[torch.bfloat16]
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        assert ((a - w).abs() - atol - rtol * w.abs()).max() <= 0
        assert (a - w).abs().max() <= BF16_REL * w.abs().max()


@pytest.fixture(scope="module")
def jax_k2():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_bwd_fused, _flash_impl

    def k2(q, k, v, mask, g, g_lse=None):
        bias = jnp.where(jnp.asarray(mask), _NEG_INF, 0.0).astype(jnp.float32)
        q, k, v, g = (jnp.asarray(a) for a in (q, k, v, g))
        out, lse = _flash_impl(q, k, v, bias, interpret=True, return_stats=True)
        grads = _flash_bwd_fused(q, k, v, bias, out, lse, g, interpret=True,
                                 g_lse=None if g_lse is None else jnp.asarray(g_lse))
        return np.asarray(out), np.asarray(lse), [np.asarray(x) for x in grads]

    return k2


@pytest.mark.parametrize("g_lse", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_restated_matches_mer_tpu_k2_interpret(jax_k2, case, g_lse):
    """f32 against the TPU's fused backward K2 on its own forward's out and lse (no dropout: the TPU draws its own
    bits; no fully masked element: the TPU kernel pads the keys to 128 and averages over the padded count), within
    1e-5."""
    q, k, v, g, mask = (a.astype(np.float32) if a.dtype == np.float64 else a
                        for a in _inputs(*case, seed=11 + g_lse))
    cot = np.random.default_rng(5).normal(size=case[:3]).astype(np.float32) if g_lse else None
    out, lse, want = jax_k2(q, k, v, mask, g, cot)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    got = _k2_restated(t(q), t(k), t(v), t(mask), t(out), t(lse), t(g), g_lse=t(cot), spt=_spt("most", case, 0.0))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b, h, sq, sk", [(3, 5, 8, 8), (2, 3, 16, 16), (2, 2, 24, 24), (2, 2, 33, 33),
                                          (3, 2, 24, 33), (2, 3, 21, 21), (2, 2, 13, 20)])
def test_stacked_draw_is_the_plain_draw(b, h, sq, sk):
    """The tiles' draws at the most slices a tile, put together slice by slice, are ``dropout_factor``'s, bit for
    bit (rows and keys counted within each slice), odd sizes in bf16 at one slice a tile."""
    spt = _most(torch.bfloat16, sq, sk, True)
    want = fa.dropout_factor(SEED, (b, h, sq, sk), RATE).reshape(b * h, sq, sk)
    idx = torch.arange(TILE)
    for tile0 in range(0, b * h, spt):
        n = min(spt, b * h - tile0)
        rslice = torch.where(idx < n * sq, idx // sq, -2)
        cslice = torch.where(idx < n * sk, idx // sk, -1)
        d = _tile_factor(SEED, RATE, tile0, sq, sk, rslice, cslice)
        for s in range(n):
            assert torch.equal(d[s * sq:(s + 1) * sq, s * sk:(s + 1) * sk], want[tile0 + s])


def test_odd_sizes_stacked_two_a_tile_would_straddle():
    """Why bf16 with dropout takes one slice a tile at an odd size: two slices of 21 in one tile put slice 1 at row
    21, and the lanes' 2 x 2 blocks then pair rows of two slices, which draws another mask."""
    sq = sk = 21
    idx = torch.arange(TILE)
    rslice, cslice = torch.where(idx < 2 * sq, idx // sq, -2), torch.where(idx < 2 * sk, idx // sk, -1)
    d = _tile_factor(SEED, RATE, 0, sq, sk, rslice, cslice)
    want = fa.dropout_factor(SEED, (1, 2, sq, sk), RATE)[0, 1]
    assert not torch.equal(d[sq:2 * sq, sk:2 * sk], want)
    assert [_most(torch.bfloat16, 21, 21, drop) for drop in (True, False)] == [1, 3]
    assert _most(torch.float32, 21, 21, True) == 3


def test_slices_per_tile_at_the_buckets():
    """At most 8, 4, 2 and 1 slices a tile at the buckets 8, 16, 24 and 33 (1 at 24 x 33); the design's choice,
    one block an SM of the H100's 132: bf16 one slice at B H = 128, two at 256 (one at 33 keys), f32 one."""
    for drop in (False, True):
        assert [_most(torch.bfloat16, s, s, drop) for s in (8, 16, 24, 33)] == [8, 4, 2, 1]
        assert _most(torch.bfloat16, 24, 33, drop) == 1
        assert [_slices_per_tile(torch.bfloat16, 128, s, s, drop) for s in (8, 16, 24, 33)] == [1, 1, 1, 1]
        assert [_slices_per_tile(torch.bfloat16, 256, s, s, drop) for s in (8, 16, 24, 33)] == [2, 2, 2, 1]
        assert [_slices_per_tile(torch.float32, 256, s, s, drop) for s in (8, 16, 24, 33)] == [1, 1, 1, 1]
    assert _slices_per_tile(torch.bfloat16, 2048, 8, 8, False) == 8  # capped at what fits
    assert all(_most(torch.float32, sq, sk, False) * max(sq, sk) <= TILE for sq in range(1, 65) for sk in range(1, 65))


@pytest.mark.parametrize("dtype, sq, sk, dh, aligned, want", [
    (torch.bfloat16, 8, 8, 96, True, "stacked_bf16"), (torch.float32, 33, 33, 96, True, "stacked_f32"),
    (torch.bfloat16, 24, 33, 64, True, "stacked_bf16"), (torch.float32, 64, 64, 64, True, "stacked_f32"),
    (torch.bfloat16, 1, 1, 96, True, "stacked_bf16"), (torch.bfloat16, 65, 8, 96, True, "template"),
    (torch.float32, 8, 65, 96, True, "template"), (torch.bfloat16, 16, 16, 50, True, "stacked_bf16"),
    (torch.float32, 16, 16, 128, True, "template"), (torch.bfloat16, 16, 16, 96, False, "template"),
    (torch.float64, 16, 16, 96, True, "template"), (torch.float32, 33, 33, 50, True, "stacked_f32"),
    (torch.bfloat16, 16, 16, 50, False, "template"), (torch.bfloat16, 8, 65, 50, True, "template")])
def test_fused_route(dtype, sq, sk, dh, aligned, want):
    """The design K2's C entry takes, as the wrapper mirrors it: the stacked design in bf16 and f32 at Sq, Sk <= 64,
    head dims 50, 64 and 96 and aligned tensors, the template otherwise (other head dims, unaligned views, longer
    sequences)."""
    assert fa._fused_route(dtype, sq, sk, dh, aligned) == want
    assert fa.FUSED_ROUTES == ("template", "stacked_bf16", "stacked_f32")


def test_cpu_calls_count_no_route():
    """On the CPU the wrapper takes the plain version: no launch, no route."""
    args = _case(2, 2, 8, 8, 96, torch.float32)
    before = dict(fa.flash_attention_backward.routes), fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(*args)
    assert (dict(fa.flash_attention_backward.routes), fa.flash_attention_backward.launches) == before
    assert set(fa.flash_attention_backward.routes) == set(fa.FUSED_ROUTES)
    for a, w in zip(got, fa.flash_attention_backward_reference(*args)):
        assert torch.equal(a, w)


def test_crossover_k2_mel_shapes_are_the_mel_variants_k2_rows():
    """``bench_attention --crossover`` also times K2's designs at head dim 50, the mel variant's training calls (32
    dialogues, 6 audio heads, dropout 0.4) and the 33 bucket, all on the stacked design."""
    from mer_tpu_torch.scripts import bench_attention

    shapes = bench_attention.CROSSOVER_K2_MEL
    assert {s for _, _, s, _, _ in shapes} == {8, 16, 24, 33} and {h for _, h, *_ in shapes} == {6}
    assert all(fa._fused_route(bench_attention.DTYPES[dt], s, s, 50, True) == "stacked_bf16"
               for _, _, s, dt, _ in shapes)
    row = bench_attention.k2_design_row(2, 2, 8, "bfloat16", RATE, torch.device("cpu"), dh=50)
    assert row["Dh"] == 50 and row["kernels"] == "template | stacked" and row["template_ms"] > 0


def test_crossover_k2_shapes_are_the_counted_k2_rows():
    """``bench_attention --crossover`` times K2's designs at the 15 K2 shapes of the counted main paths (9 bf16,
    6 f32, all at head dim 96) and the 33 bucket in both dtypes."""
    from mer_tpu_torch.scripts import bench_attention

    shapes = bench_attention.CROSSOVER_K2
    assert len(shapes) == 17 and len(set(shapes)) == 17
    assert sum(dt == "bfloat16" for *_, dt, _ in shapes) == 10
    assert {s for _, _, s, _, _ in shapes} == {8, 16, 24, 33}
    assert (32, 8, 33, "bfloat16", 0.0) in shapes and (32, 8, 33, "float32", 0.0) in shapes


def test_bench_k2_design_rows_time_both_designs_on_cpu():
    """``bench_attention --crossover``'s K2 design rows: the template, the stacked design and SDPA's backward on
    the same inputs at the counted shapes (host clock on the CPU, where every design is the plain version)."""
    from mer_tpu_torch.scripts import bench_attention

    row = bench_attention.k2_design_row(2, 2, 8, "float32", 0.4, torch.device("cpu"))
    assert row["kernels"] == "template | stacked" and row["clock"] == "host (cpu)"
    assert all(row[key] > 0 for key in ("template_ms", "stacked_ms")) and math.isfinite(row["sdpa_backward_ms"])
    assert fa.flash_attention_backward.launches == 0


# the narrow mel variant: audio heads of 50 (K1's and K2's stacked designs at head dim 50 on the card), text and
# fusion heads of 96, two encoder layers a modality, two FAM layers; tests/test_torch_m2fnet.py's batch of 3 x 9
MEL_VARIANT = {
    "dropout": 0.4,
    "AUDIO": {"enabled": True, "embedding_size": 100, "n_head": 2, "n_transformers": 1, "n_encoder_layers": 2},
    "TEXT": {"enabled": True, "embedding_size": 96, "n_head": 1, "n_transformers": 1, "n_encoder_layers": 2},
    "FAM": {"enabled": True, "embedding_size": 96, "n_head": 1, "n_layers": 2},
    "CLASSIFIER": {"hidden_size": 32, "output_size": 7, "n_layers": 2},
}


def test_mel_variant_m2fnet_matches_mer_tpu_forward_and_gradients():
    """A narrow mel-variant M2FNet on ``mer_tpu``'s seeded weights: the port's eval logits, the gradients of a
    seeded linear loss of them with respect to every weight (carried through ``state_dict_from_jax``, a linear map)
    and to both embeddings, within tests/test_torch_m2fnet.py's 1e-4 of ``mer_tpu``'s (f32, CPU: the attention
    through its plain versions, the algebra the stacked designs run on the card)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from mer_tpu.core.config import Config as JaxConfig
    from mer_tpu.models import M2FNet as JaxM2FNet
    from mer_tpu_torch.core import Config
    from mer_tpu_torch.models import M2FNet, state_dict_from_jax

    b, u = 3, 9
    rng = np.random.default_rng(0)
    text = rng.normal(size=(b, u, 96)).astype(np.float32)
    audio = rng.normal(size=(b, u, 100)).astype(np.float32)
    mask = np.arange(u)[None, :] >= np.array([[u], [4], [0]])
    mask[2, 0] = False  # an all-padding dialogue keeps key 0 attendable
    cot = rng.normal(size=(b, u, 7)).astype(np.float32)

    jax_model = JaxM2FNet.from_config(JaxConfig(MEL_VARIANT))
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(text), jnp.asarray(audio), jnp.asarray(mask))["params"]

    def loss(params, text, audio):
        logits = jax_model.apply({"params": params}, text, audio, jnp.asarray(mask), deterministic=True)
        return jnp.sum(logits * cot), logits

    (_, want_logits), (g_params, g_text, g_audio) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(text), jnp.asarray(audio))
    port = M2FNet.from_config(Config(MEL_VARIANT))
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), Config(MEL_VARIANT)), strict=True)
    port.eval()
    t_text, t_audio = (torch.from_numpy(a).requires_grad_() for a in (text, audio))
    logits = port(t_text, t_audio, torch.from_numpy(mask))
    (logits * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_text.grad.numpy(), np.asarray(g_text), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_audio.grad.numpy(), np.asarray(g_audio), rtol=0, atol=1e-4)
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, g_params), Config(MEL_VARIANT))
    got_grads = {name: p.grad for name, p in port.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for name, grad in got_grads.items():
        np.testing.assert_allclose(grad.numpy(), want_grads[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


# -- on the card ------------------------------------------------------------------------------

# every K2 shape of chip_smoke.py's counted main paths ([B, H, S, S, 96]: the fusion model's training and
# evaluation batches at the buckets 8, 16, 24) and the 33 bucket, dropout 0 and the model's 0.4
CARD_SHAPES = [(16, 8, 8), (16, 8, 16), (32, 4, 8), (32, 4, 16), (32, 8, 8), (32, 8, 16), (32, 8, 24), (32, 8, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K2's stacked design has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(b, h, sq, sk, dh, dtype, device, seed, mask_kind="dialogue", rate=0.0):
    args = _case(b, h, sq, sk, dh, torch.float32, seed, mask_kind)
    q, k, v, mask, _, _, g = args[:7]
    q, k, v, g = (t.to(device, dtype) for t in (q, k, v, g))
    mask = None if mask is None else mask.to(device)
    seed_words = (0xF00D, seed) if rate else None
    out, lse = fa.flash_attention_forward(q, k, v, mask, seed_words, rate)
    return q, k, v, mask, out, lse, g, seed_words, rate


def _excess(got, want, dtype) -> float:
    """dq, dk, dv over chip_smoke.py's limits (<= 0 passes): TOL's bwd limits and, in bf16, BF16_REL of the plain
    version's largest |value|."""
    atol, rtol = CARD_TOL[dtype]
    worst = float("-inf")
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        worst = max(worst, ((a - w).abs() - atol - rtol * w.abs()).max().item())
        if dtype == torch.bfloat16:
            worst = max(worst, ((a - w).abs().max() - BF16_REL * w.abs().max()).item())
    return worst


def _routed(call, route):
    """call() and the assertion that it launched K2 once, through ``route``."""
    routes, launches = dict(fa.flash_attention_backward.routes), fa.flash_attention_backward.launches
    result = call()
    assert fa.flash_attention_backward.launches == launches + 1
    assert fa.flash_attention_backward.routes == {**routes, route: routes[route] + 1}
    return result


def _route(dtype) -> str:
    return "stacked_bf16" if dtype == torch.bfloat16 else "stacked_f32"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_stacked_matches_plain_version(shape, dtype, rate, cuda):
    for mask_kind in ("dialogue", "fully_masked"):
        args = _card(*shape, shape[2], 96, dtype, cuda, sum(shape), mask_kind, rate)
        got = _routed(lambda: fa.flash_attention_backward(*args), _route(dtype))
        torch.cuda.synchronize()
        assert all(torch.isfinite(t.float()).all() for t in got)
        assert _excess(got, fa.flash_attention_backward_reference(*args), dtype) <= 0


# the mel variant's K2 shapes ([B, H, S, S, 50]: 32 dialogues, 6 audio heads) at the buckets
MEL_CARD_SHAPES = [(32, 6, 8), (32, 6, 16), (32, 6, 24), (32, 6, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MEL_CARD_SHAPES)
def test_stacked_matches_plain_version_at_head_dim_50(shape, dtype, rate, cuda):
    """The mel variant's head dim 50: operands by 4-byte loads zero-filled to 64 columns, the gradients on
    m64n56k16 (bf16) or FMA over rows padded to 52 (f32), 50 columns stored."""
    for mask_kind in ("dialogue", "fully_masked"):
        args = _card(*shape, shape[2], 50, dtype, cuda, sum(shape), mask_kind, rate)
        got = _routed(lambda: fa.flash_attention_backward(*args), _route(dtype))
        torch.cuda.synchronize()
        assert all(torch.isfinite(t.float()).all() for t in got)
        assert _excess(got, fa.flash_attention_backward_reference(*args), dtype) <= 0
        assert all(torch.equal(a, b) for a, b in zip(got, fa.flash_attention_backward(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, h, s", [(32, 6, 8), (32, 6, 24), (4, 6, 33), (3, 5, 21)])
def test_stacked_dropout_mask_read_off_exactly_at_head_dim_50(b, h, s, dtype, cuda):
    """g one-hot, g[i, i] = 1 (head dim 50 >= S): dv[j, i] = P_ij D_ij, the mask of every slice, exactly."""
    seed = (0xC0FFEE, s)
    want = fa.dropout_factor(seed, (b, h, s, s), RATE, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, h, s, 50, device=cuda, generator=gen).to(dtype) for _ in range(3))
    out, lse = fa.flash_attention_forward(q, k, v, None, seed, RATE)
    g = torch.zeros(b, h, s, 50, device=cuda, dtype=dtype)
    g[:, :, :, :s] = torch.eye(s, device=cuda, dtype=dtype)
    dv = _routed(lambda: fa.flash_attention_backward(q, k, v, None, out, lse, g, seed, RATE), _route(dtype))[2]
    assert torch.equal(dv[..., :s].transpose(2, 3) > 0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3, 5, 8, 8, 64), (2, 3, 24, 33, 96), (2, 3, 21, 21, 96), (2, 1, 64, 64, 96),
                                  (2, 2, 7, 50, 64), (64, 8, 8, 8, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stacked_at_other_sizes_with_an_lse_cotangent(case, dtype, cuda):
    """A partial last tile, Sq != Sk, odd sizes with dropout (bf16: one slice a tile), 64 rows and 50 keys (through
    the fused backward: the dispatch sends more than 33 keys to K4), head dim 64, and an lse cotangent."""
    args = _card(*case, dtype, cuda, 3, "dialogue", RATE)
    g_lse = torch.randn(case[:2] + case[2:3], device=cuda)
    got = _routed(lambda: fa.flash_attention_fused_backward(*args, g_lse), _route(dtype))
    assert _excess(got, fa.flash_attention_backward_reference(*args, g_lse), dtype) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stacked_reproduces_bitwise(dtype, cuda):
    args = _card(32, 8, 24, 24, 96, dtype, cuda, 4, rate=RATE)
    first, second = (fa.flash_attention_backward(*args) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, h, s", [(32, 8, 8), (32, 8, 16), (32, 8, 24), (4, 8, 33), (3, 5, 21)])
def test_stacked_dropout_mask_read_off_exactly(b, h, s, dtype, cuda):
    """g one-hot, g[i, i] = 1 (head dim 96 >= S): dv[j, i] = P_ij D_ij, the mask of every slice, exactly."""
    seed = (0xC0FFEE, s)
    want = fa.dropout_factor(seed, (b, h, s, s), RATE, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, h, s, 96, device=cuda, generator=gen).to(dtype) for _ in range(3))
    out, lse = fa.flash_attention_forward(q, k, v, None, seed, RATE)
    g = torch.zeros(b, h, s, 96, device=cuda, dtype=dtype)
    g[:, :, :, :s] = torch.eye(s, device=cuda, dtype=dtype)
    dv = _routed(lambda: fa.flash_attention_backward(q, k, v, None, out, lse, g, seed, RATE), _route(dtype))[2]
    assert torch.equal(dv[..., :s].transpose(2, 3) > 0, want)


@pytest.mark.cuda
def test_bf16_limit_fails_on_rolled_key_slices(cuda):
    """The stacked design handed K whose slices are rolled by one (a tile reading its neighbour's keys) exceeds the
    2e-2 limit by far, at the 16 bucket (four slices a tile)."""
    q, k, v, mask, out, lse, g, seed, rate = _card(32, 8, 16, 16, 96, torch.bfloat16, cuda, 5)
    want = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g)
    wrong = k.reshape(256, 16, 96).roll(1, 0).reshape(k.shape).contiguous()
    got = _routed(lambda: fa.flash_attention_backward(q, wrong, v, mask, out, lse, g), "stacked_bf16")
    ratio = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item() for a, w in zip(got, want))
    assert ratio > 4 * BF16_REL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_k4_seam(dtype, cuda):
    """At BWD_FUSED_MAX = 33 keys the backward is K2's stacked design, at 34 K4; at 33 keys both kernels on the
    same inputs agree within the limits of each other, and each side holds to its plain version."""
    args = _card(32, 8, 33, 33, 96, dtype, cuda, 6)
    k2 = _routed(lambda: fa.flash_attention_backward(*args), _route(dtype))
    k4 = fa.flash_attention_tiled_backward(*args)
    assert _excess(k4, k2, dtype) <= 0
    assert _excess(k2, fa.flash_attention_backward_reference(*args), dtype) <= 0
    args = _card(32, 8, 34, 34, 96, dtype, cuda, 7)
    before = fa.flash_attention_backward.launches, fa.flash_attention_tiled_backward.launches
    got = fa.flash_attention_backward(*args)
    assert (fa.flash_attention_backward.launches, fa.flash_attention_tiled_backward.launches) == (
        before[0], before[1] + 1)
    assert _excess(got, fa.flash_attention_tiled_backward_reference(*args), dtype) <= 0


@pytest.mark.cuda
def test_routes_name_the_design_that_ran(cuda):
    """bf16 and f32 at head dim 96 and the mel branch's 50: the stacked designs; a view off 16-byte alignment, 65
    keys through the fused backward and a call through the timing hook (route 0): the template, each within the
    limits of the plain version."""
    args = _card(4, 8, 16, 16, 96, torch.bfloat16, cuda, 8)
    want = fa.flash_attention_backward_reference(*args)
    _routed(lambda: fa.flash_attention_backward(*args), "stacked_bf16")
    got = _routed(lambda: fa._k2(*args, None, route=0), "template")
    assert _excess(got, want, torch.bfloat16) <= 0
    _routed(lambda: fa.flash_attention_backward(*args), "stacked_bf16")  # the hook holds for its call alone
    q = args[0]
    flat = torch.empty(q.numel() + 1, device=cuda, dtype=q.dtype)
    shifted = flat[1:].view(q.shape)  # contiguous, 2 bytes past a 16-byte boundary
    shifted.copy_(q)
    got = _routed(lambda: fa.flash_attention_backward(shifted, *args[1:]), "template")
    assert _excess(got, want, torch.bfloat16) <= 0
    f32 = _card(4, 8, 16, 16, 96, torch.float32, cuda, 9)
    _routed(lambda: fa.flash_attention_backward(*f32), "stacked_f32")
    mel = _card(4, 6, 16, 16, 50, torch.bfloat16, cuda, 10)
    _routed(lambda: fa.flash_attention_backward(*mel), "stacked_bf16")
    long = _card(2, 2, 16, 65, 96, torch.bfloat16, cuda, 11)
    got = _routed(lambda: fa.flash_attention_fused_backward(*long), "template")
    assert _excess(got, fa.flash_attention_backward_reference(*long), torch.bfloat16) <= 0
