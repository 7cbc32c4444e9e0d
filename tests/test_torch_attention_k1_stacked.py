"""K1's one-pass stacked forward, restated on the CPU; the kernel against its
plain version on a card.

The design (``csrc/flash_attention_fwd_stacked.cuh``, which K1's C entry
launches in bf16 and f32 at Sq, Sk <= 64 and head dims 96 and 50 with
16-byte aligned q, k, v and out) stacks n consecutive (b*h) slices in one
64-row tile of the [B*H*S, Dh] views, as K2's stacked backward does (bf16:
the fewest slices that keep the grid within one block an SM, one with
dropout at an odd size; f32: one). The bf16 tiles are 64-column boxes: at Dh
96 two a row, read by TMA (rows past the tile's slices are the next slices',
zeros past the tensor), at Dh 50 one, read by 4-byte loads with columns
50-63 and the rows past the tile's real ones zero. S = q K^T runs over the
whole tile; a score whose row and key lie in different slices, or past the
tile's real rows, gets no weight. Every key of a row lies in the tile, so
the softmax takes one pass, in log2 units: the row max m of scale log2 e s
+ bias (-1e30 log2 e on an ignored key), P = exp2(. - m), l the sum of the
unrounded, undropped P, lse = m ln 2 + ln l (a fully masked row: -1e30 + ln
l, as the plain version rounds it). P o D is rounded to bf16 before O = (P o
D) V, whose N is 96 or 56 (Dh 50 zero-filled to 56), then out = O / l.
Dropout draws one Philox call per 2 x 2 scores at the drawing lane's block,
located in its slice (K2's draw).

On the CPU: that algorithm restated in float64, float32 and bf16 against
``flash_attention_reference`` and in float32 against ``mer_tpu``'s K1
(``_flash_impl``) in interpret mode, at S = 8, 16, 24 and 33 and 24 x 33,
head dims 96 and 50, B H not a multiple of n (a partial last tile), a key
mask, a fully masked element and dropout 0.4 drawn slice-locally (the draw
equal to ``dropout_factor``); ``_forward_route`` over dtype, head dim, S and
alignment; CPU calls counting no route; ``bench_attention --crossover``'s
``k1 designs`` rows. On the card (``cuda`` marker): the stacked forward
against its plain version at every K1 shape of the counted main paths in
both dtypes, the same bits from two calls, its dropout mask read off exactly,
the bf16 limit failing on rolled key slices, and
``flash_attention_forward.routes`` naming the design that ran::

    python -m pytest --noconftest -m cuda tests/test_torch_attention_k1_stacked.py
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
SMS = 132  # the H100's SMs


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, sq, sk, dh, seed=0, mask_kind="dialogue"):
    """q [B, H, Sq, Dh], k, v [B, H, Sk, Dh] of variance 1/3 (the main path's projections) and a key mask:
    "dialogue" (element i keeps its first L_i keys, element 0 only key 0), "fully_masked" (element 0 ignores every
    key) or "none"."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, dh)) / math.sqrt(3)
    k, v = (rng.normal(size=(b, h, sk, dh)) / math.sqrt(3) for _ in range(2))
    mask = None
    if mask_kind != "none":
        lengths = rng.integers(1, sk + 1, b)
        mask = np.arange(sk)[None, :] >= lengths[:, None]
        mask[0] = True
        mask[0, 0] = mask_kind == "fully_masked"
    return q, k, v, mask


def _case(b, h, sq, sk, dh, dtype, seed=0, mask_kind="dialogue", rate=0.0):
    """Torch inputs in ``dtype``, the key mask and the dropout arguments."""
    q, k, v, mask = _inputs(b, h, sq, sk, dh, seed, mask_kind)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    return q, k, v, None if mask is None else torch.from_numpy(mask), SEED if rate else None, rate


def _most(dtype, sq: int, sk: int, dropout: bool) -> int:
    """The most slices a tile may stack: as many as fit in 64 rows, one in bf16 with dropout at an odd Sq or Sk."""
    return 1 if dtype == torch.bfloat16 and dropout and (sq | sk) & 1 else TILE // max(sq, sk)


def _slices_per_tile(dtype, bh: int, sq: int, sk: int, dropout: bool, sms: int = SMS) -> int:
    """The stacked forward's slices a tile: in bf16 the fewest that keep the grid within one block an SM, at most
    ``_most``; in f32 one."""
    return min(-(-bh // sms), _most(dtype, sq, sk, dropout)) if dtype == torch.bfloat16 else 1


def _tile_factor(seed, rate, tile0, sq, sk, cslice):
    """D of a stacked 64 x 64 tile as the kernel draws it: score (r, c) takes word 2 (r & 1) + (c & 1) of the
    Philox block its drawing lane located from the block's first row r & ~1 (that row's slice: bh = tile0 + slice,
    rows counted within it) and first key c & ~1 (that key's slice)."""
    r = c = torch.arange(TILE)
    first_r, first_c = r & ~1, c & ~1
    slice_r = first_r // sq
    pair = (first_r - slice_r * sq) >> 1
    col = first_c - cslice[first_c].clamp(min=0) * sk
    w = fa.philox4x32(((col >> 1)[None, :], pair[:, None], (tile0 + slice_r)[:, None], 0), seed)
    bits = torch.where((r & 1).bool()[:, None], torch.where((c & 1).bool()[None, :], w[3], w[2]),
                       torch.where((c & 1).bool()[None, :], w[1], w[0]))
    return torch.where(bits >= fa.dropout_threshold(rate), 1.0 / (1.0 - rate), 0.0)


def _k1_restated(q, k, v, mask, seed=None, rate=0.0, spt=None, acc=torch.float32):
    """The stacked forward tile by tile: q, k, v in their dtype (P o D is rounded to it when it is not ``acc``),
    ``acc`` the arithmetic's dtype, ``spt`` the slices a tile (the design's choice by default). Returns (out in q's
    dtype, lse in ``acc``)."""
    b, h, sq, dh = q.shape
    sk, bh = k.shape[2], b * h
    spt = spt or _slices_per_tile(q.dtype, bh, sq, sk, rate > 0)
    cols = 128 if dh > 64 else 64  # two 64-column boxes at Dh 96, one at 50, zero past Dh
    n_out = -(-dh // 8) * 8  # O's columns on wgmma: 96, or 56 at Dh 50
    view = lambda t, s: F.pad(t.reshape(bh * s, dh).to(acc), (0, cols - dh))
    q2, k2, v2 = view(q, sq), view(k, sk), view(v, sk)

    def box(t, row, real):
        """64 rows from ``row``: by TMA at Dh 96 (the next slices' rows, zeros past the tensor), by 4-byte loads
        at Dh 50 (zeros from the tile's ``real`` rows on)."""
        rows = t[row:row + (TILE if dh % 8 == 0 else real)]
        return F.pad(rows, (0, 0, 0, TILE - rows.shape[0]))

    c_log2 = LOG2E / math.sqrt(dh)
    mask_bias = torch.tensor(fa.NEG_INF, dtype=torch.float32)  # the kernel's -1e30f
    mask_bias2 = mask_bias * LOG2E
    out = torch.zeros(bh * sq, dh, dtype=acc)
    lse = torch.zeros(bh * sq, dtype=acc)
    idx = torch.arange(TILE)
    for tile0 in range(0, bh, spt):
        n = min(spt, bh - tile0)
        rq, rk = n * sq, n * sk
        qt, kt, vt = box(q2, tile0 * sq, rq), box(k2, tile0 * sk, rk), box(v2, tile0 * sk, rk)
        rslice = torch.where(idx < rq, idx // sq, -2)
        cslice = torch.where(idx < rk, idx // sk, -1)
        masked = torch.zeros(TILE, dtype=torch.bool)
        if mask is not None:
            key = idx - cslice.clamp(min=0) * sk
            masked = (idx < rk) & mask[((tile0 + cslice.clamp(min=0)) // h).clamp(max=b - 1), key.clamp(max=sk - 1)]
        bias = torch.where(masked, mask_bias2, 0.0).to(acc)
        x = torch.where(rslice[:, None] == cslice[None, :], (qt @ kt.T) * c_log2 + bias[None, :], -math.inf)
        m2 = x.amax(-1)
        p = torch.where(x == -math.inf, 0.0, torch.exp2(x - m2[:, None]))
        l = p.sum(-1)
        if rate:
            p = p * _tile_factor(seed, rate, tile0, sq, sk, cslice).to(acc)
        if q.dtype != acc:
            p = p.to(q.dtype).to(acc)
        o = p @ vt[:, :n_out]
        lsum = l.clamp_min(1e-30)
        fully = m2 < 0.5 * mask_bias2
        stats = torch.where(fully, mask_bias.to(acc) + torch.log(lsum), m2 * math.log(2) + torch.log(lsum))
        out[tile0 * sq:tile0 * sq + rq] = (o / lsum[:, None])[:rq, :dh]
        lse[tile0 * sq:tile0 * sq + rq] = stats[:rq]
    return out.reshape(q.shape).to(q.dtype), lse.reshape(q.shape[:3])


# (B, H, Sq, Sk, Dh): the buckets 8, 16, 24 and 33 in both head dims, B H not a multiple of the most slices a tile
# (15 of 8, 6 of 4, 9 of 3 at the odd 21), Sq != Sk (24 x 33)
CASES = [(3, 5, 8, 8, 96), (2, 3, 16, 16, 50), (2, 2, 24, 24, 96), (2, 2, 33, 33, 50), (3, 2, 24, 33, 96),
         (3, 3, 21, 21, 50)]
VARIANTS = [("dialogue", 0.0), ("fully_masked", 0.0), ("dialogue", RATE), ("fully_masked", RATE)]
STACKS = ["one", "most"]  # one slice a tile, or the most a tile may stack (bf16's rule with dropout at odd sizes)


def _spt(stack: str, case, rate: float) -> int:
    """The slices a tile of a restated case: the bf16 design's draw at ``_most`` (every dtype's restatement draws as
    the bf16 design does; the f32 design takes one slice a tile, where the draw is the plain one)."""
    return 1 if stack == "one" else _most(torch.bfloat16, case[2], case[3], rate > 0)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("mask_kind, rate", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_restated_matches_plain_version_f64(case, mask_kind, rate, stack):
    """In float64 the stacked one-pass algebra is the plain version's to rounding: out 1e-12, lse 1e-9 (its values
    run to 1e30 where masked), dropout drawn slice-locally."""
    q, k, v, mask, seed, rate = _case(*case, torch.float64, seed=sum(case), mask_kind=mask_kind, rate=rate)
    out, lse = _k1_restated(q, k, v, mask, seed, rate, spt=_spt(stack, case, rate), acc=torch.float64)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    torch.testing.assert_close(out, want_out, atol=1e-12, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-9, rtol=1e-12)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("mask_kind, rate", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_restated_matches_plain_version_f32(case, mask_kind, rate, stack):
    """The f32 arithmetic (the scores over the stacked tile in log2 units, one pass) within the card's f32 limits of
    the plain version: out 2e-5, lse 2e-5 (sums of at most 33 terms of values under 1)."""
    q, k, v, mask, seed, rate = _case(*case, torch.float32, seed=sum(case) + 1, mask_kind=mask_kind, rate=rate)
    out, lse = _k1_restated(q, k, v, mask, seed, rate, spt=_spt(stack, case, rate))
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=1e-7)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("mask_kind, rate", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_bf16_restated_within_the_card_limits_of_the_plain_version(case, mask_kind, rate, stack):
    """bf16 inputs, f32 arithmetic, P o D rounded to bf16 against the row max (the plain version rounds the
    normalised P): within the card legs' limits of the plain version, the a priori rounding bound and 2e-2 of its
    largest |value|, lse 1e-3."""
    from mer_tpu_torch.scripts.parallel_check import bf16_out_excess, sum_bound

    q, k, v, mask, seed, rate = _case(*case, torch.bfloat16, seed=sum(case) + 2, mask_kind=mask_kind, rate=rate)
    out, lse = _k1_restated(q, k, v, mask, seed, rate, spt=_spt(stack, case, rate))
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    assert bf16_out_excess(out, want_out, sum_bound(fa.flash_attention_reference, q, k, v, mask, seed, rate)) <= 0
    assert (out.float() - want_out.float()).abs().max() <= BF16_REL * want_out.float().abs().max()
    assert (lse - want_lse).abs().max() <= 1e-3


def test_fully_masked_row_is_the_mean_of_v():
    """A fully masked element: every score rounds to the mask bias, P = 1 on each of its keys, out the mean of v,
    lse -1e30 as the plain version rounds it; the other elements' lse is finite."""
    q, k, v, mask, _, _ = _case(3, 2, 16, 16, 50, torch.float32, seed=4, mask_kind="fully_masked")
    out, lse = _k1_restated(q, k, v, mask, spt=4)
    torch.testing.assert_close(out[0], v[0].mean(1, keepdim=True).expand_as(out[0]), atol=1e-6, rtol=0)
    assert torch.all(lse[0] == torch.tensor(fa.NEG_INF, dtype=torch.float32))
    assert torch.all(lse[1:] > fa.FULLY_MASKED_LSE)


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
        d = _tile_factor(SEED, RATE, tile0, sq, sk, torch.where(idx < n * sk, idx // sk, -1))
        for s in range(n):
            assert torch.equal(d[s * sq:(s + 1) * sq, s * sk:(s + 1) * sk], want[tile0 + s])


def test_restated_dropout_mask_read_off_exactly():
    """With v one-hot, v[j, j] = 1 (Dh 96 and 50 >= Sk), out[i, j] = P_ij D_ij / l_i: the mask of every slice,
    exactly, as the card's read-off does, at the most slices a tile."""
    for dh in (96, 50):
        b, h, s = 3, 5, 16
        q, k, _, _, _, _ = _case(b, h, s, s, dh, torch.float32, seed=dh)
        v = torch.zeros(b, h, s, dh)
        v[..., :s] = torch.eye(s)
        seed = (0xC0FFEE, s)
        want = fa.dropout_factor(seed, (b, h, s, s), RATE) > 0
        out = _k1_restated(q, k, v, None, seed, RATE, spt=_most(torch.bfloat16, s, s, True))[0]
        assert torch.equal(out[..., :s] > 0, want)


def test_head_dim_50_pads_to_the_boxes_and_stores_50_columns():
    """At Dh 50 the operands' columns 50-63 are zero, so S over four 16-column k-steps is q K^T over 50, and O's
    56 columns hold out's 50 and six zeros: the restatement with a Dh-64 zero extension is the Dh-50 one."""
    q, k, v, mask, _, _ = _case(2, 3, 16, 16, 50, torch.float64, seed=9)
    wide = [F.pad(t, (0, 14)) for t in (q, k, v)]
    out, lse = _k1_restated(q, k, v, mask, acc=torch.float64)
    scale_fix = math.sqrt(64 / 50)  # the restatement scales by 1/sqrt(Dh): undo the wider head dim's
    out64, lse64 = _k1_restated(wide[0] * scale_fix, wide[1], wide[2], mask, acc=torch.float64)
    torch.testing.assert_close(out64[..., :50], out, atol=1e-12, rtol=0)
    assert torch.all(out64[..., 50:] == 0)
    torch.testing.assert_close(lse64, lse, atol=1e-9, rtol=1e-12)


def test_slices_per_tile_at_the_buckets():
    """At most 8, 4, 2 and 1 slices a tile at the buckets 8, 16, 24 and 33 (1 at 24 x 33); the design's choice,
    one block an SM of the H100's 132: bf16 one slice at B H = 128 (16 x 8, 32 x 4) and 192 (32 x 6, the mel
    variant's audio heads: two), two at 256 (one at 33 keys), f32 one."""
    for drop in (False, True):
        assert [_most(torch.bfloat16, s, s, drop) for s in (8, 16, 24, 33)] == [8, 4, 2, 1]
        assert [_slices_per_tile(torch.bfloat16, 128, s, s, drop) for s in (8, 16, 24, 33)] == [1, 1, 1, 1]
        assert [_slices_per_tile(torch.bfloat16, 192, s, s, drop) for s in (8, 16, 24, 33)] == [2, 2, 2, 1]
        assert [_slices_per_tile(torch.bfloat16, 256, s, s, drop) for s in (8, 16, 24, 33)] == [2, 2, 2, 1]
        assert [_slices_per_tile(torch.float32, 256, s, s, drop) for s in (8, 16, 24, 33)] == [1, 1, 1, 1]
    assert _slices_per_tile(torch.bfloat16, 1536, 24, 24, False) == 2  # the serving batch of 192: capped at what fits


@pytest.mark.parametrize("dtype, sq, sk, dh, aligned, want", [
    (torch.bfloat16, 8, 8, 96, True, "stacked_bf16"), (torch.float32, 33, 33, 96, True, "stacked_f32"),
    (torch.bfloat16, 24, 33, 50, True, "stacked_bf16"), (torch.float32, 64, 64, 50, True, "stacked_f32"),
    (torch.bfloat16, 1, 1, 96, True, "stacked_bf16"), (torch.bfloat16, 65, 8, 96, True, "template"),
    (torch.float32, 8, 65, 50, True, "template"), (torch.bfloat16, 16, 16, 64, True, "wgmma_bf16"),
    (torch.float32, 99, 99, 64, True, "wgmma_tf32"), (torch.float32, 16, 16, 128, True, "template"),
    (torch.bfloat16, 16, 16, 96, False, "template"), (torch.float32, 16, 16, 64, False, "template"),
    (torch.float64, 16, 16, 96, True, "template")])
def test_forward_route(dtype, sq, sk, dh, aligned, want):
    """The design K1's C entry takes, as the wrapper mirrors it: the Hopper forwards at head dim 64, the stacked
    forward in bf16 and f32 at Sq, Sk <= 64 and head dims 96 and 50 with aligned tensors, the template otherwise
    (other head dims, unaligned views, longer sequences)."""
    assert fa._forward_route(dtype, sq, sk, dh, aligned) == want
    assert fa.FORWARD_ROUTES == ("template", "wgmma_bf16", "wgmma_tf32", "stacked_bf16", "stacked_f32")


def test_cpu_calls_count_no_route():
    """On the CPU the wrapper takes the plain version: no launch, no route."""
    q, k, v, mask, _, _ = _case(2, 2, 8, 8, 96, torch.float32)
    before = dict(fa.flash_attention_forward.routes), fa.flash_attention_forward.launches
    got = fa.flash_attention_forward(q, k, v, mask)
    assert (dict(fa.flash_attention_forward.routes), fa.flash_attention_forward.launches) == before
    assert set(fa.flash_attention_forward.routes) == set(fa.FORWARD_ROUTES)
    for a, w in zip(got, fa.flash_attention_reference(q, k, v, mask)):
        assert torch.equal(a, w)


def test_crossover_k1_shapes_are_the_counted_k1_rows():
    """``bench_attention --crossover`` times K1's designs at the K1 shapes of the counted main paths at the fusion
    model's head dims (bf16 at 96 and the mel variant's 50, f32 at 96) and the 33 bucket."""
    from mer_tpu_torch.scripts import bench_attention

    shapes = bench_attention.CROSSOVER_K1
    assert len(set(shapes)) == len(shapes) == 30
    assert {dh for *_, dh, _, _ in shapes} == {96, 50}
    assert {s for _, _, s, *_ in shapes} == {8, 16, 24, 33}
    assert all(fa._forward_route(bench_attention.DTYPES[dt], s, s, dh, True).startswith("stacked")
               for _, _, s, dh, dt, _ in shapes)
    assert (32, 8, 33, 96, "float32", 0.0) in shapes and (32, 6, 24, 50, "bfloat16", RATE) in shapes


def test_bench_k1_design_rows_time_both_designs_on_cpu():
    """``bench_attention --crossover``'s K1 design rows: the template, the stacked forward and SDPA's forward on the
    same inputs (host clock on the CPU, where every design is the plain version)."""
    from mer_tpu_torch.scripts import bench_attention

    for dh in (96, 50):
        row = bench_attention.k1_design_row(2, 2, 8, dh, "float32", RATE, torch.device("cpu"))
        assert row["direction"] == "k1 designs" and row["kernels"] == "template | stacked"
        assert row["clock"] == "host (cpu)" and row["Dh"] == dh
        assert all(row[key] > 0 for key in ("template_ms", "stacked_ms", "sdpa_ms"))
    assert fa.flash_attention_forward.launches == 0


@pytest.fixture(scope="module")
def jax_k1():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_impl

    def k1(q, k, v, mask):
        bias = jnp.where(jnp.asarray(mask), _NEG_INF, 0.0).astype(jnp.float32)
        out, lse = _flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, interpret=True,
                               return_stats=True)
        return np.asarray(out), np.asarray(lse)

    return k1


@pytest.mark.parametrize("case", CASES)
def test_restated_matches_mer_tpu_k1_interpret(jax_k1, case):
    """f32 against the TPU's single-pass kernel K1 at the most slices a tile, within 1e-5 (no dropout: the TPU draws
    its own bits; no fully masked element: the TPU kernel pads the keys to 128 and averages v over the padded count
    there, the port over the Sk keys, as its plain version does)."""
    q, k, v, mask = (a.astype(np.float32) if a.dtype == np.float64 else a for a in _inputs(*case, seed=11))
    want_out, want_lse = jax_k1(q, k, v, mask)
    t = lambda a: torch.from_numpy(np.array(a))
    out, lse = _k1_restated(t(q), t(k), t(v), t(mask), spt=_spt("most", case, 0.0))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=1e-5)


# -- on the card ------------------------------------------------------------------------------

# every K1 shape of chip_smoke.py's counted main paths at the fusion model's head dims ([B, H, S, S, Dh]: evaluation,
# serving and training batches, the tp 2 and dp 2 ranks' 4 heads and 16 dialogues, the mel variant's 6 heads of 50)
# and the 33 bucket, dropout 0 and the model's 0.4
CARD_SHAPES = [(16, 8, 8, 96), (16, 8, 16, 96), (32, 4, 8, 96), (32, 4, 16, 96), (32, 8, 8, 96), (32, 8, 16, 96),
               (32, 8, 24, 96), (32, 8, 33, 96), (64, 8, 16, 96), (64, 8, 24, 96), (96, 8, 16, 96), (192, 8, 24, 96),
               (32, 6, 8, 50), (32, 6, 16, 50), (32, 6, 24, 50), (32, 6, 33, 50)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1's stacked forward has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(b, h, sq, sk, dh, dtype, device, seed, mask_kind="dialogue", rate=0.0):
    q, k, v, mask, _, _ = _case(b, h, sq, sk, dh, torch.float32, seed, mask_kind)
    q, k, v = (t.to(device, dtype) for t in (q, k, v))
    return q, k, v, None if mask is None else mask.to(device), (0xF00D, seed) if rate else None, rate


def _excess(got, want, args) -> float:
    """out and lse over chip_smoke.py's limits (<= 0 passes): f32 2e-5 on both; bf16 out the rounding bound and
    BF16_REL of the plain version's largest |value|, lse 1e-3."""
    from mer_tpu_torch.scripts.parallel_check import bf16_out_excess, sum_bound

    (out, lse), (want_out, want_lse) = got, want
    if out.dtype == torch.float32:
        return max((out - want_out).abs().max().item() - 2e-5, (lse - want_lse).abs().max().item() - 2e-5)
    return max(bf16_out_excess(out, want_out, sum_bound(fa.flash_attention_reference, *args)),
               ((out.float() - want_out.float()).abs().max() - BF16_REL * want_out.float().abs().max()).item(),
               (lse - want_lse).abs().max().item() - 1e-3)


def _routed(call, route):
    """call() and the assertion that it launched K1 once, through ``route``."""
    routes, launches = dict(fa.flash_attention_forward.routes), fa.flash_attention_forward.launches
    result = call()
    assert fa.flash_attention_forward.launches == launches + 1
    assert fa.flash_attention_forward.routes == {**routes, route: routes[route] + 1}
    return result


def _route(dtype) -> str:
    return "stacked_bf16" if dtype == torch.bfloat16 else "stacked_f32"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_stacked_matches_plain_version(shape, dtype, rate, cuda):
    b, h, s, dh = shape
    for mask_kind in ("dialogue", "fully_masked"):
        args = _card(b, h, s, s, dh, dtype, cuda, sum(shape), mask_kind, rate)
        got = _routed(lambda: fa.flash_attention_forward(*args), _route(dtype))
        torch.cuda.synchronize()
        assert torch.isfinite(got[0].float()).all()
        assert _excess(got, fa.flash_attention_reference(*args), args) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3, 5, 8, 8, 96), (2, 3, 24, 33, 96), (2, 3, 21, 21, 50), (2, 1, 64, 64, 96),
                                  (2, 2, 7, 50, 50), (64, 8, 8, 8, 50), (1, 1, 1, 1, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stacked_at_other_sizes(case, dtype, cuda):
    """A partial last tile, Sq != Sk, odd sizes with dropout (bf16: one slice a tile), 64 rows and keys, 50 keys,
    more slices than one wave, a single score."""
    args = _card(*case, dtype, cuda, 3, "dialogue", RATE)
    got = _routed(lambda: fa.flash_attention_forward(*args), _route(dtype))
    assert _excess(got, fa.flash_attention_reference(*args), args) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [96, 50])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stacked_reproduces_bitwise(dtype, dh, cuda):
    args = _card(32, 8, 24, 24, dh, dtype, cuda, 4, rate=RATE)
    first, second = (fa.flash_attention_forward(*args) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [96, 50])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, h, s", [(32, 8, 8), (32, 8, 16), (32, 6, 24), (4, 8, 33), (3, 5, 21)])
def test_stacked_dropout_mask_read_off_exactly(b, h, s, dtype, dh, cuda):
    """v one-hot, v[j, j] = 1 (head dim >= S): out[i, j] = P_ij D_ij / l_i, the mask of every slice, exactly."""
    seed = (0xC0FFEE, s)
    want = fa.dropout_factor(seed, (b, h, s, s), RATE, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k = (torch.randn(b, h, s, dh, device=cuda, generator=gen).to(dtype) for _ in range(2))
    v = torch.zeros(b, h, s, dh, device=cuda, dtype=dtype)
    v[..., :s] = torch.eye(s, device=cuda, dtype=dtype)
    out = _routed(lambda: fa.flash_attention_forward(q, k, v, None, seed, RATE), _route(dtype))[0]
    assert torch.equal(out[..., :s] > 0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [96, 50])
def test_bf16_limit_fails_on_rolled_key_slices(dh, cuda):
    """The stacked forward handed K and V whose slices are rolled by one (a tile reading its neighbour's keys)
    exceeds the bf16 limit by far, at the 16 bucket (two slices a tile)."""
    q, k, v, mask, _, _ = args = _card(32, 8, 16, 16, dh, torch.bfloat16, cuda, 5)
    want = fa.flash_attention_reference(*args)
    rolled = [t.reshape(256, 16, dh).roll(1, 0).reshape(t.shape).contiguous() for t in (k, v)]
    got = _routed(lambda: fa.flash_attention_forward(q, *rolled, mask), "stacked_bf16")
    assert _excess(got, want, args) > 0
    assert (got[0].float() - want[0].float()).abs().max() > 4 * BF16_REL * want[0].float().abs().max()


@pytest.mark.cuda
def test_routes_name_the_design_that_ran(cuda):
    """bf16 and f32 at head dims 96 and 50: the stacked forwards; 65 keys, a view off 16-byte alignment and a call
    through the timing hook (route 0): the template, each within the limits of the plain version."""
    args = _card(4, 8, 16, 16, 96, torch.bfloat16, cuda, 8)
    want = fa.flash_attention_reference(*args)
    _routed(lambda: fa.flash_attention_forward(*args), "stacked_bf16")
    got = _routed(lambda: fa._k1(*args, route=0), "template")
    assert _excess(got, want, args) <= 0
    _routed(lambda: fa.flash_attention_forward(*args), "stacked_bf16")  # the hook holds for its call alone
    q = args[0]
    flat = torch.empty(q.numel() + 1, device=cuda, dtype=q.dtype)
    shifted = flat[1:].view(q.shape)  # contiguous, 2 bytes past a 16-byte boundary
    shifted.copy_(q)
    got = _routed(lambda: fa.flash_attention_forward(shifted, *args[1:]), "template")
    assert _excess(got, want, args) <= 0
    _routed(lambda: fa.flash_attention_forward(*_card(4, 8, 16, 16, 96, torch.float32, cuda, 9)), "stacked_f32")
    _routed(lambda: fa.flash_attention_forward(*_card(4, 6, 16, 16, 50, torch.bfloat16, cuda, 10)), "stacked_bf16")
    _routed(lambda: fa.flash_attention_forward(*_card(4, 6, 16, 16, 50, torch.float32, cuda, 10)), "stacked_f32")
    long = _card(2, 2, 16, 65, 96, torch.bfloat16, cuda, 11)
    got = _routed(lambda: fa.flash_attention_forward(*long), "template")
    assert _excess(got, fa.flash_attention_reference(*long), long) <= 0
