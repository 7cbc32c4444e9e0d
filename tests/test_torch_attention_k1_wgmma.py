"""K1's bf16 Hopper forward at head dim 64, restated on the CPU; the kernel
against its plain version on a card.

The design (``csrc/flash_attention_hopper.cuh``, ``bf16_fwd``, which K3
launches too) walks 64-key tiles. Beside each tile's K and V the producer
warp's 32 lanes make the tile's key biases in log2 units from the mask's
bytes, two keys a lane: 0 for a kept key, -1e30 log2 e for an ignored one,
-inf past Sk (the bytes there belong to the next batch element and are never
read). The consumers run an online softmax in log2 units (exp2 of scale log2
e q.k + bias - m, a running max and a row sum of the undropped
probabilities), multiply each tile's P o D, rounded to bf16, by V, and write
out = O / l and lse = m ln 2 + ln l (a fully masked row: -1e30 + ln l, in
natural units as the plain version rounds it). Dropout draws the keep bits
in the wgmma accumulator layout, as K3's design always has
(``tests/test_torch_attention_stream_wgmma.py`` restates that draw lane by
lane).

On the CPU: that algorithm restated in float64 and bf16 against
``flash_attention_reference`` and in float32 against ``mer_tpu``'s K1
(``_flash_impl``) in interpret mode, at B H <= 4, Dh 64 and 64, 99, 130 and
256 keys: a key mask, a fully masked batch element, a ragged last tile, Sq
!= Sk, and dropout's draw over 1-4 tiles. On the card (``cuda`` marker): K1
against its plain version at every Dh-64 shape of the main paths, its
dropout mask read off exactly in 64-key windows, the same bits from two
calls, the bf16 limit failing on rolled key tiles, the K1 | K3 seam at 4,096
and 4,097 keys, and ``flash_attention_forward.routes`` naming the design
that ran::

    python -m pytest --noconftest -m cuda tests/test_torch_attention_k1_wgmma.py
"""

import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa

TILE = 64
DH = 64
LOG2E = 1.4426950408889634
SEED = (0x1234ABCD, 0x0BADF00D)
BF16_REL = 2e-2  # chip_smoke.py's ATTENTION_BF16_REL


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, sq, sk, seed=0, fully_masked=False):
    """Unit-variance q, k, v over 3 (the main path's scale) and clip masks: element b keeps its first L_b >= Sk / 2
    keys less a scattered 10%, key 0 always, or with ``fully_masked`` element 0 ignores every key."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, DH)) / math.sqrt(3)
    k, v = (rng.normal(size=(b, h, sk, DH)) / math.sqrt(3) for _ in range(2))
    lengths = rng.integers(sk // 2, sk + 1, b)
    mask = (np.arange(sk)[None, :] >= lengths[:, None]) | (rng.random((b, sk)) < 0.1)
    mask[:, 0] = False
    if fully_masked:
        mask[0] = True
    return q, k, v, mask


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _tile_biases(mask: torch.Tensor, key0: int) -> torch.Tensor:
    """The producer warp's biases of the tile at key0, [B, 64] f32 in log2 units: lane l makes keys key0 + 2 l and
    + 1 from the mask's bytes, reading no byte past Sk."""
    b, sk = mask.shape
    bias = torch.empty(b, TILE, dtype=torch.float32)
    masked = torch.tensor(fa.NEG_INF, dtype=torch.float32) * LOG2E  # the kernel's -1e30f * log2 e in f32
    for lane in range(32):
        for c in range(2):
            key = key0 + 2 * lane + c
            if key >= sk:
                bias[:, 2 * lane + c] = float("-inf")
            else:
                bias[:, 2 * lane + c] = torch.where(mask[:, key], masked, torch.tensor(0.0))
    return bias


def _k1_restated(q, k, v, mask, seed=None, rate=0.0, acc=torch.float32):
    """The design tile by tile: q, k, v tensors in their dtype (P o D is rounded to it), ``acc`` the arithmetic's
    dtype. Returns (out in q's dtype, lse in ``acc``)."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    c_log2 = LOG2E / math.sqrt(dh)
    m = torch.full((b, h, sq, 1), float("-inf"), dtype=acc)
    l = torch.zeros((b, h, sq, 1), dtype=acc)
    o = torch.zeros((b, h, sq, dh), dtype=acc)
    pad = -(-sk // TILE) * TILE
    kp, vp = (torch.nn.functional.pad(t.to(acc), (0, 0, 0, pad - sk)) for t in (k, v))  # TMA's zero fill
    for k0 in range(0, sk, TILE):
        bias = _tile_biases(mask, k0).to(acc)
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kp[:, :, k0:k0 + TILE]) * c_log2 + bias[:, None, None, :]
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


# (B, H, Sq, Sk): one tile, a ragged second tile, three tiles with Sq != Sk both ways, four full tiles
CASES = [(2, 2, 64, 64), (2, 2, 99, 99), (1, 4, 130, 99), (2, 1, 99, 130), (2, 2, 256, 256), (4, 1, 70, 256)]
VARIANTS = [(False, 0.0), (True, 0.0), (False, 0.1)]  # (a fully masked batch element, dropout rate)


@pytest.mark.parametrize("fully_masked, rate", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_restated_matches_plain_version_f64(case, fully_masked, rate):
    """In float64 the two algebras agree to rounding: out 1e-12, lse 1e-9 (its values run to 1e30 where masked)."""
    q, k, v, mask = _inputs(*case, seed=sum(case), fully_masked=fully_masked)
    q, k, v = _t(q, k, v, dtype=torch.float64)
    seed = SEED if rate else None
    out, lse = _k1_restated(q, k, v, torch.from_numpy(mask), seed, rate, acc=torch.float64)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, torch.from_numpy(mask), seed, rate)
    torch.testing.assert_close(out, want_out, atol=1e-12, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-9, rtol=1e-12)


@pytest.mark.parametrize("fully_masked, rate", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_bf16_restated_within_the_card_limits_of_the_plain_version(case, fully_masked, rate):
    """bf16 inputs, f32 arithmetic, P o D rounded to bf16 against the running max (the plain version rounds the
    normalised P): within the card legs' limits of the plain version, the a priori rounding bound and 2e-2 of its
    largest |value|, lse 1e-3."""
    from mer_tpu_torch.scripts.parallel_check import bf16_out_excess, sum_bound

    q, k, v, mask = _inputs(*case, seed=sum(case) + 1, fully_masked=fully_masked)
    q, k, v = _t(q, k, v, dtype=torch.bfloat16)
    mask = torch.from_numpy(mask)
    seed = SEED if rate else None
    out, lse = _k1_restated(q, k, v, mask, seed, rate)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    assert bf16_out_excess(out, want_out, sum_bound(fa.flash_attention_reference, q, k, v, mask, seed, rate)) <= 0
    assert (out.float() - want_out.float()).abs().max() <= BF16_REL * want_out.float().abs().max()
    assert (lse - want_lse).abs().max() <= 1e-3


@pytest.mark.parametrize("sk", [64, 99, 130, 256])
def test_dropout_draw_over_tiles_is_the_whole_draw(sk):
    """The tiles' draws (each 64-key tile's dropout_factor at its first key, the ragged last one cut at Sk) put
    together are the draw over all keys: 1-4 tiles."""
    b, h, sq, rate = 2, 2, 70, 0.1
    whole = fa.dropout_factor(SEED, (b, h, sq, sk), rate)
    tiles = [fa.dropout_factor(SEED, (b, h, sq, min(TILE, sk - k0)), rate, col0=k0) for k0 in range(0, sk, TILE)]
    assert len(tiles) == -(-sk // TILE)
    assert torch.equal(torch.cat(tiles, -1), whole)


def test_restated_dropout_mask_read_off_exactly():
    """With v one-hot on a window of 64 keys, v[j, j - j0] = 1, out[i, j - j0] = P_ij D_ij / l_i: every window's
    mask, exactly, as the card's read-off does (three tiles, the last ragged)."""
    b, h, sq, sk, rate = 1, 2, 70, 150, 0.1
    seed = (0xC0FFEE, sq * 1000 + sk)
    q, k, _ = _t(*_inputs(b, h, sq, sk, seed=2)[:3])
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate) > 0
    got = torch.zeros_like(want)
    for j0 in range(0, sk, TILE):
        n = min(TILE, sk - j0)
        v = torch.zeros(b, h, sk, DH)
        v[:, :, j0:j0 + n, :n] = torch.eye(n)
        got[..., j0:j0 + n] = _k1_restated(q, k, v, torch.zeros(b, sk, dtype=torch.bool), seed, rate)[0][..., :n] > 0
    assert torch.equal(got, want)


def test_fully_masked_row_is_the_mean_of_v_and_padding_keys_weigh_nothing():
    q, k, v, mask = _inputs(2, 2, 70, 100, seed=4, fully_masked=True)
    q, k, v = _t(q, k, v)
    mask = torch.from_numpy(mask)
    out, lse = _k1_restated(q, k, v, mask)
    torch.testing.assert_close(out[0], v[0].mean(1, keepdim=True).expand_as(out[0]), atol=1e-6, rtol=0)
    assert torch.all(lse[0] == torch.tensor(fa.NEG_INF, dtype=torch.float32))
    assert torch.all(lse[1] > fa.FULLY_MASKED_LSE)
    # the second tile's keys 100..127 are -inf whatever the bytes after Sk say (the next element's row)
    tail = _tile_biases(mask, 64)
    assert torch.isinf(tail[:, 36:]).all() and (tail[:, 36:] < 0).all() and torch.isfinite(tail[:, :36]).all()
    assert (tail[0, :36] == tail[0, 0]).all() and tail[0, 0] < -1e29


def test_tile_biases_cover_each_key_once_and_read_no_byte_past_sk():
    """Lane l of the producer warp makes keys 2 l and 2 l + 1: every key of a tile once. A mask that reads as
    garbage past Sk (a [B, Sk] view of a longer row) changes no bias."""
    keys = sorted(2 * lane + c for lane in range(32) for c in range(2))
    assert keys == list(range(TILE))
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(rng.random((2, 128)) < 0.5)
    narrow = wide[:, :99].clone()
    for key0 in (0, 64):
        got = _tile_biases(narrow, key0)
        want = torch.where(wide[:, key0:key0 + TILE], fa.NEG_INF * LOG2E, 0.0).float()
        n = min(TILE, 99 - key0)
        torch.testing.assert_close(got[:, :n], want[:, :n], atol=0, rtol=0)
        assert torch.isneginf(got[:, n:]).all()


def test_forward_scratch_only_for_the_tf32_design():
    """K1 and K3 allocate f32 scratch only for the 3xTF32 forward (f32 at head dim 64): the bf16 design makes its
    biases in the kernel, the template takes none."""
    for dtype, dh, want in ((torch.bfloat16, 64, 0), (torch.float32, 64, fa.tf32_scratch_numel(2, 3, 99)),
                            (torch.bfloat16, 96, 0), (torch.float32, 50, 0)):
        out, lse, scratch = fa._forward_outputs(torch.zeros(2, 3, 70, dh, dtype=dtype), 99)
        assert scratch.numel() == want and scratch.dtype == torch.float32
        assert out.shape == (2, 3, 70, dh) and lse.shape == (2, 3, 70)


def test_cpu_calls_count_no_route():
    """On the CPU the wrapper takes the plain version: no launch, no route."""
    q, k, v, mask = _t(*_inputs(1, 2, 70, 99)[:3]) + [None]
    before = dict(fa.flash_attention_forward.routes), fa.flash_attention_forward.launches
    fa.flash_attention_forward(q, k, v, mask)
    assert (dict(fa.flash_attention_forward.routes), fa.flash_attention_forward.launches) == before
    assert set(fa.FORWARD_ROUTES) == set(fa.flash_attention_forward.routes) == {
        "template", "wgmma_bf16", "wgmma_tf32", "stacked_bf16", "stacked_f32"}


def test_bench_design_rows_time_both_designs_on_cpu():
    """``bench_attention --crossover``'s design rows: K1's template against its Hopper forward at head dim 64 on
    the same inputs, SDPA and the template on unaligned copies beside them, at the export batch's 64-499 keys and
    at 1,024, dropout 0 and 0.1 (host clock on the CPU, where both are the plain version)."""
    from mer_tpu_torch.scripts import bench_attention

    assert {s for _, _, s, _ in bench_attention.CROSSOVER_DESIGNS} == {64, 99, 128, 199, 256, 499, 1024}
    assert {dh for *_, dh in bench_attention.CROSSOVER_DESIGNS} == {64}
    row = bench_attention.crossover_row("designs", 1, 2, 99, 64, 0.1, torch.device("cpu"))
    assert row["kernels"] == "template | K1" and row["clock"] == "host (cpu)"
    assert all(row[key] > 0 for key in ("template_ms", "K1_ms", "template_unaligned_ms", "sdpa_ms"))
    assert row["faster"] in ("template", "K1")
    assert fa.flash_attention_forward.launches == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bench_unaligned_view_is_a_contiguous_copy_off_alignment(dtype):
    """The design rows' ``template_unaligned_ms`` inputs: the same values, contiguous, one element past a 16-byte
    boundary, so that K1's C entry takes the template."""
    from mer_tpu_torch.scripts import bench_attention

    t = torch.randn(2, 3, 5, 64, generator=torch.Generator().manual_seed(0)).to(dtype)
    view = bench_attention.unaligned(t)
    assert view.is_contiguous() and view.shape == t.shape and torch.equal(view, t)
    assert view.data_ptr() % 16 == t.element_size()


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


@pytest.mark.parametrize("case, fully_masked", [(case, False) for case in CASES]
                         + [(case, True) for case in CASES if case[3] % 128 == 0])
def test_restated_matches_mer_tpu_k1_interpret(jax_k1, case, fully_masked):
    """f32 against the TPU's single-pass kernel K1 (no dropout: the TPU draws its own bits), within 1e-5. A fully
    masked element only at Sk a multiple of 128: the TPU kernel pads the keys to one with ignored keys and averages
    v over the padded count there, the port over the Sk keys, as its plain version does."""
    q, k, v, mask = (a.astype(np.float32) if a.dtype == np.float64 else a
                     for a in _inputs(*case, seed=11, fully_masked=fully_masked))
    want_out, want_lse = jax_k1(q, k, v, mask)
    out, lse = _k1_restated(*_t(q, k, v), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=1e-5)


# -- on the card ------------------------------------------------------------------------------

# every Dh-64 shape K1 sees on the main paths: wav2vec2's export and evaluation batches at its five buckets'
# frames, RoBERTa-base's batches of 32 at the token ladder (chip_smoke.py's W2V_ATTENTION_SHAPES and
# TEXT_ATTENTION_SHAPES), and the fine-tune batch of 16 at wav2vec2's attention dropout
MAIN_PATH = ([((b, 12, s, s), 0.0) for b in (32, 2) for s in (99, 199, 299, 399, 499)]
             + [((32, 12, s, s), 0.0) for s in (64, 128, 256, 512)]
             + [((16, 12, s, s), 0.1) for s in (99, 199, 299, 399, 499)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1's Hopper forward has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(case, device, seed, fully_masked=False, dtype=torch.bfloat16, dh=DH):
    b, h, sq, sk = case
    gen = torch.Generator().manual_seed(seed)
    q, k, v = ((torch.randn(b, h, s, dh, generator=gen) / math.sqrt(3)).to(device, dtype) for s in (sq, sk, sk))
    mask = torch.from_numpy(_inputs(b, 1, 1, sk, seed=seed, fully_masked=fully_masked)[3]).to(device)
    return q, k, v, mask


def _excess(got, want, plain, q, k, v, mask, seed=None, rate=0.0) -> float:
    """bf16 out over chip_smoke.py's limits (<= 0 passes): the rounding bound against the plain version, and
    BF16_REL of the plain version's largest |value|."""
    from mer_tpu_torch.scripts.parallel_check import bf16_out_excess, sum_bound

    return max(bf16_out_excess(got, want, sum_bound(plain, q, k, v, mask, seed, rate)),
               ((got.float() - want.float()).abs().max() - BF16_REL * want.float().abs().max()).item())


def _routed(call, route):
    """call() and the assertion that it launched K1 once, through ``route``."""
    routes, launches = dict(fa.flash_attention_forward.routes), fa.flash_attention_forward.launches
    result = call()
    assert fa.flash_attention_forward.launches == launches + 1
    assert fa.flash_attention_forward.routes == {**routes, route: routes[route] + 1}
    return result


@pytest.mark.cuda
@pytest.mark.parametrize("case, rate", MAIN_PATH + [((2, 2, 130, 99), 0.0), ((1, 3, 99, 130), 0.1),
                                                    ((2, 3, 64, 64), 0.1)])
def test_k1_matches_plain_version(case, rate, cuda):
    for fully_masked in (False, True):
        q, k, v, mask = _card(case, cuda, sum(case), fully_masked)
        seed = (0xF00D, 8) if rate else None
        out, lse = _routed(lambda: fa.flash_attention_forward(q, k, v, mask, seed, rate), "wgmma_bf16")
        torch.cuda.synchronize()
        want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
        assert torch.isfinite(out.float()).all()
        assert _excess(out, want_out, fa.flash_attention_reference, q, k, v, mask, seed, rate) <= 0
        assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 130, 100), (1, 3, 64, 263), (2, 1, 200, 64), (16, 12, 99, 99)])
def test_k1_dropout_mask_read_off_exactly(shape, cuda):
    """With v one-hot on a window of 64 keys, v[j, j - j0] = 1, out[i, j - j0] = P_ij D_ij / l_i: the mask of
    every window, exactly."""
    b, h, sq, sk = shape
    rate, seed = 0.1, (0xC0FFEE, sq * 1000 + sk)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(sk)
    q, k = (torch.randn(b, h, n, DH, device=cuda, generator=gen).to(torch.bfloat16) for n in (sq, sk))
    got = torch.zeros_like(want)
    for j0 in range(0, sk, TILE):
        n = min(TILE, sk - j0)
        v = torch.zeros(b, h, sk, DH, device=cuda, dtype=torch.bfloat16)
        v[:, :, j0:j0 + n, :n] = torch.eye(n, device=cuda, dtype=torch.bfloat16)
        out = _routed(lambda: fa.flash_attention_forward(q, k, v, None, seed, rate), "wgmma_bf16")[0]
        got[..., j0:j0 + n] = out[..., :n] > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_reproduces_bitwise(rate, cuda):
    q, k, v, mask = _card((2, 4, 1000, 1500), cuda, 4)
    seed = (3, 4) if rate else None
    first, second = (fa.flash_attention_forward(q, k, v, mask, seed, rate) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_bf16_limit_fails_on_rolled_key_tiles(cuda):
    """K1 handed V whose keys past the first 64 are rolled by 64 (a kernel reading the wrong tile after its first)
    exceeds the 2e-2 limit by far, at the wav2vec2 export's frames."""
    q, k, v, mask = _card((2, 12, 499, 499), cuda, 5)
    want = fa.flash_attention_reference(q, k, v, mask)[0].float()
    wrong = torch.cat([v[:, :, :64], v[:, :, 64:].roll(64, 2)], 2).contiguous()
    got = _routed(lambda: fa.flash_attention_forward(q, k, wrong, mask), "wgmma_bf16")[0].float()
    assert (got - want).abs().max() > 4 * BF16_REL * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_k3_seam(rate, cuda):
    """At STREAM_THRESHOLD keys K1 and K3 run one design: the same bits from both entries; one key more,
    flash_attention_forward hands the call to K3, within the limits of the plain version."""
    seed = (0xBEEF, 2) if rate else None
    keys = fa.STREAM_THRESHOLD
    q, k, v, mask = _card((2, 2, 300, keys), cuda, 6)
    k1 = _routed(lambda: fa.flash_attention_forward(q, k, v, mask, seed, rate), "wgmma_bf16")
    k3 = fa.flash_attention_stream(q, k, v, mask, seed, rate)
    assert all(torch.equal(a, b) for a, b in zip(k1, k3))
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
    assert _excess(k1[0], want_out, fa.flash_attention_reference, q, k, v, mask, seed, rate) <= 0
    q, k, v, mask = _card((2, 2, 300, keys + 1), cuda, 7)
    before = fa.flash_attention_forward.launches, fa.flash_attention_stream.launches
    out, lse = fa.flash_attention_forward(q, k, v, mask, seed, rate)
    assert (fa.flash_attention_forward.launches, fa.flash_attention_stream.launches) == (before[0], before[1] + 1)
    want_out, want_lse = fa.flash_attention_stream_reference(q, k, v, mask, seed, rate)
    assert _excess(out, want_out, fa.flash_attention_stream_reference, q, k, v, mask, seed, rate) <= 0
    assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_routes_name_the_design_that_ran(cuda):
    """bf16 at Dh 64: the Hopper forward; f32 at Dh 64: the 3xTF32 one; the fusion model's head dim 96 at a
    dialogue's 33 keys: the stacked forward (tests/test_torch_attention_k1_stacked.py); a tensor that is not 16-byte
    aligned, and a call through the timing hook (route 0): the template. Each within the limits of the plain
    version."""
    q, k, v, mask = _card((2, 3, 99, 130), cuda, 8)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask)
    _routed(lambda: fa.flash_attention_forward(q, k, v, mask), "wgmma_bf16")
    out, lse = _routed(lambda: fa._k1(q, k, v, mask, None, 0.0, route=0), "template")
    assert _excess(out, want_out, fa.flash_attention_reference, q, k, v, mask) <= 0
    _routed(lambda: fa.flash_attention_forward(q, k, v, mask), "wgmma_bf16")  # the hook holds for its call alone
    flat = torch.empty(q.numel() + 1, device=cuda, dtype=q.dtype)
    shifted = flat[1:].view(q.shape)  # contiguous, 2 bytes past a 16-byte boundary
    shifted.copy_(q)
    out, lse = _routed(lambda: fa.flash_attention_forward(shifted, k, v, mask), "template")
    assert _excess(out, want_out, fa.flash_attention_reference, q, k, v, mask) <= 0
    _routed(lambda: fa.flash_attention_forward(q.float(), k.float(), v.float(), mask), "wgmma_tf32")
    q, k, v, mask = _card((2, 3, 33, 33), cuda, 9, dh=96)
    _routed(lambda: fa.flash_attention_forward(q, k, v, mask), "stacked_bf16")
