"""K1's and K3's f32 forward at head dim 64: TF32 with error compensation
(3xTF32) on ``wgmma``, restated on the CPU; both entries against their plain
versions on a card.

The design (``csrc/flash_attention_hopper.cuh``): a prep pass writes the key
biases in log2 units and splits every K and V value into x = hi + lo, hi =
tf32(x), lo = tf32(x - hi) (``cvt.rna.tf32.f32``), V transposed with its keys
permuted inside each group of 8 (position p holds key 2 (p & 3) + (p >> 2)).
The forward splits q once, then per 64-key tile forms S = lo_q hi_K + hi_q
lo_K + hi_q hi_K (the small terms first), runs the online softmax in log2
units, splits P o D in registers and forms lo_P hi_V + hi_P lo_V + hi_P hi_V
into a fresh accumulator, added to the rescaled O in f32. TF32 ``wgmma`` takes
its A operand from registers in columns t and t + 4 of lane (g, t), and the
accumulator gives that lane keys 8 j + 2 t and + 1: the permutation lines
them up.

On the CPU, that algorithm restated (``_restated``), at 299-499 keys and
ragged, Sq != Sk, with a key mask, a fully masked batch element and dropout
0.1:

- in float64 arithmetic against ``flash_attention_reference`` in float64, to
  the size of the dropped lo lo term;
- in float32 within the card's f32 limits of the f32 plain versions of both
  entries (out (2e-5, 0), lse 2e-5; ``chip_smoke.py``), and against
  ``mer_tpu``'s single-pass and streaming kernels in interpret mode;
- the control: one TF32 pass (hi hi alone) exceeds the out limit;
- its dropout mask read off exactly (v one-hot on a window of 64 keys);
- the permutation lane by lane: every lane's accumulator columns (2 t, 2 t +
  1) serve as A columns (t, t + 4), each A element once, and V^T's reordered
  groups give P V exactly.

On the card (``cuda`` marker): both entries against their plain versions, one
launch a call, the same bits from two calls, the masks read off::

    python -m pytest --noconftest -m cuda tests/test_torch_attention_tf32.py
"""

import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.ops.w2v_conv import tf32_round

TILE = 64
DH = 64
LOG2E = 1.4426950408889634
SEED = (0x2468ACE0, 0x13579BDF)
F32_OUT, F32_LSE = 2e-5, 2e-5  # chip_smoke.py's f32 limits of K1 and K3 (atol; rtol 0)
PERM = [2 * (p & 3) + (p >> 2) for p in range(8)]  # the key at position p of a group of 8 in V^T
# (B, H, Sq, Sk): the f32 export's frames, a ragged key tile with Sq < Sk, Sq > Sk, one key tile
CASES = [(1, 2, 299, 299), (1, 2, 399, 399), (1, 2, 499, 499), (2, 2, 150, 301), (2, 1, 300, 130), (1, 2, 70, 64)]
VARIANTS = [(False, 0.0), (True, 0.0), (False, 0.1)]  # (fully masked batch element, dropout rate)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, sq, sk, seed=0, fully_masked=False):
    """f32 q, k, v of unit variance over 3 (the main path's scale) and clip masks: element b keeps its first
    L_b >= Sk / 2 keys less a scattered 10%, key 0 always, or with ``fully_masked`` element 0 ignores every key."""
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.normal(size=(b, h, n, DH)) / math.sqrt(3)).astype(np.float32) for n in (sq, sk, sk))
    lengths = rng.integers(sk // 2, sk + 1, b)
    mask = (np.arange(sk)[None, :] >= lengths[:, None]) | (rng.random((b, sk)) < 0.1)
    mask[:, 0] = False
    if fully_masked:
        mask[0] = True
    return [torch.from_numpy(a) for a in (q, k, v, mask)]


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 x as TF32 halves: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _positions(n: int) -> torch.Tensor:
    """Key of each position of n (a multiple of 8) keys whose groups of 8 are permuted as V^T stores them."""
    return torch.arange(n).view(-1, 8)[:, PERM].reshape(-1)


def _prep(k, v, mask):
    """The prep pass: key biases [B, pad] in log2 units (0, -1e30 log2 e ignored, -inf past Sk), K's halves
    [B, H, pad, 64] and V^T's [B, H, 64, pad] (keys permuted in groups of 8), zero past Sk; pad = Sk rounded up to
    64."""
    b, _, sk, _ = k.shape
    pad = -(-sk // TILE) * TILE
    bias = torch.full((b, pad), float("-inf"), dtype=torch.float32)
    bias[:, :sk] = torch.where(mask, torch.tensor(fa.NEG_INF, dtype=torch.float32) * LOG2E, 0.0)
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad - sk)) for t in (k, v))
    vt = vp.transpose(2, 3)[..., _positions(pad)].contiguous()
    return bias, _split(kp), _split(vt)


def _restated(q, k, v, mask, seed=None, rate=0.0, acc=torch.float32, passes=3):
    """The f32 design tile by tile on f32 q, k, v, with its splits, in ``acc`` arithmetic; ``passes`` 1 keeps
    hi hi alone (one TF32 pass). Returns (out, lse) in ``acc``."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    bias, (k_hi, k_lo), (vt_hi, vt_lo) = _prep(k, v, mask)
    q_hi, q_lo = _split(q)
    c_log2 = LOG2E / math.sqrt(DH)
    m = torch.full((b, h, sq, 1), float("-inf"), dtype=acc)
    l = torch.zeros((b, h, sq, 1), dtype=acc)
    o = torch.zeros((b, h, sq, DH), dtype=acc)
    order = _positions(TILE)
    for k0 in range(0, sk, TILE):
        kh, kl = (t[:, :, k0:k0 + TILE].to(acc) for t in (k_hi, k_lo))
        pairs = [(q_lo, kh), (q_hi, kl), (q_hi, kh)][3 - passes:]  # the small terms first
        s = torch.zeros((b, h, sq, TILE), dtype=acc)
        for a, bk in pairs:
            s = s + torch.einsum("bhqd,bhkd->bhqk", a.to(acc), bk)
        s = s * c_log2 + bias[:, None, None, k0:k0 + TILE].to(acc)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if rate:
            n = min(TILE, sk - k0)
            factor = torch.zeros_like(p)
            factor[..., :n] = fa.dropout_factor(seed, (b, h, sq, n), rate, col0=k0).to(acc)
            p = p * factor
        # the A fragments: k-step j's columns are keys 8 j + PERM, as V^T's positions are
        p_hi, p_lo = _split(p[..., order].float())
        vh, vl = (t[..., k0:k0 + TILE].to(acc) for t in (vt_hi, vt_lo))
        pv = torch.zeros_like(o)  # a fresh accumulator a tile
        for a, bv in [(p_lo, vh), (p_hi, vl), (p_hi, vh)][3 - passes:]:
            pv = pv + torch.einsum("bhqk,bhdk->bhqd", a.to(acc), bv)
        o = o * alpha + pv
        m = m_new
    l = l.clamp_min(1e-30)
    fully = m < 0.5 * fa.NEG_INF * LOG2E
    mask_bias = torch.tensor(fa.NEG_INF, dtype=torch.float32).to(acc)  # the kernel's -1e30f
    lse = torch.where(fully, mask_bias + torch.log(l), m * math.log(2) + torch.log(l))
    return o / l, lse[..., 0]


def _case(case, variant, seed):
    fully_masked, rate = variant
    q, k, v, mask = _inputs(*case, seed=seed, fully_masked=fully_masked)
    return q, k, v, mask, (SEED if rate else None), rate


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_restated_in_f64_matches_reference_f64(case, variant):
    """In float64 arithmetic on the kernel's TF32 halves the design is the reference's function but for the
    dropped lo lo terms (2^-22 of a product): out within 1e-6, lse within 1e-6 (1e-12 relative where masked)."""
    q, k, v, mask, seed, rate = _case(case, variant, sum(case))
    out, lse = _restated(q, k, v, mask, seed, rate, acc=torch.float64)
    want_out, want_lse = fa.flash_attention_reference(q.double(), k.double(), v.double(), mask, seed, rate)
    torch.testing.assert_close(out, want_out, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_restated_f32_within_the_card_limits_of_both_plain_versions(case, variant):
    """In f32 the design lies within the f32 limits of K1's and K3's plain versions: out (2e-5, 0), lse 2e-5."""
    q, k, v, mask, seed, rate = _case(case, variant, sum(case))
    out, lse = _restated(q, k, v, mask, seed, rate)
    for plain in (fa.flash_attention_reference, fa.flash_attention_stream_reference):
        want_out, want_lse = plain(q, k, v, mask, seed, rate)
        assert (out - want_out).abs().max().item() <= F32_OUT
        assert (lse - want_lse).abs().max().item() <= F32_LSE


def test_fully_masked_row_is_the_mean_of_v_and_padding_keys_weigh_nothing():
    q, k, v, mask = _inputs(2, 2, 70, 100, seed=4, fully_masked=True)
    out, lse = _restated(q, k, v, mask)
    torch.testing.assert_close(out[0], v[0].mean(1, keepdim=True).expand_as(out[0]), atol=1e-6, rtol=0)
    assert torch.all(lse[0] == torch.tensor(fa.NEG_INF, dtype=torch.float32))
    assert torch.all(lse[1] > fa.FULLY_MASKED_LSE)
    bias, (k_hi, k_lo), (vt_hi, vt_lo) = _prep(k, v, mask)
    assert torch.isinf(bias[:, 100:]).all() and (bias[:, 100:] < 0).all() and torch.isfinite(bias[:, :100]).all()
    past = _positions(bias.shape[1]) >= 100  # V^T's positions of the padding keys
    assert not any(t[:, :, 100:].any() for t in (k_hi, k_lo)) and not any(t[..., past].any() for t in (vt_hi, vt_lo))


def test_one_tf32_pass_exceeds_the_f32_limit():
    """The control: hi hi alone (one TF32 pass, 2^-11 of each product kept) misses the out limit that three
    passes meet, at the f32 export's 499 frames."""
    q, k, v, mask = _inputs(1, 4, 499, 499, seed=9)
    want_out, _ = fa.flash_attention_reference(q, k, v, mask)
    one = (_restated(q, k, v, mask, passes=1)[0] - want_out).abs().max().item()
    three = (_restated(q, k, v, mask)[0] - want_out).abs().max().item()
    assert three <= F32_OUT < one


def test_splits_are_tf32_and_exact():
    """hi and lo are TF32 (low 13 bits 0) and hi + lo is x but for lo's own rounding, 2^-22 of x."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    hi, lo = _split(x)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


def test_restated_dropout_mask_read_off_exactly():
    """With v one-hot on a window of 64 keys, v[j, j - j0] = 1, out[i, j - j0] = P_ij D_ij / l_i through the
    permuted V^T: every window's mask, exactly, as the card's read-off does."""
    b, h, sq, sk, rate = 1, 2, 70, 150, 0.1
    seed = (0xC0FFEE, sq * 1000 + sk)
    q, k, _, _ = _inputs(b, h, sq, sk, seed=2)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate) > 0
    got = torch.zeros_like(want)
    for j0 in range(0, sk, TILE):
        n = min(TILE, sk - j0)
        v = torch.zeros(b, h, sk, DH)
        v[:, :, j0:j0 + n, :n] = torch.eye(n)
        got[..., j0:j0 + n] = _restated(q, k, v, torch.zeros(b, sk, dtype=torch.bool), seed, rate)[0][..., :n] > 0
    assert torch.equal(got, want)


def test_permuted_fragments_give_p_v_exactly():
    """Lane by lane for one warpgroup's 64 x 64 tile: lane (g, t) of warp w holds accumulator entries
    sc[4 j + 2 h + c] at row 16 w + g + 8 h, key 8 j + 2 t + c; as k-step j's A fragment a[r] = sc[4 j + 2 (r & 1) +
    (r >> 1)] it fills A's row 16 w + g + 8 (r & 1), column t + 4 (r >> 1) (tf32 wgmma's register layout). Every
    A element is written once, and with B's k-step j the rows of V^T's permuted group j the eight products give
    P V exactly (small integers: no rounding)."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.integers(-8, 9, (TILE, TILE)).astype(np.float64))
    v = torch.from_numpy(rng.integers(-8, 9, (TILE, DH)).astype(np.float64))
    vt = v.t()[:, _positions(TILE)]  # [64 columns of v][64 key positions]
    d = torch.zeros(TILE, DH, dtype=torch.float64)
    for j in range(8):
        a = torch.full((TILE, 8), float("nan"), dtype=torch.float64)
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                sc = {4 * j + 2 * hh + c: p[16 * w + g + 8 * hh, 8 * j + 2 * t + c]
                      for hh in range(2) for c in range(2)}
                for r in range(4):
                    row, col = 16 * w + g + 8 * (r & 1), t + 4 * (r >> 1)
                    assert math.isnan(a[row, col])  # each element once
                    a[row, col] = sc[4 * j + 2 * (r & 1) + (r >> 1)]
        assert not a.isnan().any()
        d += a @ vt[:, 8 * j:8 * j + 8].t()  # B [64 x 8] K-major: V^T's rows, this k-step's 8 positions
    assert torch.equal(d, p @ v)


def test_tf32_scratch_holds_biases_and_four_halves():
    assert fa.tf32_scratch_numel(32, 12, 499) == 32 * 512 + 4 * 32 * 12 * 512 * 64
    assert fa.tf32_scratch_numel(2, 12, 4499) == 2 * 4544 * (1 + 4 * 12 * 64)


@pytest.fixture(scope="module")
def jax_forward():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_impl

    def forward(q, k, v, mask, stream):
        bias = jnp.where(jnp.asarray(mask), _NEG_INF, 0.0).astype(jnp.float32)
        out, lse = _flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, interpret=True,
                               force_stream=stream, return_stats=True)
        return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse))

    return forward


@pytest.mark.parametrize("stream", [False, True], ids=["k1_kernel", "k3_stream_kernel"])
@pytest.mark.parametrize("case", [(2, 2, 100, 300), (1, 2, 300, 200)])
def test_restated_matches_mer_tpu_kernels_interpret(jax_forward, case, stream):
    """f32: the design against the TPU's single-pass kernel (K1's route) and its streaming kernel
    (``force_stream``, K3's), within the card's f32 limits. (No fully masked row: the streaming TPU kernel averages
    v over its padded keys there.)"""
    q, k, v, mask = _inputs(*case, seed=11)
    want_out, want_lse = jax_forward(q.numpy(), k.numpy(), v.numpy(), mask.numpy(), stream)
    out, lse = _restated(q, k, v, mask)
    assert (out - want_out).abs().max().item() <= F32_OUT
    assert (lse - want_lse).abs().max().item() <= F32_LSE


# -- on the card ------------------------------------------------------------------------------

ENTRIES = {"k1": ("flash_attention_forward", "flash_attention_reference"),
           "k3": ("flash_attention_stream", "flash_attention_stream_reference")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the 3xTF32 forward has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", [(32, 12, 499, 499), (2, 12, 2999, 2999), (2, 2, 300, 1000), (2, 2, 1000, 300),
                                  (2, 3, 65, 33), (3, 2, 8, 8)])
@pytest.mark.parametrize("entry", ENTRIES)
def test_f32_matches_plain_version(entry, case, variant, cuda):
    q, k, v, mask, seed, rate = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                                 for t in _case(case, variant, sum(case)))
    call, plain = (getattr(fa, name) for name in ENTRIES[entry])
    before = call.launches
    out, lse = call(q, k, v, mask, seed, rate)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    want_out, want_lse = plain(q, k, v, mask, seed, rate)
    assert torch.isfinite(out).all()
    assert (out - want_out).abs().max().item() <= F32_OUT
    assert (lse - want_lse).abs().max().item() <= F32_LSE


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("entry", ENTRIES)
def test_f32_reproduces_bitwise(entry, rate, cuda):
    q, k, v, mask = (t.to(cuda) for t in _inputs(2, 4, 1000, 2049 if entry == "k3" else 1500, seed=4))
    call = getattr(fa, ENTRIES[entry][0])
    seed = (3, 4) if rate else None
    first, second = (call(q, k, v, mask, seed, rate) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 130, 100), (1, 3, 64, 263), (2, 1, 200, 64)])
@pytest.mark.parametrize("entry", ENTRIES)
def test_f32_dropout_mask_read_off_exactly(entry, shape, cuda):
    """With v one-hot on a window of 64 keys, v[j, j - j0] = 1, out[i, j - j0] = P_ij D_ij / l_i: the mask of
    every window, exactly."""
    b, h, sq, sk = shape
    rate, seed = 0.1, (0xC0FFEE, sq * 1000 + sk)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(sk)
    q, k = (torch.randn(b, h, n, DH, device=cuda, generator=gen) for n in (sq, sk))
    call = getattr(fa, ENTRIES[entry][0])
    got = torch.zeros_like(want)
    for j0 in range(0, sk, TILE):
        n = min(TILE, sk - j0)
        v = torch.zeros(b, h, sk, DH, device=cuda)
        v[:, :, j0:j0 + n, :n] = torch.eye(n, device=cuda)
        got[..., j0:j0 + n] = call(q, k, v, None, seed, rate)[0][..., :n] > 0
    assert torch.equal(got, want)
