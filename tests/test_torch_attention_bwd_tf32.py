"""K4's f32 backward at head dim 64: TF32 with error compensation (3xTF32) on
``wgmma``, restated on the CPU; the kernel against its plain version on a card.

The design (``csrc/flash_attention_tiled_bwd.cu``, ``mer_k4_tf32``): a prep
pass writes per query row lse in log2 units (+inf on a fully masked row, whose
P is 1/Sk), delta = rowsum(g o out) - g_lse and that probability, per key its
bias in log2 units (-1e30 log2 e on ignored and padding keys), and the TF32
halves x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (``cvt.rna.tf32.f32``) of
q, g, K and V as they lie and of q^T, g^T and K^T, the transposes' reduction
index (rows or keys) permuted inside each group of 8 (position p holds 2 (p &
3) + (p >> 2)), all zero past Sq and Sk. Then a dq kernel per 64 query rows
walks the 64-key tiles: S = q K^T and dP = g V^T as lo hi + hi lo + hi hi (the
small terms first), P, D and dS where the accumulator holds them, dS split
into halves in registers, and dS K^T into a fresh accumulator added to dq in
f32. A dk/dv kernel per 64 keys walks the 64-row tiles: S^T = K q^T, dP^T = V
g^T, (P o D)^T and dS^T, and (P o D)^T g^T and dS^T q^T each into a fresh
accumulator added to dV and dK. TF32 ``wgmma`` takes its A operand from
registers in columns t and t + 4 of lane (g, t); the accumulator gives that
lane columns 8 j + 2 t and + 1: the permutation lines them up.

On the CPU, that algorithm restated (``_restated``) with its splits,
permutations and per-tile accumulation, at ragged Sk, Sq != Sk, with a key
mask, a fully masked batch element, dropout 0.1, and ``g_lse`` present and
absent:

- in float64 arithmetic against ``flash_attention_tiled_backward_reference``
  in float64, to the size of the dropped lo lo terms;
- in float32 within the card's f32 backward limit (1e-4, 1e-5;
  ``chip_smoke.py``'s ``TOL["bwd", "float32"]``) of the f32 plain version, and
  of ``mer_tpu``'s ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` in interpret
  mode (no fully masked element: ``mer_tpu`` takes P = 1 there);
- the control: one TF32 pass (hi hi alone) misses that limit;
- lane by lane, every transposed and permuted operand gives its product
  exactly; the scratch holds the layout the C entry cuts it into.

On the card (``cuda`` marker): the kernel against its plain version at Dh 64
(the 3xTF32 route) and Dh 50 (the template), the route recorded by the C
entry, the same bits from two calls, and the dropout mask read off exactly::

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bwd_tf32.py
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
F32_BWD = (1e-4, 1e-5)  # chip_smoke.py's TOL["bwd", "float32"]: (atol, rtol)
PERM = [2 * (p & 3) + (p >> 2) for p in range(8)]  # the row or key at position p of a group of 8 in a transpose
# (B, H, Sq, Sk): ragged key and row tiles with Sq < Sk, Sq > Sk, one tile each, the text step's rows in two tiles
CASES = [(2, 2, 100, 301), (2, 1, 300, 70), (1, 2, 64, 64), (2, 2, 130, 130)]
# (fully masked batch element, dropout rate, g_lse)
VARIANTS = [(False, 0.0, False), (True, 0.0, True), (False, 0.1, True), (True, 0.1, False)]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pad(n: int) -> int:
    return -(-n // TILE) * TILE


def _inputs(b, h, sq, sk, seed=0, fully_masked=False, with_g_lse=True):
    """f32 q, k, v, g of unit variance over 3 (the main path's scale), g_lse or None, and clip masks: element b
    keeps its first L_b >= Sk / 2 keys less a scattered 10%, key 0 always, or with ``fully_masked`` element 0
    ignores every key."""
    rng = np.random.default_rng(seed)
    q, k, v, g = ((rng.normal(size=(b, h, n, DH)) / math.sqrt(3)).astype(np.float32) for n in (sq, sk, sk, sq))
    g_lse = rng.normal(size=(b, h, sq)).astype(np.float32)
    lengths = rng.integers(sk // 2, sk + 1, b)
    mask = (np.arange(sk)[None, :] >= lengths[:, None]) | (rng.random((b, sk)) < 0.1)
    mask[:, 0] = False
    if fully_masked:
        mask[0] = True
    q, k, v, g, g_lse, mask = (torch.from_numpy(a) for a in (q, k, v, g, g_lse, mask))
    return q, k, v, g, (g_lse if with_g_lse else None), mask


@pytest.fixture(scope="module")
def cases():
    """Per (case, variant): the backward's inputs with the f32 forward's out and lse, made once."""
    made = {}
    for case in CASES:
        for variant in VARIANTS:
            fully_masked, rate, with_g_lse = variant
            q, k, v, g, g_lse, mask = _inputs(*case, seed=sum(case), fully_masked=fully_masked,
                                              with_g_lse=with_g_lse)
            seed = SEED if rate else None
            out, lse = fa.flash_attention_reference(q, k, v, mask, seed, rate)
            made[case, variant] = (q, k, v, mask, out, lse, g, seed, rate, g_lse)
    return made


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 x as TF32 halves: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _positions(n: int) -> torch.Tensor:
    """Row or key of each position of n (a multiple of 8) whose groups of 8 are permuted as the transposes hold
    them."""
    return torch.arange(n).view(-1, 8)[:, PERM].reshape(-1)


def _transposed(x: torch.Tensor) -> torch.Tensor:
    """[.., n, 64] as the prep pass writes its transpose: [.., 64, n positions], n padded to 64."""
    return x.transpose(-1, -2)[..., _positions(x.shape[-2])]


def _prep(q, k, v, mask, out, lse, g, g_lse):
    """The prep pass: key biases [B, Sk pad] in log2 units, the rows' (lse log2 e or +inf, delta, fully-masked
    probability) [B, H, Sq pad] (zero on padding rows), and the f32 q, g, K, V zero-padded to 64 rows."""
    b, _, sq, _ = q.shape
    sk = k.shape[2]
    bias = torch.full((b, _pad(sk)), fa.NEG_INF, dtype=torch.float32)
    bias[:, :sk] = torch.where(mask, torch.tensor(fa.NEG_INF, dtype=torch.float32), 0.0)
    bias = bias * torch.tensor(LOG2E, dtype=torch.float32)
    delta = (g * out).sum(-1) - (g_lse if g_lse is not None else 0.0)
    fully = lse < fa.FULLY_MASKED_LSE
    lse2 = torch.where(fully, float("inf"), lse * torch.tensor(LOG2E, dtype=torch.float32))
    rows = lambda x: torch.nn.functional.pad(x, (0, _pad(sq) - sq))
    stats = rows(lse2), rows(delta), rows(torch.where(fully, 1.0 / sk, 0.0))
    padded = [torch.nn.functional.pad(t, (0, 0, 0, _pad(t.shape[2]) - t.shape[2])) for t in (q, g, k, v)]
    return bias, stats, padded


def _product(a_halves, b_halves, eq: str, acc, passes: int):
    """lo_a hi_b + hi_a lo_b + hi_a hi_b (the small terms first), or hi hi alone with ``passes`` 1, in ``acc``."""
    (a_hi, a_lo), (b_hi, b_lo) = a_halves, b_halves
    total = None
    for x, y in [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - passes:]:
        term = torch.einsum(eq, x.to(acc), y.to(acc))
        total = term if total is None else total + term
    return total


def _restated(q, k, v, mask, out, lse, g, seed=None, rate=0.0, g_lse=None, acc=torch.float32, passes=3):
    """The f32 design tile by tile on f32 inputs, with its splits, in ``acc`` arithmetic; ``passes`` 1 keeps hi
    hi alone (one TF32 pass). Returns (dq, dk, dv) in ``acc``."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    bias, (lse2, delta, fully), (qp, gp, kp, vp) = _prep(q, k, v, mask, out, lse, g, g_lse)
    bias, lse2, delta, fully = (t.to(acc) for t in (bias, lse2, delta, fully))
    q2, g2, k2, v2 = (_split(t) for t in (qp, gp, kp, vp))
    qt2, gt2, kt2 = (_split(_transposed(t)) for t in (qp, gp, kp))
    scale = 1.0 / math.sqrt(DH)
    c_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32).to(acc)
    factor = (fa.dropout_factor(seed, (b, h, _pad(sq), _pad(sk)), rate) if rate
              else torch.ones(b, h, _pad(sq), _pad(sk))).to(acc)
    order = _positions(TILE)
    keys = lambda halves, k0: tuple(t[:, :, k0:k0 + TILE] for t in halves)
    cols = lambda halves, k0: tuple(t[..., k0:k0 + TILE] for t in halves)
    # the dq kernel: 64-key tiles; P, D and dS [b, h, rows, keys]
    dq = torch.zeros(b, h, _pad(sq), DH, dtype=acc)
    for k0 in range(0, _pad(sk), TILE):
        s = _product(q2, keys(k2, k0), "bhqd,bhkd->bhqk", acc, passes)
        dp = _product(g2, keys(v2, k0), "bhqd,bhkd->bhqk", acc, passes)
        p = torch.exp2(s * c_log2 + bias[:, None, None, k0:k0 + TILE] - lse2[..., None]) + fully[..., None]
        ds = p * (dp * factor[..., k0:k0 + TILE] - delta[..., None])
        # the A fragments: k-step j's columns are keys 8 j + PERM, as K^T's positions are
        dq = dq + _product(_split(ds[..., order].float()), cols(kt2, k0), "bhqk,bhdk->bhqd", acc, passes)
    # the dk/dv kernel: 64-row tiles; (P o D)^T and dS^T [b, h, keys, rows]
    dk = torch.zeros(b, h, _pad(sk), DH, dtype=acc)
    dv = torch.zeros_like(dk)
    for r0 in range(0, _pad(sq), TILE):
        st = _product(k2, keys(q2, r0), "bhkd,bhqd->bhkq", acc, passes)
        dpt = _product(v2, keys(g2, r0), "bhkd,bhqd->bhkq", acc, passes)
        rows = slice(r0, r0 + TILE)
        pt = torch.exp2(st * c_log2 + bias[:, None, :, None] - lse2[:, :, None, rows]) + fully[:, :, None, rows]
        f = factor[:, :, rows].transpose(2, 3)
        dst = pt * (dpt * f - delta[:, :, None, rows])
        dv = dv + _product(_split((pt * f)[..., order].float()), cols(gt2, r0), "bhkq,bhdq->bhkd", acc, passes)
        dk = dk + _product(_split(dst[..., order].float()), cols(qt2, r0), "bhkq,bhdq->bhkd", acc, passes)
    return (dq * scale)[:, :, :sq], (dk * scale)[:, :, :sk], dv[:, :, :sk]


def _excess(got, want, limit=F32_BWD) -> float:
    """Largest |got - want| beyond atol + rtol |want| (<= 0 passes)."""
    return ((got.double() - want.double()).abs() - limit[0] - limit[1] * want.double().abs()).max().item()


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"masked{int(v[0])}-rate{v[1]}-glse{int(v[2])}")
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_restated_in_f64_matches_reference_f64(cases, case, variant):
    """In float64 arithmetic on the kernel's TF32 halves the design is the plain version's function but for the
    dropped lo lo terms (2^-22 of a product) and the f32 constants (scale log2 e): within 1e-6."""
    q, k, v, mask, out, lse, g, seed, rate, g_lse = cases[case, variant]
    got = _restated(q, k, v, mask, out, lse, g, seed, rate, g_lse, acc=torch.float64)
    f64 = lambda t: None if t is None else t.double()
    want = fa.flash_attention_tiled_backward_reference(f64(q), f64(k), f64(v), mask, f64(out), f64(lse), f64(g),
                                                       seed, rate, f64(g_lse))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"masked{int(v[0])}-rate{v[1]}-glse{int(v[2])}")
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_restated_f32_within_the_card_limit_of_the_plain_version(cases, case, variant):
    """In f32 the design lies within the card's f32 backward limit (1e-4, 1e-5) of the f32 plain version."""
    q, k, v, mask, out, lse, g, seed, rate, g_lse = cases[case, variant]
    got = _restated(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    want = fa.flash_attention_tiled_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    assert max(_excess(a, w) for a, w in zip(got, want)) <= 0


def test_fully_masked_rows_and_padding():
    """A fully masked row takes P = 1/Sk (its stats row: lse +inf, 1/Sk); padding keys have the mask bias,
    padding rows zero statistics; the halves are zero past Sq and Sk."""
    q, k, v, g, g_lse, mask = _inputs(2, 2, 70, 100, seed=4, fully_masked=True)
    out, lse = fa.flash_attention_reference(q, k, v, mask)
    bias, (lse2, delta, fully), (qp, gp, kp, vp) = _prep(q, k, v, mask, out, lse, g, g_lse)
    assert torch.isinf(lse2[0, :, :70]).all() and torch.all(fully[0, :, :70] == 1.0 / 100)
    assert torch.isfinite(lse2[1]).all() and not fully[1].any()
    assert not lse2[:, :, 70:].any() and not delta[:, :, 70:].any() and not fully[:, :, 70:].any()
    assert torch.all(bias[:, 100:] == torch.tensor(fa.NEG_INF, dtype=torch.float32) * LOG2E)
    assert not any(t[:, :, n:].any() for t, n in ((qp, 70), (gp, 70), (kp, 100), (vp, 100)))
    dq, dk, dv = _restated(q, k, v, mask, out, lse, g, g_lse=g_lse)
    want = fa.flash_attention_tiled_backward_reference(q, k, v, mask, out, lse, g, g_lse=g_lse)
    assert max(_excess(a, w) for a, w in zip((dq, dk, dv), want)) <= 0
    # element 0 spreads P = 1/Sk over every key: its dv is the rows' mean of g
    torch.testing.assert_close(dv[0], g[0].sum(1, keepdim=True).expand_as(dv[0]) / 100, atol=1e-6, rtol=0)


def test_one_tf32_pass_exceeds_the_f32_limit():
    """The control: hi hi alone (one TF32 pass, 2^-11 of each product kept) misses the f32 limit that three
    passes meet. Its error grows with the reduction's length and the values' size: dK and dV sum every query
    row, here 2,048 rows over one key tile (dv up to 2.3; one pass is off by 7e-4 there, three by 1.4e-6). At
    the f32 text step's [2, 12, 256, 256] one pass stays just inside (9.3e-5 on dv)."""
    q, k, v, g, g_lse, mask = _inputs(1, 2, 2048, 64, seed=9)
    out, lse = fa.flash_attention_reference(q, k, v, mask)
    want = fa.flash_attention_tiled_backward_reference(q, k, v, mask, out, lse, g, g_lse=g_lse)
    excess = lambda passes: max(_excess(a, w) for a, w in zip(
        _restated(q, k, v, mask, out, lse, g, g_lse=g_lse, passes=passes), want))
    assert excess(3) <= 0 < excess(1)


def _lane_product(x: torch.Tensor, y_t: torch.Tensor) -> torch.Tensor:
    """One warpgroup's 64 x 64 accumulator x (rows of the product, columns its reduction index) as the A operand
    of eight k-steps, lane by lane, against a B operand [64 columns][64 positions] that holds y's transpose with
    the positions permuted: lane (g, t) of warp w holds x[16 w + g + 8 h, 8 j + 2 t + c] at d[4 j + 2 h + c]; as
    k-step j's a[r] = d[4 j + 2 (r & 1) + (r >> 1)] it fills A's row 16 w + g + 8 (r & 1), column t + 4 (r >> 1)
    (tf32 wgmma's register layout), and B's k-step j is positions 8 j .. 8 j + 7. Each A element is written
    once."""
    d = torch.zeros(TILE, y_t.shape[0], dtype=torch.float64)
    for j in range(8):
        a = torch.full((TILE, 8), float("nan"), dtype=torch.float64)
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                held = {4 * j + 2 * hh + c: x[16 * w + g + 8 * hh, 8 * j + 2 * t + c]
                        for hh in range(2) for c in range(2)}
                for r in range(4):
                    row, col = 16 * w + g + 8 * (r & 1), t + 4 * (r >> 1)
                    assert math.isnan(a[row, col])
                    a[row, col] = held[4 * j + 2 * (r & 1) + (r >> 1)]
        assert not a.isnan().any()
        d += a @ y_t[:, 8 * j:8 * j + 8].t()  # B [64 x 8] K-major: the transpose's rows, this k-step's positions
    return d


@pytest.mark.parametrize("product", ["dq = dS K", "dV = (P o D)^T g", "dK = dS^T q"])
def test_permuted_transposes_give_each_product_exactly(product):
    """Lane by lane: dS (rows x keys) against K^T, (P o D)^T and dS^T (keys x rows) against g^T and q^T, each
    transpose as the prep pass writes it (``_transposed``), give the product exactly (small integers: no
    rounding)."""
    rng = np.random.default_rng(len(product))
    x = torch.from_numpy(rng.integers(-8, 9, (TILE, TILE)).astype(np.float64))  # dS, (P o D)^T or dS^T
    y = torch.from_numpy(rng.integers(-8, 9, (TILE, DH)).astype(np.float64))  # K, g or q: [reduction][64]
    assert torch.equal(_lane_product(x, _transposed(y)), x @ y)


def test_tiled_scratch_holds_the_halves():
    """The f32 route's scratch: statistics, biases, keep bits as the bf16 design's, then 14 arrays of halves, each
    at a 16-byte aligned offset (TMA's base alignment) with 256-byte rows."""
    b, h, sq, sk = 16, 12, 256, 256
    bh, base = b * h, 3 * 16 * 12 * 256 + 16 * 256
    assert fa.tiled_scratch_numel(b, h, sq, sk, False, True) == base + 14 * bh * 256 * 64
    assert fa.tiled_scratch_numel(b, h, sq, sk, True, True) == base + bh * 256 * 256 // 32 + 14 * bh * 256 * 64
    assert fa.tiled_scratch_numel(b, h, sq, sk, True) == base + bh * 256 * 256 // 32  # bf16: no halves
    for b, h, sq, sk, drop in [(2, 12, 4499, 4499, True), (1, 1, 1, 65, False), (3, 2, 70, 130, True)]:
        bh, sqp, skp = b * h, _pad(sq), _pad(sk)
        head = 3 * bh * sqp + b * skp + (bh * sqp * skp // 32 if drop else 0)
        offsets = [head, head + 4 * bh * sqp * 64, head + 8 * bh * sqp * 64, head + 8 * bh * sqp * 64 + 4 * bh * skp * 64]
        assert all(o % 4 == 0 for o in offsets) and (sqp * 4) % 16 == 0 and (skp * 4) % 16 == 0
        assert fa.tiled_scratch_numel(b, h, sq, sk, drop, True) == offsets[3] + 2 * bh * skp * 64


@pytest.fixture(scope="module")
def jax_tiled():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_bwd_tiled

    def backward(q, k, v, mask, out, lse, g, g_lse):
        bias = jnp.where(jnp.asarray(mask), _NEG_INF, 0.0).astype(jnp.float32)
        grads = _flash_bwd_tiled(*(jnp.asarray(a.numpy()) for a in (q, k, v)), bias, jnp.asarray(out.numpy()),
                                 jnp.asarray(lse.numpy()), jnp.asarray(g.numpy()), True,
                                 g_lse=None if g_lse is None else jnp.asarray(g_lse.numpy()))
        return [torch.from_numpy(np.array(x)) for x in grads]

    return backward


@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("case", [(2, 2, 100, 301), (1, 2, 300, 130)], ids=lambda c: "x".join(map(str, c)))
def test_restated_matches_mer_tpu_kernels_interpret(jax_tiled, case, with_g_lse):
    """f32: the design against the TPU's ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` (``_flash_bwd_tiled`` in
    interpret mode), within the card's f32 backward limit. (No fully masked element: ``mer_tpu``'s tiled
    backward takes P = 1 there, the port 1/Sk; no dropout: ``mer_tpu``'s takes none.)"""
    q, k, v, g, g_lse, mask = _inputs(*case, seed=11, with_g_lse=with_g_lse)
    out, lse = fa.flash_attention_reference(q, k, v, mask)
    want = jax_tiled(q, k, v, mask, out, lse, g, g_lse)
    got = _restated(q, k, v, mask, out, lse, g, g_lse=g_lse)
    assert max(_excess(a, w) for a, w in zip(got, want)) <= 0


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the 3xTF32 backward has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(case, variant, device, dh=DH):
    """The inputs of ``cases`` at any head dim and size, made on the CPU and moved; out and lse from the f32
    forward kernel."""
    fully_masked, rate, with_g_lse = variant
    b, h, sq, sk = case
    rng = np.random.default_rng(sum(case))
    q, k, v, g = (torch.from_numpy((rng.normal(size=(b, h, n, dh)) / math.sqrt(3)).astype(np.float32)).to(device)
                  for n in (sq, sk, sk, sq))
    g_lse = torch.from_numpy(rng.normal(size=(b, h, sq)).astype(np.float32)).to(device) if with_g_lse else None
    lengths = rng.integers(sk // 2, sk + 1, b)
    mask = (np.arange(sk)[None, :] >= lengths[:, None]) | (rng.random((b, sk)) < 0.1)
    mask[:, 0] = False
    if fully_masked:
        mask[0] = True
    mask = torch.from_numpy(mask).to(device)
    seed = SEED if rate else None
    out, lse = fa.flash_attention_forward(q, k, v, mask, seed, rate)
    return q, k, v, mask, out, lse, g, seed, rate, g_lse


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"masked{int(v[0])}-rate{v[1]}-glse{int(v[2])}")
@pytest.mark.parametrize("case, dh", [((16, 12, 256, 256), 64), ((2, 1, 2049, 2049), 64), ((2, 1, 8192, 8192), 64),
                                      ((2, 12, 4499, 4499), 64), ((4, 12, 149, 149), 64), ((2, 2, 300, 1000), 64),
                                      ((2, 2, 1000, 300), 64), ((2, 3, 65, 40), 64), ((2, 1, 2049, 2049), 50)],
                         ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else f"dh{c}")
def test_f32_matches_plain_version_and_takes_its_route(case, dh, variant, cuda):
    """K4 in f32 against its plain version within (1e-4, 1e-5): at Dh 64 through the 3xTF32 route, at Dh 50
    through the template; one launch a call, the route the C entry recorded."""
    args = _card_case(case, variant, cuda, dh)
    routes, before = dict(fa.flash_attention_tiled_backward.routes), fa.flash_attention_tiled_backward.launches
    got = fa.flash_attention_tiled_backward(*args)
    torch.cuda.synchronize()
    route = "wgmma_tf32" if dh == 64 else "template"
    assert fa.flash_attention_tiled_backward.launches == before + 1
    assert fa.flash_attention_tiled_backward.routes == {**routes, route: routes[route] + 1}
    want = fa.flash_attention_tiled_backward_reference(*args)
    assert all(torch.isfinite(a).all() for a in got)
    assert max(_excess(a, w) for a, w in zip(got, want)) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_reproduces_bitwise(rate, cuda):
    args = _card_case((2, 4, 1000, 1500), (True, rate, True), cuda)
    first, second = (fa.flash_attention_tiled_backward(*args) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 130, 100), (1, 3, 64, 263), (2, 1, 200, 64)])
def test_f32_dropout_mask_read_off_exactly(shape, cuda):
    """With g one-hot on a window of 64 query rows, g[i, i - i0] = 1, dv[j, i - i0] = P_ij D_ij: the mask of every
    window, exactly (the dk/dv kernel reads the keep bits the dq kernel wrote)."""
    b, h, sq, sk = shape
    rate, seed = 0.1, (0xC0FFEE, sq * 1000 + sk)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, cuda) > 0
    gen = torch.Generator(device=cuda).manual_seed(sk)
    q, k, v = (torch.randn(b, h, n, DH, device=cuda, generator=gen) for n in (sq, sk, sk))
    out, lse = fa.flash_attention_forward(q, k, v, None, seed, rate)
    got = torch.zeros_like(want)
    for i0 in range(0, sq, TILE):
        n = min(TILE, sq - i0)
        g = torch.zeros(b, h, sq, DH, device=cuda)
        g[:, :, i0:i0 + n, :n] = torch.eye(n, device=cuda)
        dv = fa.flash_attention_tiled_backward(q, k, v, None, out, lse, g, seed, rate)[2]
        got[:, :, i0:i0 + n] = dv[..., :n].transpose(2, 3) > 0
    assert torch.equal(got, want)
