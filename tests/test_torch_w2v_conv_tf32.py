"""K6's f32 path: TF32 with error compensation (3xTF32) on the tensor cores,
restated in numpy and checked on the CPU; the kernel itself against its
plain version on a card.

The kernel splits every operand x into a TF32 high half hi = tf32(x) and a
low half lo = tf32(x - hi) (``cvt.rna.tf32.f32``: 10 stored mantissa bits,
the low 13 of the f32 pattern cleared, to nearest, ties away from zero),
forms lo_A hi_W + hi_A lo_W + hi_A hi_W per K slice of 32 in a fresh
accumulator and adds the slices in f32, those of a split in order and the
splits in order. Restated here at full
depth (K = 1,536 and 1,024, all 512 channels) and narrow T:

- within (2e-5, 2e-5) of ``conv_tail_reference`` (``chip_smoke.py``'s f32
  limit for K6, ``tests/test_w2v_conv_pallas.py:35``), over layer-0 lengths
  whose layers see odd and even frame counts, and with K split every layer;
- the control: one TF32 pass (hi_A hi_W alone) exceeds that limit, so the
  limit tells the two apart;
- the rounding of ``w2v_conv.tf32_round`` and the weight halves of
  ``split_tail_weights`` bit for bit.

The ``cuda`` legs skip here; on a machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_w2v_conv_tf32.py
"""

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import w2v_conv as wc

C = wc.CHANNELS
F32_TOL = (2e-5, 2e-5)  # (atol, rtol) of K6 in f32 against its plain version
F32_SLICE = 32  # k of an f32 ring stage: one 128-byte row
RESTATED_T0 = (79, 80, 141)  # every layer sees an odd and an even frame count over these; 79 ends in T_out = 1
WAVE_BUCKETS = (32000, 64000, 96000, 128000, 160000)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 ``a`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: half the 13 low bits' range added to the
    magnitude, then those bits dropped."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def _inputs(seed: int, clips: int, t0: int):
    """A layer-0 output (GELU of unit normals, as K7 gives) and the seeded model's weight scale N(0, 1 / fan_in)."""
    rng = np.random.default_rng(seed)
    x = torch.nn.functional.gelu(torch.from_numpy(rng.normal(size=(clips, t0, C)).astype(np.float32))).numpy()
    weights = [torch.from_numpy((rng.normal(size=(C, C, k)) / np.sqrt(k * C)).astype(np.float32))
               for k in wc.TAIL_TAPS]
    return x, weights


def _tail_restated(x: np.ndarray, weights, plan: wc.ConvPlan, three_pass: bool = True) -> np.ndarray:
    """K6's f32 algorithm in numpy: per layer the windows [T_out, k C] (rows of k C contiguous values from frame
    2 t), each K slice of 32 as its products into an f32 accumulator, the slices of a split in order, the splits
    added in order, then the exact GELU. ``three_pass`` False: hi_A hi_W alone (one TF32 pass)."""
    w3, w2 = (w.numpy() for w in wc.stack_tail_weights(weights, torch.float32))
    gelu = lambda v: torch.nn.functional.gelu(torch.from_numpy(v)).numpy()
    for layer, (taps, (_, splits)) in enumerate(zip(wc.TAIL_TAPS, plan.tail)):
        w = w3[layer] if layer < 4 else w2[layer - 4]  # [512, K]
        b, t_in, _ = x.shape
        t_out = wc.conv_out_length(t_in, taps, 2)
        a = np.stack([x[:, 2 * t: 2 * t + taps].reshape(b, taps * C) for t in range(t_out)], 1)
        a = a.reshape(b * t_out, taps * C)
        a_hi, w_hi = _tf32(a), _tf32(w)
        a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
        k_slices = taps * C // F32_SLICE
        total = np.zeros((b * t_out, C), np.float32)
        for split in range(splits):
            part = np.zeros_like(total)
            for s in range(split * k_slices // splits, (split + 1) * k_slices // splits):
                cols = slice(s * F32_SLICE, (s + 1) * F32_SLICE)
                stage = a_hi[:, cols] @ w_hi[:, cols].T
                if three_pass:  # the slice's products in a fresh accumulator, the small terms first
                    stage = a_lo[:, cols] @ w_hi[:, cols].T + a_hi[:, cols] @ w_lo[:, cols].T + stage
                part += stage
            total += part
        x = gelu(total).reshape(b, t_out, C)
    return x


def _excess(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| beyond atol + rtol |want| (<= 0 passes)."""
    return float((np.abs(got - want) - F32_TOL[0] - F32_TOL[1] * np.abs(want)).max())


@pytest.fixture(scope="module")
def restated():
    """Per layer-0 length: (three-pass restatement, one-pass restatement, plain version) at batch 2."""
    out = {}
    for t0 in RESTATED_T0:
        x, weights = _inputs(t0, 2, t0)
        plan = wc.conv_plan(2, t0)
        want = wc.conv_tail_reference(torch.from_numpy(x), weights).numpy()
        out[t0] = (_tail_restated(x, weights, plan), _tail_restated(x, weights, plan, three_pass=False), want)
    return out


def test_tf32_rounding_is_cvt_rna():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-20, 20, 4000),
                        [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 - 2 ** -12, 0.0, -0.0]]).astype(np.float32)
    hi = _tf32(x)
    assert np.array_equal(hi.view(np.int32) & 0x1FFF, np.zeros(len(x), np.int32))
    assert np.all(np.abs(x - hi) <= 2.0 ** -11 * np.abs(x))  # to nearest: half a TF32 step
    assert list(hi[-6:-2]) == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0]  # ties away from zero
    lo = _tf32(x - hi)
    assert np.all(np.abs(x - hi - lo) <= 2.0 ** -22 * np.abs(x))  # the pair holds x to 2^-22
    assert np.array_equal(wc.tf32_round(torch.from_numpy(x)).numpy().view(np.int32), hi.view(np.int32))


def test_split_weights_are_the_tf32_halves_of_the_stacked_weights():
    _, weights = _inputs(3, 1, 9)
    for halves, stacked in zip(wc.split_tail_weights(weights), wc.stack_tail_weights(weights, torch.float32)):
        assert halves.dtype == torch.float32 and tuple(halves.shape) == (2, *stacked.shape)
        hi = _tf32(stacked.numpy())
        assert np.array_equal(halves[0].numpy(), hi)
        assert np.array_equal(halves[1].numpy(), _tf32(stacked.numpy() - hi))


@pytest.mark.parametrize("t0", RESTATED_T0)
def test_three_pass_restated_matches_plain_version(restated, t0):
    got, _, want = restated[t0]
    assert got.shape == want.shape == (2, wc.tail_lengths(t0)[-1], C)
    assert _excess(got, want) <= 0


def test_three_pass_restated_with_k_split_every_layer():
    t0 = 141
    x, weights = _inputs(6, 1, t0)
    plan = wc.ConvPlan(32, tuple((1, s) for s in (5, 3, 12, 7, 2, 8)))
    want = wc.conv_tail_reference(torch.from_numpy(x), weights).numpy()
    assert _excess(_tail_restated(x, weights, plan), want) <= 0


@pytest.mark.parametrize("t0", RESTATED_T0)
def test_one_tf32_pass_exceeds_the_limit(restated, t0):
    three, one, want = restated[t0]
    assert _excess(one, want) > 0
    assert np.abs(one - want).max() > 10 * np.abs(three - want).max()


# -- on a card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel K6 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(clips: int, t0: int, device, seed: int):
    x, weights = _inputs(seed, clips, t0)
    return torch.from_numpy(x).to(device), [w.to(device) for w in weights]


@pytest.mark.cuda
@pytest.mark.parametrize("clips, t0", [(b, wc.conv_out_length(n, wc.L0_TAPS, wc.L0_STRIDE)) for b in (2, 16, 32)
                                       for n in WAVE_BUCKETS] + [(2, 8000), (3, 209), (1, 79)])
def test_f32_kernel_matches_plain_version_at_every_plan(cuda, clips, t0):
    x, weights = _card_case(clips, t0, cuda, seed=clips + t0)
    before = wc.conv_stack_fused.launches
    got = wc.conv_stack_fused(x, weights)
    torch.cuda.synchronize()
    assert wc.conv_stack_fused.launches == before + 1
    torch.testing.assert_close(got, wc.conv_tail_reference(x, weights), atol=F32_TOL[0], rtol=F32_TOL[1])


@pytest.mark.cuda
@pytest.mark.parametrize("clips, t0", [(2, 6399), (32, 31999), (3, 209)])
def test_f32_two_calls_give_the_same_bits(cuda, clips, t0):
    x, weights = _card_case(clips, t0, cuda, seed=5)
    assert torch.equal(wc.conv_stack_fused(x, weights), wc.conv_stack_fused(x, weights))
