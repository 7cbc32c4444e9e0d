"""K6's and K7's tiling (``mer_tpu_torch.ops.w2v_conv.conv_plan``) and the
operand plan of K6's Hopper path, restated in numpy and checked on the CPU;
the kernels themselves against their plain versions on a card.

CPU (no card needed):

- K6's operand plan restated: every layer's A operand gathered as the
  kernel's TMA boxes gather it (pair rows [floor(T / 2)][1,024] for taps 0
  and 1, even frames [ceil(T / 2)][512] for tap 2, zeros where a box leaves
  a map), multiplied by the stacked weights K slice by K slice, the slices
  added per split and the splits in order, as the plan tiles each layer:
  within 1e-5 of ``conv_tail_reference`` in f32, over layer-0 lengths whose
  layers see odd and even frame counts each and a layer whose T_out is 1;
- the plan fills the card: every layer's grid has at least 132 blocks or
  runs on the smallest tile, at every wave bucket at batch 2, 16 and 32;
- no planned box reads outside its clip, and the split-K scratch covers
  every split layer;
- K7's tiles cover exactly T0 frames, and its statistics restated (window
  moments per tile in f64, added in tile order, each channel's mean and
  E[y^2] as a quadratic form) match ``layer0_gn_reference``.

The ``cuda`` legs skip here; on a machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_w2v_conv_tma.py
"""

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import w2v_conv as wc

C = wc.CHANNELS
PAIR_COLS = 2 * C
SLICE = wc.TAIL_K_SLICE
BN = wc.TAIL_TILE_CHANNELS
W2V_BF16_REL = 2e-2  # K6 and K7 in bf16: |err| <= this x the plain version's largest value (chip_smoke.py's)
WAVE_BUCKETS = (32000, 64000, 96000, 128000, 160000)  # data/wav2vec2_fe.py's SECONDS_BUCKETS at 16 kHz
LONG_BUCKETS = (960000, 1440000)  # the 60 and 90 s buckets of the long-clip path (batch 2)
# layer-0 lengths whose six layers see an odd and an even frame count each, ending in T_out = 1, and one whose
# first layers span several 128-row tiles
RESTATED_T0 = (79, 80, 141, 611)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t0(n_samples: int) -> int:
    return wc.conv_out_length(n_samples, wc.L0_TAPS, wc.L0_STRIDE)


def _a_maps(x: np.ndarray) -> dict[str, np.ndarray]:
    """K6's two TMA views of a layer input x [B, T, 512]: pair rows [B, floor(T / 2), 1,024] (frames 2 p and
    2 p + 1) and even frames [B, ceil(T / 2), 512] (frame 2 p)."""
    b, t, _ = x.shape
    return {"pairs": x[:, : 2 * (t // 2)].reshape(b, t // 2, PAIR_COLS), "even": x[:, 0::2]}


def _box(k0: int, m0: int) -> tuple[str, int, int]:
    """The box of K slice k0 for output rows m0 ..: (map, first column, first row)."""
    return ("pairs", k0, m0) if k0 < PAIR_COLS else ("even", k0 - PAIR_COLS, m0 + 1)


def _tma_load(view: np.ndarray, clip: int, col: int, row: int, rows: int) -> np.ndarray:
    """A [rows, 64] box of ``view`` at (col, row) of one clip, zeros where it leaves the view (as TMA fills)."""
    out = np.zeros((rows, SLICE), view.dtype)
    got = view[clip, row: row + rows, col: col + SLICE]
    out[: len(got)] = got
    return out


def _tail_restated(x: np.ndarray, weights, plan: wc.ConvPlan) -> np.ndarray:
    """K6's bf16 algorithm in f32 numpy, tile by tile as ``plan`` cuts each layer."""
    w3, w2 = (w.numpy() for w in wc.stack_tail_weights(weights, torch.float32))
    gelu = lambda v: torch.nn.functional.gelu(torch.from_numpy(v)).numpy()
    for layer, (taps, (warpgroups, splits)) in enumerate(zip(wc.TAIL_TAPS, plan.tail)):
        w = w3[layer] if layer < 4 else w2[layer - 4]  # [512, K]
        b, t_in, _ = x.shape
        t_out = wc.conv_out_length(t_in, taps, 2)
        bm, k_slices = 64 * warpgroups, taps * C // SLICE
        views = _a_maps(x)
        out = np.zeros((b, t_out, C), np.float32)
        for clip in range(b):
            for m0 in range(0, t_out, bm):
                for n0 in range(0, C, BN):
                    total = np.zeros((bm, BN), np.float32)
                    for split in range(splits):  # each split's slices, then the splits in order
                        part = np.zeros((bm, BN), np.float32)
                        for s in range(split * k_slices // splits, (split + 1) * k_slices // splits):
                            name, col, row = _box(s * SLICE, m0)
                            a = _tma_load(views[name], clip, col, row, bm)
                            part += a @ w[n0: n0 + BN, s * SLICE: (s + 1) * SLICE].T
                        total += part
                    rows = min(bm, t_out - m0)
                    out[clip, m0: m0 + rows, n0: n0 + BN] = gelu(total)[:rows]
        x = out
    return x


def _tail_weights(seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(C, C, k)) / np.sqrt(k * C)).astype(np.float32)) for k in wc.TAIL_TAPS]


def test_restated_lengths_cover_odd_and_even_inputs_at_every_layer():
    seen = {(i, t % 2) for t0 in RESTATED_T0 for i, t in enumerate([t0] + wc.tail_lengths(t0)[:-1])}
    assert seen == {(i, p) for i in range(6) for p in (0, 1)}
    assert any(1 in wc.tail_lengths(t0) for t0 in RESTATED_T0)
    assert any(wc.tail_lengths(t0)[0] > 128 for t0 in RESTATED_T0)


@pytest.mark.parametrize("t0", RESTATED_T0)
def test_operand_plan_restated_matches_plain_version(t0):
    rng = np.random.default_rng(t0)
    x = rng.normal(size=(2, t0, C)).astype(np.float32)
    weights = _tail_weights(t0 + 1)
    plan = wc.conv_plan(2, t0)
    got = _tail_restated(x, weights, plan)
    want = wc.conv_tail_reference(torch.from_numpy(x), weights).numpy()
    assert got.shape == want.shape == (2, wc.tail_lengths(t0)[-1], C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_split_k_restated_matches_plain_version():
    """A plan that splits every layer K ways, as the short layers of a batch-2 call are split."""
    t0 = 141
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, t0, C)).astype(np.float32)
    weights = _tail_weights(6)
    plan = wc.ConvPlan(32, tuple((1, s) for s in (5, 3, 12, 7, 2, 8)))
    np.testing.assert_allclose(_tail_restated(x, weights, plan),
                               wc.conv_tail_reference(torch.from_numpy(x), weights).numpy(), rtol=1e-5, atol=1e-5)


def _calls():
    """(clips, layer-0 frames) of every main-path call size: each wave bucket at the export batch 32, the
    fine-tuning batch 16 and the evaluation batch 2, and the long buckets at batch 2."""
    calls = [(b, _t0(n)) for b in (2, 16, 32) for n in WAVE_BUCKETS]
    return calls + [(2, _t0(n)) for n in LONG_BUCKETS]


@pytest.mark.parametrize("clips, t0", _calls())
def test_plan_fills_the_card(clips, t0):
    plan = wc.conv_plan(clips, t0)
    assert len(plan.tail) == 6
    smallest = wc.TAIL_TILES[-1]
    for taps, t_out, (warpgroups, splits) in zip(wc.TAIL_TAPS, wc.tail_lengths(t0), plan.tail):
        assert warpgroups in wc.TAIL_TILES and 1 <= splits <= taps * C // SLICE // 2
        blocks = wc.tail_blocks(clips, t_out, warpgroups, splits)
        assert blocks >= wc.SMS or warpgroups == smallest, (t_out, plan)
        if splits > 1:  # split only what the smallest tile leaves under one block per SM, no further than needed
            assert warpgroups == smallest
            assert wc.tail_blocks(clips, t_out, smallest, splits - 1) < wc.SMS
        if warpgroups != wc.TAIL_TILES[0]:  # the wide tile was too few blocks
            assert wc.tail_blocks(clips, t_out, wc.TAIL_TILES[0]) < wc.SMS
    tile = plan.l0_tile
    assert tile in wc.L0_TILES
    assert clips * -(-t0 // tile) >= wc.L0_BLOCKS_PER_SM * wc.SMS or tile == wc.L0_TILES[-1]


@pytest.mark.parametrize("clips, t0", _calls() + [(3, 209), (1, 79), (2, 8000)])
def test_planned_boxes_stay_inside_their_clip(clips, t0):
    """Every element of the two A maps lies inside its clip's frames, every stored row's operands lie inside
    the maps (zero fill reaches only rows t >= T_out), and the split-K scratch covers every split layer."""
    plan = wc.conv_plan(clips, t0)
    values, counters = wc.tail_scratch(clips, t0, plan)
    t_in = t0
    for taps, t_out, (warpgroups, splits) in zip(wc.TAIL_TAPS, wc.tail_lengths(t0), plan.tail):
        pair_rows, even_rows = t_in // 2, (t_in + 1) // 2
        assert 2 * pair_rows - 1 <= t_in - 1 and 2 * (even_rows - 1) <= t_in - 1  # last frame of each map
        bm = 64 * warpgroups
        for m0 in range(0, t_out, bm):
            for k0 in range(0, taps * C, SLICE):
                name, col, row = _box(k0, m0)
                extent, width = (pair_rows, PAIR_COLS) if name == "pairs" else (even_rows, C)
                assert 0 <= row and 0 <= col and col + SLICE <= width
                last_stored = min(m0 + bm, t_out) - 1  # the last row < T_out of this box's tile
                assert row + (last_stored - m0) < extent
        if splits > 1:
            tiles = wc.tail_blocks(clips, t_out, warpgroups)
            assert tiles <= counters and tiles * splits * bm * BN <= values
        t_in = t_out


@pytest.mark.parametrize("clips, n_samples", [(b, n) for b in (2, 16, 32) for n in WAVE_BUCKETS]
                         + [(2, n) for n in LONG_BUCKETS] + [(2, 40005), (3, 1052), (1, 10), (1, 15)])
def test_l0_tiles_cover_exactly_t0_frames(clips, n_samples):
    t0 = _t0(n_samples)
    tile = wc.conv_plan(clips, t0).l0_tile
    n_tiles = -(-t0 // tile)
    frames = np.concatenate([np.arange(i * tile, min((i + 1) * tile, t0)) for i in range(n_tiles)])
    np.testing.assert_array_equal(frames, np.arange(t0))
    last = n_tiles - 1  # the samples the last tile stages end inside the clip
    assert wc.L0_STRIDE * (last * tile + (t0 - last * tile) - 1) + wc.L0_TAPS <= n_samples


def _l0_restated(wave: np.ndarray, weight: np.ndarray, gamma, beta, tile: int, eps: float = 1e-5) -> np.ndarray:
    """K7's algorithm: per tile the 65 window moments in f64, added in tile order; each channel's mean and
    E[y^2] from them as w . S and w^T G w; the apply pass from its scale and shift in f32."""
    b, length = wave.shape
    t0 = _t0(length)
    w = weight[:, 0, :].astype(np.float64)  # [512, 10]
    pairs = [(j, k) for j in range(10) for k in range(j, 10)]
    out = np.empty((b, t0, C), np.float32)
    for clip in range(b):
        windows = np.stack([wave[clip, 5 * t: 5 * t + 10] for t in range(t0)]).astype(np.float64)  # [T0, 10]
        moments = np.zeros(65)
        for start in range(0, t0, tile):  # tile order
            s = windows[start: start + tile]
            moments += np.concatenate([s.sum(0), [(s[:, j] * s[:, k]).sum() for j, k in pairs]])
        moments /= t0
        mean = w @ moments[:10]
        sq = sum((1.0 if j == k else 2.0) * w[:, j] * w[:, k] * moments[10 + i] for i, (j, k) in enumerate(pairs))
        scale = gamma.astype(np.float64) / np.sqrt(np.maximum(sq - mean * mean, 0.0) + eps)
        shift = (beta - mean * scale).astype(np.float32)
        y = windows.astype(np.float32) @ (w.T * scale).astype(np.float32) + shift
        out[clip] = torch.nn.functional.gelu(torch.from_numpy(y)).numpy()
    return out


@pytest.mark.parametrize("clips, n_samples", [(2, 4005), (1, 1052)])
def test_l0_statistics_restated_match_plain_version(clips, n_samples):
    rng = np.random.default_rng(n_samples)
    t = np.arange(n_samples) / 16000
    wave = (0.4 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.normal(size=(clips, n_samples)) + 0.02).astype(np.float32)
    weight = (rng.normal(size=(C, 1, 10)) / np.sqrt(10)).astype(np.float32)
    gamma, beta = (1 + 0.1 * rng.normal(size=C)).astype(np.float32), (0.1 * rng.normal(size=C)).astype(np.float32)
    tile = wc.conv_plan(clips, _t0(n_samples)).l0_tile
    got = _l0_restated(wave, weight, gamma, beta, tile)
    want = wc.layer0_gn_reference(*(torch.from_numpy(a) for a in (wave, weight, gamma, beta))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_restacked_weights_are_kept_until_a_weight_changes():
    """The wrappers' cache of the kernels' weight copies: the same tensors at the same versions on the same
    storage give the same copy; an in-place update, a new storage through ``.data`` (as ``Module.to`` makes,
    with the version unchanged), another dtype or another tensor object gives a new one."""
    weights = _tail_weights(9)
    calls = []

    def make():
        calls.append(1)
        return wc.stack_tail_weights(weights, torch.bfloat16)

    first = wc._restacked("tail", weights, torch.bfloat16, make)
    assert wc._restacked("tail", weights, torch.bfloat16, make) is first and len(calls) == 1
    with torch.no_grad():
        weights[2].mul_(2.0)  # an optimizer step's kind of update
    second = wc._restacked("tail", weights, torch.bfloat16, make)
    assert second is not first and len(calls) == 2
    assert torch.equal(second[0][2], wc.stack_tail_weights(weights, torch.bfloat16)[0][2])
    wc._restacked("tail", weights, torch.float32, make)
    copies = [w.clone() for w in weights]  # equal values, other tensors
    wc._restacked("tail", copies, torch.bfloat16, make)
    assert len(calls) == 4
    assert wc._restacked("tail", weights, torch.bfloat16, make) is second and len(calls) == 4
    version = weights[4]._version
    weights[4].data = 3.0 * weights[4].data
    assert weights[4]._version == version
    third = wc._restacked("tail", weights, torch.bfloat16, make)
    assert third is not second and len(calls) == 5
    assert torch.equal(third[1][0], wc.stack_tail_weights(weights, torch.bfloat16)[1][0])


# -- on a card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernels K6 and K7 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(b: int, n_samples: int, device, seed: int):
    """Tone + noise waveforms and a conv stack's weights (N(0, 1 / fan_in)), on the card."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(n_samples) / 16000
    wave = 0.4 * torch.sin(2 * np.pi * (150 + 650 * torch.rand(b, 1, generator=gen)) * t) \
        + 0.05 * torch.randn(b, n_samples, generator=gen)
    w0 = torch.randn(C, 1, 10, generator=gen) / np.sqrt(10)
    tail = [torch.randn(C, C, k, generator=gen) / np.sqrt(k * C) for k in wc.TAIL_TAPS]
    gamma, beta = 1 + 0.1 * torch.randn(C, generator=gen), 0.1 * torch.randn(C, generator=gen)
    return wave.to(device), w0.to(device), [w.to(device) for w in tail], gamma.to(device), beta.to(device)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _held(got: torch.Tensor, want: torch.Tensor, f32_tol: tuple[float, float]) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=f32_tol[0], rtol=f32_tol[1])
    else:
        assert _rel(got, want) <= W2V_BF16_REL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n_samples", [(b, n) for b in (1, 2, 16, 32) for n in WAVE_BUCKETS]
                         + [(2, 40005), (3, 1052)])
def test_kernels_match_plain_versions_at_every_plan(cuda, b, n_samples, dtype):
    wave, w0, tail, gamma, beta = _card_inputs(b, n_samples, cuda, seed=b + n_samples)
    before = wc.layer0_gn.launches, wc.conv_stack_fused.launches
    x0 = wc.layer0_gn(wave, w0, gamma, beta, dtype=dtype)
    out = wc.conv_stack_fused(x0, tail)
    torch.cuda.synchronize()
    assert (wc.layer0_gn.launches, wc.conv_stack_fused.launches) == (before[0] + 1, before[1] + 1)
    _held(x0, wc.layer0_gn_reference(wave, w0, gamma, beta, dtype=dtype), (1e-4, 1e-4))
    _held(out, wc.conv_tail_reference(x0, tail), (2e-5, 2e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("b, n_samples", [(2, 64000), (32, 160000), (3, 1052)])
def test_two_calls_give_the_same_bits(cuda, b, n_samples):
    wave, w0, tail, gamma, beta = _card_inputs(b, n_samples, cuda, seed=7)
    for dtype in (torch.float32, torch.bfloat16):
        x0 = wc.layer0_gn(wave, w0, gamma, beta, dtype=dtype)
        assert torch.equal(x0, wc.layer0_gn(wave, w0, gamma, beta, dtype=dtype))
        assert torch.equal(wc.conv_stack_fused(x0, tail), wc.conv_stack_fused(x0, tail))


@pytest.mark.cuda
@pytest.mark.parametrize("b, n_samples", [(2, 64000), (32, 160000)])
def test_bf16_limit_fails_a_kernel_that_reads_the_wrong_tap(cuda, b, n_samples):
    """K6's output against the plain version of its input shifted by one frame (as a kernel reading tap j + 1
    for tap j would see it) is beyond ``W2V_BF16_REL``; against the true input it is within."""
    wave, w0, tail, gamma, beta = _card_inputs(b, n_samples, cuda, seed=11)
    x0 = wc.layer0_gn(wave, w0, gamma, beta, dtype=torch.bfloat16)
    got = wc.conv_stack_fused(x0, tail)
    shifted = torch.cat([x0[:, 1:], x0[:, -1:]], 1)
    assert _rel(got, wc.conv_tail_reference(x0, tail)) <= W2V_BF16_REL
    assert _rel(got, wc.conv_tail_reference(shifted, tail)) > W2V_BF16_REL


@pytest.mark.cuda
def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    wave, w0, tail, gamma, beta = _card_inputs(2, 8000, cuda, seed=3)
    x0 = wc.layer0_gn(wave, w0, gamma, beta, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        wc.conv_stack_fused(x0.transpose(0, 1).contiguous().transpose(0, 1), tail)  # [B, T, C], clip stride C
    with pytest.raises(ValueError, match="contiguous"):
        wc.conv_stack_fused(x0[:, :, :256].contiguous(), tail)  # 256 channels
    with pytest.raises(ValueError, match="contiguous"):
        wc.conv_stack_fused(x0[None], tail)
    with pytest.raises(ValueError, match="16-byte"):
        wc.conv_stack_fused(x0.reshape(-1)[1: 1 + x0.numel() - C].view(1, -1, C)[:, : x0.shape[1] - 1], tail)
    with pytest.raises(ValueError, match="waveforms"):
        wc.layer0_gn(wave[None], w0, gamma, beta)
    with pytest.raises(ValueError, match="waveforms"):
        wc.layer0_gn(wave[:, :9], w0, gamma, beta)
