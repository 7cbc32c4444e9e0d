"""The port's log-mel frontend and kernel K5 against the JAX package's, on the CPU.

- the filterbank, window and DFT matrices are ``mer_tpu``'s, exactly;
- reflect padding and framing equal ``mer_tpu``'s (and ``np.pad``'s reflect)
  at every position a valid frame reads;
- K5's plain version matches ``logmel_frames_pallas`` (interpret mode) at
  [2, 300, 400] and [1, 1001, 400], rtol / atol 1e-4 (``tests/test_logmel_pallas.py``'s);
- K5's algorithm, restated step for step in float64 numpy (the kernel's
  Stockham radices, its host tables, the even/odd packing and the unpack),
  matches the plain version on tone + noise frames (rtol / atol 1e-4) and a
  float64 ``rfft`` within 1e-5 of each frame's largest mel band in the linear
  domain and within one float32 step in the log, a pure tone included; the
  host tables equal their float64 definitions;
- ``log_mel_spectrogram`` matches ``mer_tpu``'s with ``use_pallas`` False and
  True on a mixed-length batch with a 0.2 s and a 12 s clip, within one
  quantisation step (1/255 + 1e-6): a frame whose value sits on a step
  boundary may round to either side in the two packages; the zero padding
  past the valid frames is exact.

The ``cuda`` legs hold the kernel against its plain version on a card
(contiguous and ``unfold``-strided frames at hops 160, 100, 401 and 512,
ragged tiles, TF32 off, rtol / atol 1e-4 on the log values but at the
spectral notches, and every band within ``MEL_F64_SHARE`` of its frame's
largest band of a float64 ``rfft`` chain in the linear domain; a pure tone
within 1e-5 of each frame's largest band of the plain version in the linear
domain; silent frames exactly log(eps); the same bits from two calls) and
skip here; on a machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_logmel.py
"""

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import logmel as port
from mer_tpu_torch.ops.logmel_kernel import (FFT_RADICES, MEL_BAND_WIDTH, MEL_F64_SHARE, MEL_NOTCH, band_tables,
                                             fft_tables, logmel_frames, logmel_frames_reference, mel_bands_float64)

CFG = port.MelConfig()
STEP = 1 / 255 + 1e-6


@pytest.fixture(scope="module")
def jx():
    """``mer_tpu``'s frontend and K5 (imported here so the cuda legs run without JAX)."""
    import jax.numpy as jnp

    from mer_tpu.ops import logmel
    from mer_tpu.ops.logmel_pallas import logmel_frames_pallas

    return jnp, logmel, logmel_frames_pallas


def _waves(lengths, seed=0):
    """Tone + noise clips zero-padded to 10 s; lengths past 10 s are cut."""
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lengths), CFG.max_samples), np.float32)
    for i, n in enumerate(lengths):
        n = min(n, CFG.max_samples)
        t = np.arange(n) / CFG.sample_rate
        audio[i, :n] = 0.4 * np.sin(2 * np.pi * rng.uniform(150, 800) * t) + 0.05 * rng.normal(size=n)
    return audio, np.minimum(np.asarray(lengths), CFG.max_samples).astype(np.int32)


def test_operands_equal_jax(jx):
    _, logmel, _ = jx
    np.testing.assert_array_equal(port.hann_window(400), logmel.hann_window(400))
    for norm in (1, "slaney", None):
        np.testing.assert_array_equal(port.mel_filterbank(norm=norm), logmel.mel_filterbank(norm=norm))
    for got, want in zip(port.dft_matrices(400, port.hann_window(400)), logmel.dft_matrices(400, logmel.hann_window(400))):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert (CFG.max_samples, CFG.max_frames, CFG.n_freqs) == (160000, 1001, 201)


def test_reflect_pad_and_framing_exact_where_valid_frames_read(jx):
    """Lengths from 1 sample (shorter than the pad) to the full 10 s."""
    jnp, logmel, _ = jx
    lengths = [1, 150, 201, 3200, 16001, CFG.max_samples]
    audio, lengths = _waves(lengths)
    pad = CFG.n_fft // 2
    got = port.reflect_pad_batch(torch.from_numpy(audio), torch.from_numpy(lengths), CFG.max_samples, pad).numpy()
    want = np.asarray(logmel.reflect_pad_batch(jnp.asarray(audio), jnp.asarray(lengths), CFG.max_samples, pad))
    frames = port.frame_signal(torch.from_numpy(got), CFG.max_frames, CFG.n_fft, CFG.hop_length)
    want_frames = np.asarray(logmel.frame_signal(jnp.asarray(want), CFG.max_frames, CFG.n_fft, CFG.hop_length))
    assert got.shape == want.shape == (len(lengths), CFG.max_samples + 2 * pad)
    assert frames.shape == want_frames.shape and frames.stride()[1:] == (CFG.hop_length, 1)  # a view
    for i, n in enumerate(lengths):
        n_valid = 1 + n // CFG.hop_length
        reads = (n_valid - 1) * CFG.hop_length + CFG.n_fft  # positions the valid frames read
        np.testing.assert_array_equal(got[i, :reads], want[i, :reads])
        np.testing.assert_array_equal(frames[i, :n_valid].numpy(), want_frames[i, :n_valid])
        if n > pad:  # np.pad's reflect is defined
            ref = np.pad(audio[i, :n], pad, mode="reflect")
            np.testing.assert_array_equal(got[i, : min(reads, len(ref))], ref[: min(reads, len(ref))])


@pytest.mark.parametrize("shape, seed, scale", [((2, 300, 400), 0, 0.1), ((1, 1001, 400), 1, 1.0)])
def test_plain_k5_matches_pallas_interpret(jx, shape, seed, scale):
    jnp, logmel, logmel_frames_pallas = jx
    frames = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    want = np.asarray(logmel_frames_pallas(jnp.asarray(frames), logmel.MelConfig(), interpret=True))
    got = logmel_frames(torch.from_numpy(frames))  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == shape[:2] + (128,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert logmel_frames.launches == 0


def _tone_frames(n_frames, hop=160, seed=0, noise=0.05):
    """[2, n_frames, 400] f32 frames of reflect-padded tone (+ noise) clips."""
    audio, lengths = _waves([(n_frames - 1) * hop + 1] * 2, seed=seed)
    if not noise:
        t = np.arange(CFG.max_samples) / CFG.sample_rate
        audio = np.where(np.arange(CFG.max_samples) < lengths[:, None],
                         0.4 * np.sin(2 * np.pi * np.array([[310.0], [733.0]]) * t), 0.0).astype(np.float32)
    padded = port.reflect_pad_batch(torch.from_numpy(audio), torch.from_numpy(lengths), CFG.max_samples, 200)
    return port.frame_signal(padded, n_frames, 400, hop).contiguous().numpy()


def _dft(v, radix, c):
    """The kernel's radix-8 or radix-5 butterfly (``dft8``, ``dft5``) on v[..., r, :], in place."""
    if radix == 8:
        def dft4(a0, a1, a2, a3):
            t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, -1j * (a1 - a3)
            return t0 + t2, t1 + t3, t0 - t2, t1 - t3
        e = dft4(*(v[..., r, :] for r in (0, 2, 4, 6)))
        o = list(dft4(*(v[..., r, :] for r in (1, 3, 5, 7))))
        o[1] = c["c8"] * (o[1].real + o[1].imag) + 1j * c["c8"] * (o[1].imag - o[1].real)
        o[2] = -1j * o[2]
        o[3] = c["c8"] * (o[3].imag - o[3].real) - 1j * c["c8"] * (o[3].real + o[3].imag)
        return np.stack([e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)], axis=-2)
    x0, x1, x2, x3, x4 = (v[..., r, :] for r in range(5))
    a1, b1, a2, b2 = x1 + x4, x1 - x4, x2 + x3, x2 - x3
    p1, p2 = x0 + c["c1"] * a1 + c["c2"] * a2, x0 + c["c2"] * a1 + c["c1"] * a2
    q1, q2 = c["s1"] * b1 + c["s2"] * b2, c["s2"] * b1 - c["s1"] * b2
    return np.stack([x0 + a1 + a2, p1 - 1j * q1, p2 - 1j * q2, p2 + 1j * q2, p1 + 1j * q1], axis=-2)


def _kernel_restated(frames):
    """K5's algorithm in float64 (complex128) numpy, step for step: z[m] = w x[2m]
    + i w x[2m+1]; Stockham stages of ``FFT_RADICES`` with the twiddles and
    butterfly constants of ``fft_tables``; the unpack X[k] = E + W400^k O and
    X[200 - k] = conj(E - W400^k O) for k = 0..100; the magnitude, the mel
    product over each band's ``band_tables`` window, the log, and one
    rounding to float32."""
    window, w200, w400 = fft_tables(CFG)
    w200, w400 = (t[:, 0] + 1j * t[:, 1] for t in (w200, w400))
    c = {"c8": w200[25].real, "c1": w200[40].real, "s1": -w200[40].imag, "c2": w200[80].real,
         "s2": -w200[80].imag}
    x = frames * window
    z = x[..., 0::2] + 1j * x[..., 1::2]
    n, ns = z.shape[-1], 1
    for radix in FFT_RADICES:
        j = np.arange(n // radix)
        k, r = j % ns, np.arange(radix)[:, None]
        v = z[..., j + r * (n // radix)] * w200[(k * r * (n // (ns * radix))) % n]
        out = np.empty_like(z)
        out[..., (j // ns) * ns * radix + k + r * ns] = _dft(v, radix, c)
        z, ns = out, ns * radix
    k = np.arange(n // 2 + 1)
    zk, zc = z[..., k], np.conj(z[..., (n - k) % n])
    e, wo = 0.5 * (zk + zc), w400[k] * (-1j * 0.5 * (zk - zc))
    mag = np.empty(z.shape[:-1] + (n + 1,), np.float64)
    mag[..., n - k], mag[..., k] = np.abs(e - wo), np.abs(e + wo)
    weights, start = band_tables(CFG)
    mel = sum(weights[:, q].astype(np.float64) * mag[..., start + q] for q in range(MEL_BAND_WIDTH))
    return np.log(mel + port.EPS_F64).astype(np.float32)


def test_fft_tables_equal_their_float64_definitions():
    window, w200, w400 = fft_tables(CFG)
    assert np.prod(FFT_RADICES) == CFG.n_fft // 2
    assert all(t.dtype == np.float64 for t in (window, w200, w400))
    np.testing.assert_array_equal(window, port.hann_window(400))
    for table, n, count in ((w200, 200, 200), (w400, 400, 201)):
        angle = 2 * np.pi * np.arange(count, dtype=np.float64) / n
        np.testing.assert_array_equal(table, np.stack([np.cos(angle), -np.sin(angle)], -1))
    weights, start = band_tables(CFG)  # the filterbank, each band in a window of MEL_BAND_WIDTH bins
    rebuilt = np.zeros((CFG.n_mels, CFG.n_freqs), np.float32)
    for m, s in enumerate(start):
        rebuilt[m, s:s + MEL_BAND_WIDTH] = weights[m]
    assert weights.dtype == np.float32 and start.max() + MEL_BAND_WIDTH <= CFG.n_freqs
    np.testing.assert_array_equal(rebuilt, port.mel_filterbank())


def test_kernel_algorithm_matches_plain_version_on_tone_and_noise():
    frames = _tone_frames(300, seed=4)
    got = _kernel_restated(frames)
    assert got.dtype == np.float32 and got.shape == (2, 300, 128)
    np.testing.assert_allclose(got, logmel_frames_reference(torch.from_numpy(frames)).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("noise", [0.05, 0.0], ids=["tone_noise", "pure_tone"])
def test_kernel_algorithm_matches_float64_rfft_in_the_linear_domain(noise):
    """Within 1e-5 of each frame's largest band, and in the log within one
    float32 step of the float64 chain's log rounded to float32 (a pure tone's
    far bands included, which sit at rounding in an f32 path)."""
    frames = _tone_frames(120, seed=5, noise=noise)
    mel64 = mel_bands_float64(torch.from_numpy(frames)).numpy()
    restated = _kernel_restated(frames)
    got = np.exp(restated.astype(np.float64)) - port.EPS_F64
    assert np.all(np.abs(got - mel64) <= 1e-5 * mel64.max(axis=-1, keepdims=True))
    want = np.log(mel64 + port.EPS_F64).astype(np.float32)
    assert np.all(np.abs(restated - want) <= np.spacing(np.abs(want)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_log_mel_spectrogram_matches_jax(jx, use_pallas):
    jnp, logmel, _ = jx
    audio, lengths = _waves([3200, 192000, 40000, 16000 * 3 + 77], seed=2)  # 0.2 s, 12 s (cut), 2.5 s, 3 s
    want = np.asarray(logmel.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(lengths), use_pallas=use_pallas))
    got = port.log_mel_spectrogram(torch.from_numpy(audio), torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (4, 3, CFG.max_frames, CFG.n_mels)
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP)
    for i, n in enumerate(lengths):
        n_valid = 1 + n // CFG.hop_length
        assert np.all(got[i, :, n_valid:] == 0) and np.all(want[i, :, n_valid:] == 0)
        np.testing.assert_array_equal(got[i, 0], got[i, 2])
    # nearly every value sits on the same quantisation level in both
    assert np.mean(np.round(got * 255) != np.round(want * 255)) < 1e-3


def test_channels_last_and_unquantised(jx):
    jnp, logmel, _ = jx
    audio, lengths = _waves([8000, 24000], seed=3)
    got = port.log_mel_spectrogram(torch.from_numpy(audio), torch.from_numpy(lengths), quantize_png=False,
                                   channels_first=False).numpy()
    want = np.asarray(logmel.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(lengths), quantize_png=False,
                                                 channels_first=False, use_pallas=False))
    assert got.shape == want.shape == (2, CFG.max_frames, CFG.n_mels, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_prepare_waveform_batch_equals_jax(jx):
    _, logmel, _ = jx
    waves = [np.ones(10, np.float32), np.arange(CFG.max_samples + 5, dtype=np.float32)]
    for got, want in zip(port.prepare_waveform_batch(waves), logmel.prepare_waveform_batch(waves)):
        np.testing.assert_array_equal(got, want)


# -- on a card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel K5 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_matches_plain(got, frames):
    """rtol / atol 1e-4 against the plain version on the log values, but at
    the spectral notches: a band at or below ``MEL_NOTCH`` of its frame's
    largest band, where the dense f32 plain version is itself off float64
    beyond the tolerance. Every band, notches included, within
    ``MEL_F64_SHARE`` of its frame's largest band of a float64 rfft chain in
    the linear domain (the plain version reads up to 1.5e-6 there)."""
    want, mel64 = logmel_frames_reference(frames), mel_bands_float64(frames)
    largest = mel64.amax(dim=-1, keepdim=True)
    notch = (mel64 <= MEL_NOTCH * largest) & (largest > 0)
    log_bad = ((got - want).abs() > 1e-4 + 1e-4 * want.abs()) & ~notch
    assert not bool(log_bad.any()), f"{int(log_bad.sum())} values off, worst {(got - want)[log_bad].abs().max()}"
    share = torch.where(largest > 0, (torch.exp(got.double()) - port.EPS_F64 - mel64).abs() / largest, 0.0)
    assert share.max().item() <= MEL_F64_SHARE, share.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b, f", [(32, 1001), (47, 1001), (3, 37)])
def test_kernel_matches_plain_version(cuda, b, f):
    rng = np.random.default_rng(b)
    contiguous = torch.from_numpy(rng.normal(size=(b, f, 400)).astype(np.float32)).to(cuda)
    audio, lengths = _waves(rng.integers(1, CFG.max_samples, size=b), seed=b)
    padded = port.reflect_pad_batch(torch.from_numpy(audio).to(cuda), torch.from_numpy(lengths).to(cuda),
                                    CFG.max_samples, 200)
    strided = port.frame_signal(padded, f, 400, 160)
    for frames in (contiguous, strided):
        before = logmel_frames.launches
        got = logmel_frames(frames)
        torch.cuda.synchronize()
        assert logmel_frames.launches == before + 1
        _assert_matches_plain(got, frames)


@pytest.mark.cuda
@pytest.mark.parametrize("hop, f, offset", [(100, 1001, 0), (512, 300, 0), (160, 1001, 1), (401, 37, 3)])
def test_kernel_matches_plain_version_at_other_frame_strides(cuda, hop, f, offset):
    """A hop up to 400 stages the span of the tile's frames, a larger one row
    by row; an offset start or an odd hop takes the 4-byte loads; F % 16 != 0
    leaves a ragged last tile."""
    rng = np.random.default_rng(hop)
    audio, lengths = _waves(rng.integers(CFG.sample_rate, CFG.max_samples, size=5), seed=hop)
    padded = port.reflect_pad_batch(torch.from_numpy(audio).to(cuda), torch.from_numpy(lengths).to(cuda),
                                    CFG.max_samples, 200)
    frames = port.frame_signal(padded[:, offset:], f, 400, hop)
    assert frames.stride() == (padded.stride(0), hop, 1)
    got = logmel_frames(frames)
    torch.cuda.synchronize()
    _assert_matches_plain(got, frames)


@pytest.mark.cuda
def test_kernel_on_a_pure_tone_and_silence_and_from_call_to_call(cuda):
    """A pure tone's far bands sit at f32 rounding in both f32 paths, so it is
    held in the linear domain: within 1e-5 of each frame's largest band, and
    within ``MEL_F64_SHARE`` of it of a float64 chain. A silent clip gives
    exactly log(eps) rounded once to float32 (``torch.log`` in f32 gives the
    value one step off); two calls give the same bits."""
    tones = torch.from_numpy(_tone_frames(1001, noise=0.0)).to(cuda)
    frames = torch.cat([tones, torch.zeros_like(tones[:1])])
    got, again = logmel_frames(frames), logmel_frames(frames)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    log_eps = torch.tensor(np.log(port.EPS_F64), dtype=torch.float32, device=cuda)  # rounded once, from float64
    assert torch.equal(got[2], log_eps.expand_as(got[2]))
    lin, lin_ref = (torch.exp(t[:2].double()) - port.EPS_F64 for t in (got, logmel_frames_reference(frames)))
    largest = lin_ref.amax(dim=-1, keepdim=True)
    assert bool((largest > 0).all())
    assert bool(((lin - lin_ref).abs() <= 1e-5 * largest).all())
    mel64 = mel_bands_float64(tones)
    assert bool(((lin - mel64).abs() <= MEL_F64_SHARE * mel64.amax(dim=-1, keepdim=True)).all())


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_cuda(cuda):
    frames = torch.zeros(1, 4, 400, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        logmel_frames(frames)
    with pytest.raises(ValueError, match="float32"):
        logmel_frames(torch.zeros(1, 4, 400, device=cuda, dtype=torch.bfloat16))
