"""The port's log-mel frontend and kernel K5 against the JAX package's, on the CPU.

- the filterbank, window and DFT matrices are ``mer_tpu``'s, exactly;
- reflect padding and framing equal ``mer_tpu``'s (and ``np.pad``'s reflect)
  at every position a valid frame reads;
- K5's plain version matches ``logmel_frames_pallas`` (interpret mode) at
  [2, 300, 400] and [1, 1001, 400], rtol / atol 1e-4 (``tests/test_logmel_pallas.py``'s);
- ``log_mel_spectrogram`` matches ``mer_tpu``'s with ``use_pallas`` False and
  True on a mixed-length batch with a 0.2 s and a 12 s clip, within one
  quantisation step (1/255 + 1e-6): a frame whose value sits on a step
  boundary may round to either side in the two packages; the zero padding
  past the valid frames is exact.

The ``cuda`` legs hold the kernel against its plain version on a card
(contiguous and ``unfold``-strided frames, TF32 off, rtol / atol 1e-4) and
skip here; on a machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_logmel.py
"""

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import logmel as port
from mer_tpu_torch.ops.logmel_kernel import logmel_frames, logmel_frames_reference

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
        torch.testing.assert_close(got, logmel_frames_reference(frames), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_cuda(cuda):
    frames = torch.zeros(1, 4, 400, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        logmel_frames(frames)
    with pytest.raises(ValueError, match="float32"):
        logmel_frames(torch.zeros(1, 4, 400, device=cuda, dtype=torch.bfloat16))
