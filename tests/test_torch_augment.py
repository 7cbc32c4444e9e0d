"""The port's waveform augmentations and resampling against the JAX package's, on the CPU.

- ``resample``: within 1e-6 of ``mer_tpu``'s at 8, 22.05, 44.1 and 48 kHz,
  to and from 16 kHz, the same lengths; the store resamples a 22.05 kHz wav;
- with their parameters fixed, ``time_stretch`` and ``pitch_shift`` (the
  STFT phase vocoder) within 1e-3 of ``mer_tpu``'s largest |value| (observed
  2.4e-4: rfft, angle and cumsum round differently in the two packages), the
  stretched lengths equal; ``shift`` exact; ``add_gaussian_snr`` at a fixed
  SNR: zero past the clip, the clip untouched where the noise is subtracted
  back, and the noise's power within 5% of ``mer_tpu``'s;
- ``random_augment`` applies each transform to about half the clips (1,200
  clips, within 0.06 of p = 0.5), and its draws repeat under one seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mer_tpu.ops import augment as jax_augment
from mer_tpu.ops.resample import resample as jax_resample
from mer_tpu_torch.data.audio_io import WaveformStore, load_wav, save_wav
from mer_tpu_torch.ops import augment
from mer_tpu_torch.ops.resample import resample

LENGTHS = (8000, 5000, 1700)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def clips():
    """Three int16-scaled clips (a tone and noise) in an 8,000-sample buffer, zero past their lengths."""
    rng = np.random.default_rng(0)
    t = np.arange(8000) / 16000
    wave = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=8000)) * 32768
    return np.stack([np.where(np.arange(8000) < n, wave, 0) for n in LENGTHS]).astype(np.float32)


@pytest.mark.parametrize("rate", [8000, 22050, 44100, 48000])
def test_resample_matches_jax(rate):
    x = np.random.default_rng(rate).uniform(-1, 1, (3, 4001)).astype(np.float32)
    for src, dst in ((rate, 16000), (16000, rate)):
        want = jax_resample(x, src, dst)
        got = resample(x, src, dst)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        torch.testing.assert_close(resample(torch.from_numpy(x), src, dst), torch.from_numpy(got), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(resample(x, rate, rate), x)


def test_store_resamples_a_foreign_rate(tmp_path):
    tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(2205) / 22050)).astype(np.float32)
    save_wav(tmp_path / "dia0_utt0.wav", tone, 22050)
    got = WaveformStore(str(tmp_path), sample_rate=16000).get(0, 0)
    pcm, rate = load_wav(tmp_path / "dia0_utt0.wav")
    assert rate == 22050
    np.testing.assert_allclose(got, jax_resample(pcm, 22050, 16000), rtol=0, atol=1e-6)
    assert len(got) == 1600
    with pytest.raises(ValueError, match="sample rate"):
        WaveformStore(str(tmp_path), sample_rate=16000, resample_if_needed=False).get(0, 0)


@pytest.mark.parametrize("row", range(len(LENGTHS)))
def test_time_stretch_and_pitch_shift_match_jax(clips, row):
    n, wave = LENGTHS[row], clips[row]
    scale = np.abs(wave).max()
    for rate in (0.8, 1.1, 1.25):
        want, want_len = jax_augment.time_stretch(jnp.asarray(wave), jnp.int32(n), jnp.float32(rate))
        got, got_len = augment.time_stretch(torch.from_numpy(wave[None]), torch.tensor([n]), torch.tensor([rate]))
        assert int(got_len[0]) == int(want_len)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-3 * scale)
    for semitones in (-4.0, 2.5):
        want = jax_augment.pitch_shift(jnp.asarray(wave), jnp.int32(n), jnp.float32(semitones))
        got = augment.pitch_shift(torch.from_numpy(wave[None]), torch.tensor([n]), torch.tensor([semitones]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-3 * scale)


def test_shift_and_noise_match_jax(clips):
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    for fraction in (-0.5, -0.13, 0.0, 0.3):
        key = jax.random.PRNGKey(0)
        for row, n in enumerate(LENGTHS):
            want = jax_augment.shift(key, jnp.asarray(clips[row]), jnp.int32(n), fraction, fraction)
            got = augment.shift(torch.from_numpy(clips[row:row + 1]), lengths[row:row + 1], torch.tensor([fraction]))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(1)
    got = augment.add_gaussian_snr(torch.from_numpy(clips), lengths, torch.full((3,), 20.0), gen)
    for row, n in enumerate(LENGTHS):
        want = np.asarray(jax_augment.add_gaussian_snr(jax.random.PRNGKey(row), jnp.asarray(clips[row]), jnp.int32(n),
                                                       20.0, 20.0))
        noise, jax_noise = (got[row].numpy() - clips[row])[:n], (want - clips[row])[:n]
        assert not got[row, n:].any() and not want[n:].any()
        assert abs(np.mean(noise ** 2) / np.mean(jax_noise ** 2) - 1) < 0.05
        assert abs(np.mean(noise ** 2) / (np.mean(clips[row, :n] ** 2) / 100) - 1) < 0.1  # 20 dB below the clip


def test_random_augment_rates_and_repeats(monkeypatch):
    n, length = 1200, 2048
    rng = np.random.default_rng(2)
    wave = torch.from_numpy(rng.normal(size=(n, length)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(1100, length + 1, n).astype(np.int32))
    counts = {}
    for name in ("add_gaussian_snr", "time_stretch", "pitch_shift", "shift"):
        fn = getattr(augment, name)

        def counted(w, *args, _fn=fn, _name=name):
            counts[_name] = counts.get(_name, 0) + w.shape[0]
            return _fn(w, *args)

        monkeypatch.setattr(augment, name, counted)
    out, new_lengths = augment.random_augment(wave, lengths, torch.Generator().manual_seed(3))
    counts["time_stretch"] -= counts["pitch_shift"]  # pitch_shift stretches each of its clips once
    for name in ("add_gaussian_snr", "time_stretch", "pitch_shift", "shift"):
        assert abs(counts[name] / n - 0.5) < 0.06, (name, counts)
    changed = (new_lengths != lengths).float().mean().item()
    assert 0.35 < changed < 0.6  # the stretched clips (a rate near 1 can keep a length)
    assert (new_lengths <= length).all() and out.shape == wave.shape
    monkeypatch.undo()
    again = augment.random_augment(wave[:50], lengths[:50], torch.Generator().manual_seed(4))
    once = augment.random_augment(wave[:50], lengths[:50], torch.Generator().manual_seed(4))
    torch.testing.assert_close(again[0], once[0], rtol=0, atol=0)
    torch.testing.assert_close(again[1], once[1], rtol=0, atol=0)
