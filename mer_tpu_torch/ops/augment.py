"""Waveform augmentations (counterpart of ``mer_tpu/ops/augment.py``).

The reference's ``audiomentations.Compose`` (audio_mel/dataset.py:24-29):
AddGaussianSNR (5-40 dB), TimeStretch (0.8-1.25), PitchShift (±4
semitones) and Shift (±0.5 of the clip, rolled over), each applied with
p = 0.5. Off by default (``AUDIO.augmentation_factor: 1``); the mel
extractor's training split uses it above 1.

Batched over [B, L] buffers with true lengths, on the tensors' device; every
draw comes from an explicit ``torch.Generator`` on that device. The contract
is the transforms and their probabilities, not ``mer_tpu``'s random stream
(as for dropout); with their parameters fixed the transforms are
``mer_tpu``'s. Time stretch and pitch shift run librosa's STFT phase
vocoder (n_fft 2,048, hop 512, periodic Hann), complex64.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mer_tpu_torch.ops.logmel import hann_window

N_FFT, HOP = 2048, 512
SNR_DB, STRETCH, SEMITONES, SHIFT = (5.0, 40.0), (0.8, 1.25), (-4.0, 4.0), (-0.5, 0.5)


def _uniform(n: int, bounds, generator: torch.Generator, device) -> torch.Tensor:
    lo, hi = bounds
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def _valid(wave: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    return torch.arange(wave.shape[-1], device=wave.device)[None, :] < length[:, None]


def add_gaussian_snr(wave: torch.Tensor, length: torch.Tensor, snr_db: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """White noise at ``snr_db`` [B] dB below each clip's mean power over its
    true length; zero past it."""
    valid = _valid(wave, length)
    power = torch.where(valid, wave * wave, 0.0).sum(-1) / length.clamp_min(1)
    noise_rms = torch.sqrt(power / 10.0 ** (snr_db / 10.0))
    noise = torch.randn(wave.shape, generator=generator, device=wave.device) * noise_rms[:, None]
    return torch.where(valid, wave + noise, 0.0)


def shift(wave: torch.Tensor, length: torch.Tensor, fraction: torch.Tensor) -> torch.Tensor:
    """Roll each clip within its true length by ``fraction`` [B] of it
    (truncated towards zero), as audiomentations' Shift with rollover."""
    offset = (fraction * length).to(torch.int32)
    idx = torch.arange(wave.shape[-1], device=wave.device)[None, :]
    src = torch.remainder(idx - offset[:, None], length.clamp_min(1)[:, None])
    return torch.where(idx < length[:, None], wave.gather(-1, src.long()), 0.0)


def _window(device) -> torch.Tensor:
    return torch.as_tensor(hann_window(N_FFT), dtype=torch.float32, device=device)


def stft(wave: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, 1 + L // HOP, N_FFT / 2 + 1] complex64, centred frames of
    the reflect-padded clip."""
    pad = N_FFT // 2
    padded = F.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP)[:, : 1 + wave.shape[-1] // HOP]
    return torch.fft.rfft(frames * _window(wave.device), dim=-1)


def istft(spec: torch.Tensor, out_len: int) -> torch.Tensor:
    """Overlap-add inverse of :func:`stft` (window-squared normalised), cut to ``out_len``."""
    window = _window(spec.device)
    frames = torch.fft.irfft(spec, n=N_FFT, dim=-1) * window  # [B, F, N_FFT]
    n_frames = spec.shape[1]
    total = N_FFT + HOP * (n_frames - 1)
    fold = lambda cols: F.fold(cols.transpose(1, 2), (1, total), (1, N_FFT), stride=(1, HOP))[:, 0, 0]
    signal = fold(frames)
    norm = fold((window * window).expand(1, n_frames, N_FFT))
    return (signal / norm.clamp_min(1e-8))[:, N_FFT // 2: N_FFT // 2 + out_len]


def phase_vocoder(spec: torch.Tensor, rate: torch.Tensor, n_out: int) -> torch.Tensor:
    """librosa's phase vocoder: the frame axis read at ``rate`` [B] frames a
    step, magnitudes interpolated, phases accumulated: [B, n_out, K]."""
    n_frames, k = spec.shape[1], spec.shape[2]
    advance = torch.linspace(0.0, math.pi * HOP, k, device=spec.device)
    steps = torch.arange(n_out, device=spec.device)[None, :] * rate[:, None]
    i0 = steps.floor().to(torch.int64).clamp(0, n_frames - 1)
    i1 = (i0 + 1).clamp(0, n_frames - 1)
    alpha = (steps - i0)[..., None]
    pick = lambda i: spec.gather(1, i[..., None].expand(-1, -1, k))
    s0, s1 = pick(i0), pick(i1)
    magnitude = (1.0 - alpha) * s0.abs() + alpha * s1.abs()
    dphase = torch.angle(s1) - torch.angle(s0) - advance
    dphase = dphase - 2.0 * math.pi * torch.round(dphase / (2.0 * math.pi))
    step_phase = advance + dphase
    phase = torch.angle(spec[:, :1]) + torch.cumsum(F.pad(step_phase[:, :-1], (0, 0, 1, 0)), dim=1)
    return torch.polar(magnitude, phase)


def time_stretch(wave: torch.Tensor, length: torch.Tensor, rate: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Faster (``rate`` > 1) or slower, pitch kept: (the stretched clips in
    the same [B, L] buffer, zero past them; their lengths
    min(trunc(length / rate), L))."""
    max_len = wave.shape[-1]
    spec = stft(wave)
    out = istft(phase_vocoder(spec, rate, spec.shape[1]), max_len)
    new_length = torch.clamp((length / rate).to(torch.int32), max=max_len)
    return torch.where(_valid(out, new_length), out, 0.0), new_length


def pitch_shift(wave: torch.Tensor, length: torch.Tensor, semitones: torch.Tensor) -> torch.Tensor:
    """Pitch moved by ``semitones`` [B], duration kept: stretched by 2^(s / 12),
    then read back at that rate by linear interpolation."""
    factor = 2.0 ** (semitones / 12.0)
    stretched, _ = time_stretch(wave, length, 1.0 / factor)
    max_len = wave.shape[-1]
    pos = torch.arange(max_len, device=wave.device)[None, :] * factor[:, None]
    i0 = pos.floor().to(torch.int64).clamp(0, max_len - 1)
    i1 = (i0 + 1).clamp(0, max_len - 1)
    frac = pos - i0
    out = (1.0 - frac) * stretched.gather(-1, i0) + frac * stretched.gather(-1, i1)
    return torch.where(_valid(wave, length), out, 0.0)


def _on_rows(apply: torch.Tensor, fn, wave: torch.Tensor, *per_row) -> torch.Tensor:
    """``fn`` on the rows where ``apply``, the other rows unchanged."""
    rows = apply.nonzero()[:, 0]
    if rows.numel() == 0:
        return wave
    out = wave.clone()
    out[rows] = fn(wave[rows], *(t[rows] for t in per_row))
    return out


def random_augment(wave: torch.Tensor, length: torch.Tensor, generator: torch.Generator,
                   p: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's Compose over [B, L] clips with true lengths [B]: each of
    the four transforms applied to a clip with probability ``p``, in order;
    returns (clips, new lengths)."""
    b, device = wave.shape[0], wave.device
    draw = lambda bounds: _uniform(b, bounds, generator, device)
    coin = lambda: torch.rand(b, generator=generator, device=device) < p
    length = length.to(torch.int32)

    apply, snr = coin(), draw(SNR_DB)
    rows = apply.nonzero()[:, 0]
    if rows.numel():
        wave = wave.clone()
        wave[rows] = add_gaussian_snr(wave[rows], length[rows], snr[rows], generator)

    apply, rate = coin(), draw(STRETCH)
    rows = apply.nonzero()[:, 0]
    if rows.numel():
        stretched, new_length = time_stretch(wave[rows], length[rows], rate[rows])
        wave, length = wave.clone(), length.clone()
        wave[rows], length[rows] = stretched, new_length

    apply, semitones = coin(), draw(SEMITONES)
    wave = _on_rows(apply, lambda w, n, s: pitch_shift(w, n, s), wave, length, semitones)

    apply, fraction = coin(), draw(SHIFT)
    wave = _on_rows(apply, lambda w, n, f: shift(w, n, f), wave, length, fraction)
    return wave, length


__all__ = ["add_gaussian_snr", "istft", "phase_vocoder", "pitch_shift", "random_augment", "shift", "stft",
           "time_stretch"]
