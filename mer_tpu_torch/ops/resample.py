"""Windowed-sinc polyphase resampling (counterpart of ``mer_tpu/ops/resample.py``).

torchaudio's ``resample`` with ``sinc_interp_hann`` (lowpass filter width 6,
rolloff 0.99), the reference wav2vec2 dataset's 16 kHz safety net
(audio_wav2vec2/dataset.py:42-43; MELD's wavs are 16 kHz already): for
rates reduced by their gcd to ``orig`` -> ``new``, output sample ``i · new +
p`` is the dot product of the input window starting at ``i · orig`` with
phase p's row of a sinc filter bank. The bank is built in float64 and kept
in float32; the product is one strided ``conv1d`` on the host (the data
path's) or on the tensor's device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

LOWPASS_FILTER_WIDTH = 6
ROLLOFF = 0.99


@lru_cache(maxsize=16)
def sinc_bank(orig_freq: int, new_freq: int) -> tuple[np.ndarray, int]:
    """(bank [new, 2 · width + orig] float32, width) for the gcd-reduced rates."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    cutoff = min(orig, new) * ROLLOFF
    width = math.ceil(LOWPASS_FILTER_WIDTH * orig / cutoff)
    taps = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = (taps[None, :] - np.arange(new, dtype=np.float64)[:, None] / new) * cutoff
    t = np.clip(t, -LOWPASS_FILTER_WIDTH, LOWPASS_FILTER_WIDTH)
    window = np.cos(t * np.pi / (2 * LOWPASS_FILTER_WIDTH)) ** 2
    bank = np.sinc(t) * window * (cutoff / orig)  # np.sinc(0) = 1
    return bank.astype(np.float32), width


def resample(waveform, orig_freq: int, new_freq: int):
    """Resample [..., L] (numpy or torch; the result is of the same kind) to
    ceil(new_freq · L / orig_freq) samples."""
    as_numpy = not isinstance(waveform, torch.Tensor)
    if orig_freq == new_freq:
        return np.asarray(waveform) if as_numpy else waveform
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    bank, width = sinc_bank(orig_freq, new_freq)
    x = torch.from_numpy(np.asarray(waveform, dtype=np.float32)) if as_numpy else waveform.float()
    lead, length = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, 1, length)
    padded = F.pad(rows, (width, width + orig))
    blocks = -(-length // orig)
    kernel = torch.from_numpy(bank).to(rows.device)[:, None, :]  # [new, 1, K]
    out = F.conv1d(padded, kernel, stride=orig)[..., :blocks]  # [rows, new, blocks]
    out = out.transpose(1, 2).reshape(*lead, blocks * new)[..., : math.ceil(new_freq * length / orig_freq)]
    return out.numpy() if as_numpy else out


__all__ = ["resample", "sinc_bank"]
