"""Host-side WAV reading and writing (counterpart of ``mer_tpu/data/audio_io.py``).

MELD's wavs, as ``scripts/mp4towav.py`` writes them, are mono 16 kHz PCM16,
which the stdlib ``wave`` module reads. Decoding stays on the host; the
log-mel frontend runs on the device. A file at another rate is resampled
(``ops/resample.py``) unless the store is told not to, as ``mer_tpu``'s.
"""

from __future__ import annotations

import os
import wave
from functools import lru_cache

import numpy as np


def load_wav(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """A PCM WAV file -> (mono float32 waveform in [-1, 1], sample rate), as
    ``torchaudio.load(normalize=True)`` averaged over channels."""
    with wave.open(os.fspath(path), "rb") as f:
        sr = f.getframerate()
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {sampwidth} in {path}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sr


def save_wav(path: str | os.PathLike, waveform: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] as PCM16 WAV."""
    pcm = (np.clip(np.asarray(waveform, dtype=np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(os.fspath(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


class WaveformStore:
    """MELD utterance wavs by (dialogue_id, utterance_id), LRU-cached, cut to
    ``max_seconds`` (the reference's check and truncation,
    audio_mel/dataset.py:146-153); a file at another rate is resampled to
    ``sample_rate``, or raises with ``resample_if_needed=False``."""

    def __init__(self, audio_dir: str, sample_rate: int = 16000, max_seconds: float = 10.0,
                 resample_if_needed: bool = True):
        self.audio_dir = os.path.abspath(audio_dir)
        self.sample_rate = sample_rate
        self.max_samples = int(max_seconds * sample_rate)
        self.resample_if_needed = resample_if_needed
        self._load = lru_cache(maxsize=2048)(self._load_uncached)

    def path_for(self, dialogue_id: int, utterance_id: int) -> str:
        return os.path.join(self.audio_dir, f"dia{dialogue_id}_utt{utterance_id}.wav")

    def _load_uncached(self, dialogue_id: int, utterance_id: int) -> np.ndarray:
        path = self.path_for(dialogue_id, utterance_id)
        wav, sr = load_wav(path)
        if sr != self.sample_rate:
            if not self.resample_if_needed:
                raise ValueError(f"{path}: sample rate {sr} Hz, expected {self.sample_rate} Hz")
            from mer_tpu_torch.ops.resample import resample

            wav = resample(wav, sr, self.sample_rate)
        return wav[: self.max_samples].astype(np.float32)

    def get(self, dialogue_id: int, utterance_id: int) -> np.ndarray:
        return self._load(int(dialogue_id), int(utterance_id))
