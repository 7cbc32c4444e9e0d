"""wav2vec2 feature-extractor data (stage 1b; counterpart of
``mer_tpu/data/wav2vec2_fe.py``).

Reference behaviour (audio_wav2vec2/dataset.py): per-utterance waveforms from
``dia{D}_utt{U}.wav`` at 16 kHz, cut to 10 s; the collate zero-pads to the
batch's longest clip and carries a ``lengths`` tensor. As in ``mer_tpu``,
widths pad to a fixed ladder (2 / 4 / 6 / 8 / 10 s), so the conv frontend and
the attention see a handful of shapes, and the lengths drive the frame
masking inside the model. Batches are host numpy, int16 on the wire (PCM's
own width); :func:`w2v_batch_to_inputs` makes the model's float inputs on the
device.

Single process; the native batch wav decoder is not ported (the stdlib
reader of :mod:`mer_tpu_torch.data.audio_io` decodes).
"""

from __future__ import annotations

import wave

import numpy as np
import torch

from mer_tpu_torch.core import get_text, map_emotions
from mer_tpu_torch.data.audio_io import WaveformStore
from mer_tpu_torch.data.mel_fe import to_device, wav_dir_for

SAMPLE_RATE = 16000
MAX_SECONDS = 10.0
SECONDS_BUCKETS = (2.0, 4.0, 6.0, 8.0, 10.0)


class Wav2Vec2FeatureDataset:
    def __init__(self, mode: str, data_root: str | None = None):
        self.mode = mode
        self.sample_rate = SAMPLE_RATE
        self.max_seconds = MAX_SECONDS
        df = map_emotions(get_text(mode, data_root=data_root))
        self.df = df
        self.labels = df["Emotion"].to_numpy(dtype=np.int64)
        self.dia_utt = df[["Dialogue_ID", "Utterance_ID"]].to_numpy(dtype=np.int64)
        self.store = WaveformStore(wav_dir_for(mode, data_root or "data"), sample_rate=SAMPLE_RATE,
                                   max_seconds=MAX_SECONDS)
        self._lengths: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.df)

    def get_labels(self) -> np.ndarray:
        return self.labels

    def waveform(self, idx: int) -> np.ndarray:
        dia, utt = self.dia_utt[int(idx)]
        return self.store.get(dia, utt)

    def waveform_lengths(self) -> np.ndarray:
        """Clip lengths in samples (after the cut), from the WAV headers only;
        0 for a file that is missing or unreadable. Cached after the first call."""
        if self._lengths is None:
            out = np.zeros((len(self),), dtype=np.int64)
            for i, (dia, utt) in enumerate(self.dia_utt):
                try:
                    with wave.open(self.store.path_for(dia, utt), "rb") as f:
                        n, sr = f.getnframes(), f.getframerate()
                    if sr != self.sample_rate:
                        n = int(n * self.sample_rate / sr)
                    out[i] = min(n, int(self.max_seconds * self.sample_rate))
                except (OSError, wave.Error):
                    out[i] = 0
            self._lengths = out
        return self._lengths


def w2v_batch_to_inputs(batch: dict, device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(waveforms [B, L] float32, lengths [B] int32) on ``device`` from a
    batch: the audio crosses to the device as int16 and becomes float there."""
    audio = to_device(batch["audio"], torch.device(device)).to(torch.float32) / 32768.0
    return audio, to_device(batch["lengths"], torch.device(device))


class Wav2Vec2Batcher:
    """Batches of ``batch_size`` clips: ``idx`` [B], ``audio`` [B, width]
    int16, ``lengths`` [B] int32, ``emotion`` [B] int32. The width is the
    smallest bucket that holds the batch's longest clip; the last batch is
    filled by repeating its last clip with ``emotion`` -1. With ``shuffle``, clips of similar length share a
    batch and the batch order is shuffled; without, the table's order is kept."""

    def __init__(self, dataset: Wav2Vec2FeatureDataset, batch_size: int, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.buckets = tuple(int(s * dataset.sample_rate) for s in SECONDS_BUCKETS)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _bucket(self, longest: int) -> int:
        for b in self.buckets:
            if longest <= b:
                return b
        return self.buckets[-1]

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
            lengths = self.dataset.waveform_lengths()[order]
            order = order[np.argsort(lengths, kind="stable")]
        batches = [order[i: i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.shuffle:
            self._rng.shuffle(batches)
        for idx in batches:
            pad = self.batch_size - len(idx)
            full_idx = np.concatenate([idx, idx[-1:].repeat(pad)]) if pad else idx
            waves = [self.dataset.waveform(j) for j in full_idx]
            width = self._bucket(max(len(w) for w in waves))
            audio = np.zeros((self.batch_size, width), dtype=np.int16)
            lengths = np.zeros((self.batch_size,), dtype=np.int32)
            for i, w in enumerate(waves):
                w = w[:width]
                audio[i, : len(w)] = np.clip(w * 32768.0, -32768, 32767).astype(np.int16)
                lengths[i] = len(w)
            emotion = self.dataset.labels[full_idx].astype(np.int32).copy()
            if pad:
                emotion[len(idx):] = -1
            yield {"idx": full_idx, "audio": audio, "lengths": lengths, "emotion": emotion}
