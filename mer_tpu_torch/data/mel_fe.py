"""Mel feature-extractor data (stage 1c; counterpart of ``mer_tpu/data/mel_fe.py``).

The reference featurises on the host with librosa and keeps a uint8 PNG
cache (audio_mel/dataset.py:93-180). Here the host only decodes wavs (the
native batch decoder, :mod:`mer_tpu_torch.data.native_wavio`, a clip it
rejects through :mod:`mer_tpu_torch.data.audio_io`) and ships them as
int16; peak normalisation, framing, DFT, mel projection, log, min-max and the
uint8 quantisation run on the device (:mod:`mer_tpu_torch.ops.logmel`, with
kernel K5 on the card). :meth:`MelFeatureDataset.build_device_cache` keeps a
split's spectrograms on the device as uint8 [N, frames, mels], the analogue
of the reference's PNG cache; a batch is then one gather.

Augmentation (the train split at ``AUDIO.augmentation_factor`` > 1, as
``mer_tpu``'s): no device cache; a batch asked for with a generator is
decoded from the wavs, each clip takes variant 0 (clean) or one of the
others (:func:`~mer_tpu_torch.ops.augment.random_augment` on the device)
uniformly (audio_mel/dataset.py:125-128), then K5.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mer_tpu_torch.core import get_text, map_emotions
from mer_tpu_torch.ops.augment import random_augment
from mer_tpu_torch.ops.logmel import MelConfig, log_mel_spectrogram

_SPLIT_WAV_DIRS = {
    "train": "MELD.Raw/train_splits/wav",
    "val": "MELD.Raw/dev_splits_complete/wav",
    "test": "MELD.Raw/output_repeated_splits_test/wav",
}


def wav_dir_for(mode: str, data_root: str = "data") -> str:
    return os.path.join(os.path.abspath(data_root), _SPLIT_WAV_DIRS[mode])


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> ``device`` without waiting for the device's queue
    (pinned, non-blocking on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class MelFeatureDataset:
    """Utterance rows of one split -> waveforms -> log-mel images on ``device``.

    - ``labels`` / :meth:`get_labels` for mining;
    - :meth:`spectrogram_batch` (indices) -> [n, 3, frames, mels] f32 in
      [0, 1], NCHW for the encoder: from the device cache once built, else
      from the waveforms; augmented when given a generator on the train
      split at ``augmentation_factor`` > 1;
    - ``DEBUG.enabled`` / ``num_samples`` truncation (audio_mel/dataset.py:54-56).
    """

    def __init__(self, mode: str, config, data_root: str | None = None, waveform_store=None,
                 device: torch.device | str = "cuda"):
        from mer_tpu_torch.data.audio_io import WaveformStore

        self.mode = mode
        self.device = torch.device(device)
        self.mel_cfg = MelConfig(sample_rate=int(config.AUDIO.ffmpeg_sr), max_seconds=float(config.AUDIO.max_duration))
        self.augmentation_factor = max(int(config.get_path("AUDIO.augmentation_factor", 1)), 1)
        df = map_emotions(get_text(mode, data_root=data_root))
        if bool(config.get_path("DEBUG.enabled", False)):
            df = df.iloc[: int(config.DEBUG.num_samples)]
        self.df = df
        self.labels = df["Emotion"].to_numpy(dtype=np.int64)
        self.dia_utt = df[["Dialogue_ID", "Utterance_ID"]].to_numpy(dtype=np.int64)
        self.store = waveform_store or WaveformStore(wav_dir_for(mode, data_root or "data"),
                                                     sample_rate=self.mel_cfg.sample_rate,
                                                     max_seconds=self.mel_cfg.max_seconds)
        self.device_cache: torch.Tensor | None = None  # uint8 [N, frames, mels] once built

    def __len__(self) -> int:
        return len(self.df)

    def get_labels(self) -> np.ndarray:
        return self.labels

    @property
    def augments(self) -> bool:
        return self.mode == "train" and self.augmentation_factor > 1

    def waveform_batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """[n, max_samples] float32 buffer, zero past each clip, and the true
        lengths, int32: one native decode of the batch; a clip it rejects (a
        negative length code: another rate, an odd format) goes through the
        store, which resamples. With ``MER_TPU_NATIVE=0`` every clip does."""
        from mer_tpu_torch.data import native_wavio

        indices = np.asarray(indices)
        width = self.mel_cfg.max_samples
        if native_wavio.available():
            paths = [self.store.path_for(*self.dia_utt[int(i)]) for i in indices]
            out, lengths = native_wavio.decode_wav_batch(paths, width, expect_rate=self.mel_cfg.sample_rate)
            rejected = np.flatnonzero(lengths < 0)
        else:
            out, lengths = np.zeros((len(indices), width), np.float32), np.zeros((len(indices),), np.int32)
            rejected = np.arange(len(indices))
        for k in rejected:
            w = self.store.get(*self.dia_utt[int(indices[k])])[:width]
            out[k, : len(w)] = w
            out[k, len(w):] = 0.0
            lengths[k] = len(w)
        return out, lengths.astype(np.int32)

    def augment(self, audio: torch.Tensor, lengths: torch.Tensor,
                generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(clips, lengths, variant [n]) of a batch: each clip draws its
        variant uniformly from ``augmentation_factor``; variant 0 stays clean,
        the others go through ``random_augment`` (draws on ``audio``'s device,
        seeded from ``generator``)."""
        seed = int(torch.randint(0, 1 << 62, (1,), generator=generator))
        drawn = torch.Generator(device=audio.device).manual_seed(seed)
        variant = torch.randint(0, self.augmentation_factor, (audio.shape[0],), generator=drawn, device=audio.device)
        rows = (variant > 0).nonzero()[:, 0]
        if rows.numel():
            aug_w, aug_l = random_augment(audio[rows], lengths[rows], drawn)
            audio, lengths = audio.clone(), lengths.clone()
            audio[rows], lengths[rows] = aug_w, aug_l.to(lengths.dtype)
        return audio, lengths, variant

    def spectrogram_from_waveforms(self, indices, generator: torch.Generator | None = None) -> torch.Tensor:
        """[n, 3, frames, mels] computed from the wavs now (one K5 launch on
        the card), augmented first when ``generator`` is given and the split
        augments."""
        waves, lengths = self.waveform_batch(indices)
        # int16 on the wire: PCM's own width, half the bytes; the peak
        # normalisation cancels the scale (mel_fe.py:145-148)
        waves_i16 = np.clip(waves * 32768.0, -32768, 32767).astype(np.int16)
        audio, lengths = to_device(waves_i16, self.device).to(torch.float32), to_device(lengths, self.device)
        if generator is not None and self.augments:
            audio, lengths, _ = self.augment(audio, lengths, generator)
        return log_mel_spectrogram(audio, lengths, self.mel_cfg)

    def build_device_cache(self, chunk: int = 64) -> None:
        """Featurise the split once, ``chunk`` clips at a time (one K5 launch
        each), into a uint8 [N, frames, mels] table on the device. An
        augmenting split keeps none: its variants need the waveforms."""
        if self.augments:
            return
        cfg = self.mel_cfg
        cache = torch.empty((len(self), cfg.max_frames, cfg.n_mels), dtype=torch.uint8, device=self.device)
        for start in range(0, len(self), chunk):
            spec = self.spectrogram_from_waveforms(np.arange(start, min(start + chunk, len(self))))
            cache[start:start + spec.shape[0]] = torch.round(spec[:, 0] * 255.0).to(torch.uint8)
        self.device_cache = cache

    def spectrogram_batch(self, indices, generator: torch.Generator | None = None) -> torch.Tensor:
        """[n, 3, frames, mels] f32 log-mel images: a gather from the device
        cache when built (``indices`` may be a device tensor), else computed
        from the wavs, augmented by ``generator``'s draws where the split
        augments. The 3 channels are one broadcast view."""
        if self.device_cache is None or (generator is not None and self.augments):
            return self.spectrogram_from_waveforms(np.asarray(indices), generator)
        if isinstance(indices, torch.Tensor):
            idx = indices.to(self.device, torch.int64)
        else:
            idx = to_device(np.asarray(indices, dtype=np.int64), self.device)
        gray = self.device_cache.index_select(0, idx).to(torch.float32) / 255.0
        return gray[:, None].expand(-1, 3, -1, -1)
