"""MELD-shaped synthetic dialogues (counterpart of ``mer_tpu/data/synthetic.py``).

The same numpy stream as the JAX package, so one seed gives identical
dialogues: MELD test statistics (280 dialogues, mean ~9.3 utterances, max
33), with class-dependent mean offsets so the labels are learnable.
"""

from __future__ import annotations

import numpy as np


def synthetic_dialogues(
    n_dialogues: int = 280,
    d_text: int = 768,
    d_audio: int = 768,
    num_classes: int = 7,
    mean_len: float = 9.3,
    max_len: int = 33,
    seed: int = 0,
    learnable: bool = True,
) -> list[dict]:
    rng = np.random.default_rng(seed)
    class_text_means = rng.normal(scale=1.0, size=(num_classes, d_text)).astype(np.float32)
    class_audio_means = rng.normal(scale=1.0, size=(num_classes, d_audio)).astype(np.float32)

    dialogues = []
    for dia in range(n_dialogues):
        u = int(np.clip(rng.poisson(mean_len), 1, max_len))
        emotion = rng.integers(0, num_classes, size=u).astype(np.int64)
        text = rng.normal(scale=1.0, size=(u, d_text)).astype(np.float32)
        audio = rng.normal(scale=1.0, size=(u, d_audio)).astype(np.float32)
        if learnable:
            text += class_text_means[emotion]
            audio += class_audio_means[emotion]
        dialogues.append({"dialogue_id": dia, "text": text, "audio": audio, "emotion": emotion})
    return dialogues


class SyntheticFusionDataset:
    """Duck-typed FusionDataset over synthetic dialogues."""

    def __init__(self, **kwargs):
        self._dialogues = synthetic_dialogues(**kwargs)
        self.labels = np.concatenate([d["emotion"] for d in self._dialogues])

    def __len__(self) -> int:
        return len(self._dialogues)

    def __getitem__(self, idx: int) -> dict:
        return self._dialogues[idx]

    def get_labels(self) -> np.ndarray:
        return self.labels
