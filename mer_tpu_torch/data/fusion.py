"""Stage-2 fusion data: dialogue-level batching of embedding tables.

Counterpart of ``mer_tpu/data/fusion.py``, single-process. One item is one
dialogue (utterances sorted by Utterance_ID, stacked [U, D] text and audio
rows plus labels). Collate follows the reference (src/dataset.py:71-89):
features padded with 0.0, labels with -1, ``padding_mask`` True where padded.
Batches are padded to a few length buckets and a fixed batch size, so the
model sees a handful of shapes. :class:`DeviceFusionBatcher` yields the same
batches from tables kept on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from mer_tpu_torch.core import dialogue_index, embeddings_path, get_text, load_embeddings, map_emotions
from mer_tpu_torch.core.config import DEFAULT_LENGTH_BUCKETS


class FusionDataset:
    """Dialogue-level dataset over exported embedding artifacts."""

    def __init__(self, mode: str, config, data_root: str | None = None):
        self.mode = mode
        self.config = config
        try:
            self.text_embeddings = load_embeddings(embeddings_path(config.embeddings.text, mode))
            self.audio_embeddings = load_embeddings(embeddings_path(config.embeddings.audio, mode))
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"{e}\nStage-2 fusion consumes stage-1 embedding artifacts. Run the "
                "feature-extractor exporters first, or use --synthetic for a corpus-free run."
            ) from e

        df = map_emotions(get_text(mode, data_root=data_root))
        if len(df) != len(self.text_embeddings) or len(df) != len(self.audio_embeddings):
            raise ValueError(
                f"Embedding row count mismatch for {mode}: table={len(df)}, "
                f"text={len(self.text_embeddings)}, audio={len(self.audio_embeddings)}"
            )

        self._dialogues: list[dict] = []
        for dia, rows in dialogue_index(df).items():
            rows = np.asarray(rows, dtype=np.int64)
            self._dialogues.append(
                {
                    "dialogue_id": dia,
                    "text": self.text_embeddings[rows],
                    "audio": self.audio_embeddings[rows],
                    "emotion": df.loc[rows, "Emotion"].to_numpy(dtype=np.int64),
                }
            )
        self.labels = df["Emotion"].to_numpy(dtype=np.int64)

    def __len__(self) -> int:
        return len(self._dialogues)

    def __getitem__(self, idx: int) -> dict:
        return self._dialogues[idx]

    def get_labels(self) -> np.ndarray:
        return self.labels


def pick_bucket(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= ``length``; beyond the largest, ``length`` itself."""
    for b in buckets:
        if length <= b:
            return b
    return length


def collate_dialogues(
    dialogues: list[dict],
    batch_size: int,
    buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS,
) -> dict:
    """Pad a list of dialogues into one [batch_size, bucket] batch of numpy
    arrays: ``text``, ``audio`` (f32), ``emotion`` (int32, -1 = pad) and
    ``padding_mask`` (bool, True = pad)."""
    if not dialogues:
        raise ValueError("empty batch")
    d_text = dialogues[0]["text"].shape[-1]
    d_audio = dialogues[0]["audio"].shape[-1]
    u = pick_bucket(max(d["emotion"].shape[0] for d in dialogues), buckets)
    text = np.zeros((batch_size, u, d_text), dtype=np.float32)
    audio = np.zeros((batch_size, u, d_audio), dtype=np.float32)
    emotion = np.full((batch_size, u), -1, dtype=np.int32)
    for i, d in enumerate(dialogues):
        n = d["emotion"].shape[0]
        text[i, :n] = d["text"]
        audio[i, :n] = d["audio"]
        emotion[i, :n] = d["emotion"]

    padding_mask = emotion == -1
    # all-padding rows keep key 0 attendable so their softmax stays finite;
    # metrics still skip them through emotion == -1
    padding_mask[padding_mask.all(axis=1), 0] = False
    return {"text": text, "audio": audio, "emotion": emotion, "padding_mask": padding_mask}


class FusionBatcher:
    """Iterate fixed-shape batches over a FusionDataset (or dialogue list).

    ``shuffle`` permutes dialogues and then the batch order from one seeded
    numpy generator; ``sort_by_length`` groups dialogues of like length
    before batching. Evaluation uses neither, so batches keep dataset order
    and the batch-averaged metrics partition as the reference's do.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS,
        sort_by_length: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.buckets = tuple(buckets)
        self.sort_by_length = sort_by_length
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        if self.sort_by_length:
            lengths = np.asarray([self.dataset[i]["emotion"].shape[0] for i in order])
            # stable sort keeps the shuffled order within equal lengths
            order = order[np.argsort(lengths, kind="stable")]

        for idxs in _batch_order(order, self.batch_size, self.shuffle, self._rng):
            yield collate_dialogues([self.dataset[int(i)] for i in idxs], self.batch_size, self.buckets)


def _batch_order(order: np.ndarray, batch_size: int, shuffle: bool, rng) -> list[np.ndarray]:
    """Cut ``order`` into batches; shuffle their order when ``shuffle``."""
    batches = [order[i : i + batch_size] for i in range(0, len(order), batch_size)]
    if shuffle:
        rng.shuffle(batches)
    return batches


class DeviceFusionBatcher:
    """:class:`FusionBatcher` with the whole dataset resident on ``device``
    (counterpart of ``mer_tpu/data/fusion.py::DeviceFusionBatcher``).

    Every dialogue is padded once to the largest bucket into [N + 1, U, D]
    tables, row N being all padding (features 0, labels -1); a batch is one
    ``index_select`` per table, cut to its bucket, so an epoch copies only
    the batches' indices from the host. With the same seed it yields exactly
    :class:`FusionBatcher`'s batches, as device tensors: ``text``, ``audio``
    f32, ``emotion`` int32 (-1 = pad), ``padding_mask`` bool."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS, sort_by_length: bool = True,
                 device: torch.device | str = "cuda"):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.buckets = tuple(buckets)
        self.sort_by_length = sort_by_length
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        n = len(dataset)
        self._lengths = np.asarray([dataset[i]["emotion"].shape[0] for i in range(n)])
        max_len = max(self.buckets[-1], int(self._lengths.max()))
        text = np.zeros((n + 1, max_len, dataset[0]["text"].shape[-1]), np.float32)
        audio = np.zeros((n + 1, max_len, dataset[0]["audio"].shape[-1]), np.float32)
        emotion = np.full((n + 1, max_len), -1, np.int32)
        for i in range(n):
            d, u = dataset[i], self._lengths[i]
            text[i, :u], audio[i, :u], emotion[i, :u] = d["text"], d["audio"], d["emotion"]
        self._text, self._audio, self._emotion = (torch.from_numpy(a).to(self.device) for a in (text, audio, emotion))
        self._n = n

    def __len__(self) -> int:
        return (self._n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(self._n)
        if self.shuffle:
            self._rng.shuffle(order)
        if self.sort_by_length:
            order = order[np.argsort(self._lengths[order], kind="stable")]
        for idxs in _batch_order(order, self.batch_size, self.shuffle, self._rng):
            bucket = pick_bucket(int(self._lengths[idxs].max()), self.buckets)
            rows = np.full(self.batch_size, self._n, np.int64)  # missing dialogues: the padding row
            rows[: len(idxs)] = idxs
            rows = torch.from_numpy(rows).to(self.device)
            text, audio, emotion = (t[:, :bucket].index_select(0, rows)
                                    for t in (self._text, self._audio, self._emotion))
            padding_mask = emotion == -1
            padding_mask[:, 0] &= ~padding_mask.all(dim=1)  # collate_dialogues: key 0 of an empty row
            yield {"text": text, "audio": audio, "emotion": emotion, "padding_mask": padding_mask}
