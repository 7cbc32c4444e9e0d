"""Text feature-extractor data (stage 1a; counterpart of
``mer_tpu/data/text_fe.py``).

Reference behaviour (text/dataset.py): an item is the context string
``prev </s> current </s> next`` of an utterance
(:func:`~mer_tpu_torch.core.text.get_utterance_with_context`), tokenized in the
collate with ``padding='longest'`` and truncation at 512 tokens. As in
``mer_tpu``, the tokenizer is built once and the token width pads to a fixed
ladder (64 / 128 / 256 / 512), so the encoder and the attention kernels see a
handful of shapes. Batches are host numpy; :func:`text_batch_to_inputs` makes
the model's tensors on the device. Single process.

Without the Hugging Face tokenizer files (vocab and merges of
``roberta-base``; none is in the repository and nothing is downloaded) the
entry points run with :class:`ToyWhitespaceTokenizer` (``--toy-tokenizer``).
Its ids come from Python's ``hash`` of each word, which changes from process
to process unless ``PYTHONHASHSEED`` is set: set it where two runs must see
the same tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from mer_tpu_torch.core import get_text, get_utterance_with_context, map_emotions
from mer_tpu_torch.data.process_sharding import local_num_batches, resolve_process, shard_batches

TOKEN_BUCKETS = (64, 128, 256, 512)


def pad_tokens_to(ids: np.ndarray, mask: np.ndarray, width: int, pad_id: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokenized [B, T] ``ids`` / ``mask`` widened to ``width`` columns (pad id
    and 0), what tokenizing with ``pad_to=width`` would give. Pads only:
    truncation belongs to the tokenizer, and T > width raises."""
    t = ids.shape[1]
    if t > width:
        raise ValueError(f"pad_tokens_to only pads: {t} tokens do not fit {width}; tokenize with pad_to to truncate")
    extra = ((0, 0), (0, width - t))
    return np.pad(ids, extra, constant_values=pad_id), np.pad(mask, extra)


class HFTokenizerAdapter:
    """A Hugging Face tokenizer behind the interface the batcher uses:
    ``tokenizer(texts, pad_to=None)`` -> (ids, mask) int32 [B, T]."""

    def __init__(self, tokenizer, max_length: int = 512):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.sep_token = tokenizer.sep_token
        self.pad_id = int(tokenizer.pad_token_id)

    def __call__(self, texts: list[str], pad_to: int | None = None):
        enc = self.tokenizer(texts, padding="max_length" if pad_to else "longest",
                             max_length=pad_to or self.max_length, truncation=True, return_tensors="np")
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)


def load_roberta_tokenizer(name: str = "roberta-base") -> HFTokenizerAdapter:
    """The Hugging Face RoBERTa tokenizer from local files (``name`` a
    directory or a cached model id), built once. Nothing is downloaded: a
    missing ``transformers`` package or missing files raise."""
    try:
        from transformers import RobertaTokenizerFast

        return HFTokenizerAdapter(RobertaTokenizerFast.from_pretrained(name, local_files_only=True))
    except Exception as e:  # ImportError, OSError or whatever the package raises for missing files
        raise RuntimeError(f"RoBERTa tokenizer '{name}' unavailable (no transformers package or no local tokenizer "
                           f"files): {e}. Stage the files locally and pass --pretrained <dir>, or run with "
                           "--toy-tokenizer.") from e


class ToyWhitespaceTokenizer:
    """Hash-vocabulary tokenizer for tests and synthetic runs (no tokenizer
    files): ``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, a word ``3 + hash(word) %
    (vocab_size - 3)``."""

    def __init__(self, vocab_size: int = 1000, max_length: int = 512):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.sep_token = "</s>"
        self.pad_id, self.bos_id, self.eos_id = 1, 0, 2

    def __call__(self, texts: list[str], pad_to: int | None = None):
        rows = []
        for text in texts:
            words = [3 + hash(w) % (self.vocab_size - 3) for w in text.split()]
            rows.append(([self.bos_id] + words + [self.eos_id])[: self.max_length])
        width = pad_to or max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), width), dtype=np.int32)
        for i, row in enumerate(rows):
            row = row[:width]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


class TextFeatureDataset:
    """The context-window strings and labels of a split, in table order."""

    def __init__(self, mode: str, tokenizer, data_root: str | None = None):
        self.mode = mode
        self.tokenizer = tokenizer
        df = map_emotions(get_text(mode, data_root=data_root))
        self.df = df
        self.labels = df["Emotion"].to_numpy(dtype=np.int64)
        self.texts = [get_utterance_with_context(df, i, tokenizer.sep_token) for i in range(len(df))]

    def __len__(self) -> int:
        return len(self.df)

    def get_labels(self) -> np.ndarray:
        return self.labels


def text_batch_to_inputs(batch: dict, device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(input ids [B, T] int64, attention mask [B, T] int32) on ``device``."""
    return (torch.from_numpy(batch["text"]).to(device, torch.int64),
            torch.from_numpy(batch["attention_mask"]).to(device))


class TextBatcher:
    """Batches of ``batch_size`` utterances: ``idx`` [B], ``text`` and
    ``attention_mask`` [B, width] int32, ``emotion`` [B] int32. The width is
    the smallest bucket that holds the batch's longest row (longer rows are
    truncated to the largest bucket by the tokenizer); the last batch is
    filled by repeating its last row with ``emotion`` -1."""

    def __init__(self, dataset: TextFeatureDataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 buckets: tuple[int, ...] = TOKEN_BUCKETS, process_index: int | None = None,
                 process_count: int | None = None):
        self.dataset = dataset
        self.process_index, self.process_count = resolve_process(process_index, process_count)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.buckets = buckets
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return local_num_batches(-(-len(self.dataset) // self.batch_size), self.process_index, self.process_count)

    def _bucket(self, longest: int) -> int:
        return next((b for b in self.buckets if longest <= b), self.buckets[-1])

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        tokenizer = self.dataset.tokenizer
        for start in shard_batches(range(0, n, self.batch_size), self.process_index, self.process_count):
            idx = order[start: start + self.batch_size]
            pad = self.batch_size - len(idx)
            full_idx = np.concatenate([idx, idx[-1:].repeat(pad)]) if pad else idx
            texts = [self.dataset.texts[j] for j in full_idx]
            ids, mask = tokenizer(texts)
            width = self._bucket(ids.shape[1])
            if ids.shape[1] <= width:
                ids, mask = pad_tokens_to(ids, mask, width, tokenizer.pad_id)
            else:  # longer than the largest bucket: the tokenizer truncates
                ids, mask = tokenizer(texts, pad_to=width)
            emotion = self.dataset.labels[full_idx].astype(np.int32).copy()
            if pad:
                emotion[len(idx):] = -1
            yield {"idx": full_idx, "text": ids, "attention_mask": mask, "emotion": emotion}
