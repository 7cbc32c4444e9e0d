"""Offline (whole-split) batch inference (counterpart of
``mer_tpu/serving/offline.py``).

:class:`BatchedPredictor` takes the place of the JAX package's
``ScanPredictor``: batches are grouped by shape, each group is stacked on the
host and moved to the device in one transfer per array, every batch of the
group runs under ``torch.inference_mode()``, and each group's predictions
come back in one fetch, after all groups were dispatched.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

FEED_KEYS = ("text", "audio", "padding_mask")


def recollate_batches(
    batches: list[dict], serving_batch: int = 512
) -> tuple[list[dict], list[tuple[int, tuple[int, int]]]]:
    """Merge same-shape batches into serving batches of up to
    ``serving_batch`` rows. Per-dialogue predictions are unchanged (the batch
    axis is independent); only the products grow.

    Returns (merged_batches, plan): plan[i] = (merged_index, (row_start,
    row_end)) for original batch i, in input order (see split_recollated).
    """
    groups: dict[tuple, list[int]] = {}
    for i, b in enumerate(batches):
        key = tuple(sorted((k, tuple(np.shape(v)[1:]), str(np.asarray(v).dtype)) for k, v in b.items()))
        groups.setdefault(key, []).append(i)

    merged: list[dict] = []
    plan: list[tuple[int, tuple[int, int]] | None] = [None] * len(batches)

    def rows(b: dict) -> int:
        return int(np.shape(next(iter(b.values())))[0])

    def flush(chunk: list[int]) -> None:
        j = len(merged)
        merged.append({k: np.concatenate([np.asarray(batches[i][k]) for i in chunk])
                       for k in batches[chunk[0]].keys()})
        off = 0
        for i in chunk:
            n = rows(batches[i])
            plan[i] = (j, (off, off + n))
            off += n

    for idxs in groups.values():
        # accumulate by cumulative rows: never exceed serving_batch unless a
        # single batch already does
        chunk: list[int] = []
        n_rows = 0
        for i in idxs:
            n = rows(batches[i])
            if chunk and n_rows + n > serving_batch:
                flush(chunk)
                chunk, n_rows = [], 0
            chunk.append(i)
            n_rows += n
        if chunk:
            flush(chunk)
    return merged, plan  # type: ignore[return-value]


def split_recollated(preds: list[np.ndarray], plan) -> list[np.ndarray]:
    """Inverse of :func:`recollate_batches` for per-merged-batch predictions."""
    return [preds[j][s:e] for j, (s, e) in plan]


class BatchedPredictor:
    """Grouped batch inference on one device.

    Args:
        predict_fn: ``(text [b, u, d], audio [b, u, d], padding_mask [b, u])
            -> predictions [b, u]``, device tensors in and out.
        device: where the batches are staged.
    """

    def __init__(self, predict_fn: Callable, device: torch.device | str):
        self._predict = predict_fn
        self.device = torch.device(device)

    def __call__(self, batches: list[dict]) -> list[np.ndarray]:
        """Per-batch host predictions, in input order, for host numpy batches
        holding ``text``, ``audio`` and ``padding_mask``."""
        groups: dict[tuple, list[int]] = {}
        for i, b in enumerate(batches):
            key = tuple((k, np.shape(b[k]), str(np.asarray(b[k]).dtype)) for k in FEED_KEYS)
            groups.setdefault(key, []).append(i)

        out: list[np.ndarray | None] = [None] * len(batches)
        with torch.inference_mode():
            pending = []
            for idxs in groups.values():
                staged = {k: torch.from_numpy(np.stack([batches[i][k] for i in idxs])).to(self.device)
                          for k in FEED_KEYS}
                preds = torch.stack([
                    self._predict(staged["text"][j], staged["audio"][j], staged["padding_mask"][j])
                    for j in range(len(idxs))
                ])
                pending.append((idxs, preds))
            for idxs, preds in pending:  # fetch after every group was dispatched
                host = preds.cpu().numpy()
                for j, i in enumerate(idxs):
                    out[i] = host[j]
        return out  # type: ignore[return-value]
