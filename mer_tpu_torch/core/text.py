"""MELD utterance tables (counterpart of ``mer_tpu/core/text.py``).

``get_text`` follows the reference's src/utils.py:33-76: read
``{train,dev,test}_sent_emo.csv``, drop the four corrupted clips and fix
cp1252 mojibake.
"""

from __future__ import annotations

import os

import pandas as pd

from mer_tpu_torch.core.config import EMOTION_LABELS

_SPLIT_CSV = {
    "train": "train_sent_emo.csv",
    "val": "dev_sent_emo.csv",
    "test": "test_sent_emo.csv",
}

# Corrupted multimedia clips removed per split (reference src/utils.py:53-59).
_CORRUPTED = {
    "train": [(125, 3)],
    "val": [(110, 7)],
    "test": [(38, 4), (220, 0)],
}

# cp1252 -> utf-8 character fixes (reference src/utils.py:63-74).
_CP1252_TO_UTF8 = {
    "\x85": "…",  # HORIZONTAL ELLIPSIS
    "\x91": "‘",  # LEFT SINGLE QUOTATION MARK
    "\x92": "’",  # RIGHT SINGLE QUOTATION MARK
    "\x93": "“",  # LEFT DOUBLE QUOTATION MARK
    "\x94": "”",  # RIGHT DOUBLE QUOTATION MARK
    "\x96": "–",  # EN DASH
    "\x97": "—",  # EM DASH
    "\xa0": " ",       # NO-BREAK SPACE
}


def get_text(mode: str = "train", data_root: str | None = None) -> pd.DataFrame:
    """Load the cleaned utterance table of a split ("train" | "val" | "test");
    ``data_root`` holds ``MELD.Raw`` (default ``./data``)."""
    if mode not in _SPLIT_CSV:
        raise ValueError(f"Invalid mode {mode}")

    root = os.path.join(os.path.abspath(data_root or "data"), "MELD.Raw")
    data_path = os.path.join(root, _SPLIT_CSV[mode])
    if not os.path.exists(data_path):
        raise FileNotFoundError(f"Dataset not found at {data_path}")

    df = pd.read_csv(data_path, usecols=["Utterance", "Emotion", "Dialogue_ID", "Utterance_ID"])
    for dia, utt in _CORRUPTED[mode]:
        df = df[(df["Dialogue_ID"] != dia) | (df["Utterance_ID"] != utt)]
    df = df.reset_index(drop=True)

    def _fix(s: str) -> str:
        for bad, good in _CP1252_TO_UTF8.items():
            s = s.replace(bad, good)
        return s

    df["Utterance"] = df["Utterance"].map(_fix)
    return df


def map_emotions(df: pd.DataFrame) -> pd.DataFrame:
    """Copy of ``df`` with emotion strings mapped to class indices
    (reference src/dataset.py:22-23)."""
    df = df.copy()
    df["Emotion"] = df["Emotion"].map(EMOTION_LABELS)
    return df


def dialogue_index(df: pd.DataFrame) -> dict[int, list[int]]:
    """Dialogue_ID -> row indices of ``df`` sorted by Utterance_ID."""
    out: dict[int, list[int]] = {}
    order = df.sort_values(["Dialogue_ID", "Utterance_ID"])
    for row_idx, dia in zip(order.index.to_list(), order["Dialogue_ID"].to_list()):
        out.setdefault(int(dia), []).append(int(row_idx))
    return out
