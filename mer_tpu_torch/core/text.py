"""MELD utterance tables (counterpart of ``mer_tpu/core/text.py``).

``get_text`` follows the reference's src/utils.py:33-76: read
``{train,dev,test}_sent_emo.csv``, drop the four corrupted clips and fix
cp1252 mojibake. ``get_utterance_with_context`` builds the text extractor's
``prev <sep> current <sep> next`` strings (reference text/utils.py:61-92).
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


def get_utterance_with_context(df: pd.DataFrame, idx: int, separator: str) -> str:
    """``prev <sep> current <sep> next`` for row ``idx`` of ``df``: the
    neighbours are the utterances before and after it in its dialogue's sorted
    ``Utterance_ID`` order; a missing neighbour leaves a bare separator on
    that side."""
    row = df.iloc[idx]
    dialogue = df[df["Dialogue_ID"] == int(row["Dialogue_ID"])]
    utt_ids = sorted(dialogue["Utterance_ID"].to_list())
    pos = utt_ids.index(int(row["Utterance_ID"]))

    def utterance(utt_id) -> str:
        return dialogue[dialogue["Utterance_ID"] == utt_id].iloc[0]["Utterance"]

    parts = [utterance(utt_ids[pos - 1])] if pos > 0 else []
    parts += [separator, str(row["Utterance"]), separator]
    if pos < len(utt_ids) - 1:
        parts.append(utterance(utt_ids[pos + 1]))
    return " ".join(str(p) for p in parts)


def dialogue_index(df: pd.DataFrame) -> dict[int, list[int]]:
    """Dialogue_ID -> row indices of ``df`` sorted by Utterance_ID."""
    out: dict[int, list[int]] = {}
    order = df.sort_values(["Dialogue_ID", "Utterance_ID"])
    for row_idx, dia in zip(order.index.to_list(), order["Dialogue_ID"].to_list()):
        out.setdefault(int(dia), []).append(int(row_idx))
    return out
