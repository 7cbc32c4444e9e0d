"""Synthetic data: MELD-shaped dialogues (counterpart of
``mer_tpu/data/synthetic.py``) and a synthetic MELD root on disk (counterpart
of ``scripts/make_synthetic_meld.py``).

The dialogues come from the same numpy stream as the JAX package's, so one
seed gives identical dialogues: MELD test statistics (280 dialogues, mean
~9.3 utterances, max 33), with class-dependent mean offsets so the labels
are learnable.

The MELD root holds the reference CSV schema and 16 kHz PCM16 wavs, with the
corrupted rows ``get_text`` must drop; the same seed writes the same files
as the script. ``--meld-shape`` writes a test split with the real MELD test
statistics (280 dialogues, exactly 2,608 usable utterances, durations
lognormal with mean ~3.2 s, clipped to [0.5, 10] s) and tiny train and dev
splits. ``--words LO HI`` gives every utterance a seeded number of words in
[LO, HI] (the default is the script's three-word utterance), so the text
extractor's context windows reach the wider token buckets::

    python -m mer_tpu_torch.data.synthetic OUT_DIR [--dialogues N] [--meld-shape] [--words LO HI]
"""

from __future__ import annotations

import argparse
import os

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


# -- a synthetic MELD root on disk ------------------------------------------------

EMOTIONS = ["neutral", "joy", "sadness", "anger", "surprise", "fear", "disgust"]
# csv -> (wav directory, corrupted (dialogue, utterance) rows), reference src/utils.py:53-59
MELD_SPLITS = {
    "train_sent_emo.csv": ("MELD.Raw/train_splits/wav", [(125, 3)]),
    "dev_sent_emo.csv": ("MELD.Raw/dev_splits_complete/wav", [(110, 7)]),
    "test_sent_emo.csv": ("MELD.Raw/output_repeated_splits_test/wav", [(38, 4), (220, 0)]),
}
SAMPLE_RATE = 16000


_WORDS = ("oh", "well", "you", "know", "really", "that", "is", "what", "we", "were", "on", "a", "break", "okay", "fine",
          "could", "this", "be", "any", "more", "coffee", "please", "how", "doing", "no", "way", "pivot", "again")


def _utterance(dia: int, utt: int, words: tuple[int, int] | None) -> str:
    """The script's ``synthetic utterance D-U``, or with ``words`` = (lo, hi)
    a seeded number of words in that range, skewed as MELD's are: most
    utterances in the lowest eighth of the range, one in twenty in its upper
    half. The generator is seeded by (dialogue, utterance), so the text does
    not touch the stream that draws emotions and audio."""
    if words is None:
        return f"synthetic utterance {dia}-{utt}"
    lo, hi = words
    rng = np.random.default_rng([dia, utt])
    if rng.random() < 0.05:
        n = int(rng.integers((lo + hi + 1) // 2, hi + 1))
    else:
        n = int(rng.integers(lo, lo + max((hi - lo) // 8, 0) + 1))
    return " ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), size=n))


def _row(n: int, dia: int, utt: int, emotion: str, words: tuple[int, int] | None = None) -> dict:
    return {"Sr No.": n, "Utterance": _utterance(dia, utt, words), "Speaker": "Synth", "Emotion": emotion,
            "Sentiment": "neutral", "Dialogue_ID": dia, "Utterance_ID": utt, "Season": 1, "Episode": 1,
            "StartTime": "0", "EndTime": "1"}


def _tone(rng, n: int) -> np.ndarray:
    f = float(rng.uniform(150, 800))
    return (0.4 * np.sin(2 * np.pi * f * np.arange(n) / SAMPLE_RATE) + 0.05 * rng.normal(size=n)).astype(np.float32)


def _write_csv(root: str, csv_name: str, rows: list[dict]):
    import pandas as pd

    df = pd.DataFrame(rows)
    os.makedirs(os.path.join(root, "MELD.Raw"), exist_ok=True)
    df.to_csv(os.path.join(root, "MELD.Raw", csv_name), index=False)
    return df


def write_split(root: str, csv_name: str, n_dialogues: int, rng, words: tuple[int, int] | None = None,
                clip_seconds: tuple[float, float] = (0.5, 2.0), max_utterances: int = 7) -> int:
    """One small split: 1-``max_utterances`` (7) utterances a dialogue, clips
    of ``clip_seconds`` (0.5-2 s), the corrupted rows appended; returns the
    usable utterance count."""
    from mer_tpu_torch.data.audio_io import save_wav

    wav_dir, corrupted = MELD_SPLITS[csv_name]
    rows = []
    for dia in range(n_dialogues):
        for utt in range(int(rng.integers(1, max_utterances + 1))):
            rows.append(_row(len(rows) + 1, dia, utt, EMOTIONS[int(rng.integers(0, 7))], words))
    for dia, utt in corrupted:
        rows.append({**rows[-1], "Dialogue_ID": dia, "Utterance_ID": utt, "Utterance": "corrupted"})
    df = _write_csv(root, csv_name, rows)
    out_dir = os.path.join(root, wav_dir)
    os.makedirs(out_dir, exist_ok=True)
    for dia, utt in zip(df["Dialogue_ID"], df["Utterance_ID"]):
        n = int(rng.integers(int(clip_seconds[0] * SAMPLE_RATE), int(clip_seconds[1] * SAMPLE_RATE)))
        save_wav(os.path.join(out_dir, f"dia{dia}_utt{utt}.wav"), _tone(rng, n), SAMPLE_RATE)
    return len(rows) - len(corrupted)


def write_meld_shaped_test(root: str, rng, words: tuple[int, int] | None = None) -> int:
    """The real MELD test shape: 280 dialogues, 2,610 rows of which the two
    corrupted clips are filtered, leaving 2,608 usable utterances."""
    from mer_tpu_torch.data.audio_io import save_wav

    wav_dir, corrupted = MELD_SPLITS["test_sent_emo.csv"]
    n_dialogues, target_rows = 280, 2610
    counts = rng.integers(1, 18, size=n_dialogues)
    counts[38] = max(counts[38], 5)  # dialogue 38 must hold utterance 4
    while counts.sum() != target_rows:  # nudge to the exact row count
        i = int(rng.integers(0, n_dialogues))
        step = 1 if counts.sum() < target_rows else -1
        if 1 <= counts[i] + step <= 33 and not (i == 38 and counts[i] + step < 5):
            counts[i] += step
    rows = []
    for dia in range(n_dialogues):
        for utt in range(int(counts[dia])):
            rows.append(_row(len(rows) + 1, dia, utt, EMOTIONS[int(rng.integers(0, 7))], words))
    df = _write_csv(root, "test_sent_emo.csv", rows)
    out_dir = os.path.join(root, wav_dir)
    os.makedirs(out_dir, exist_ok=True)
    skip = set(corrupted)
    for dia, utt in zip(df["Dialogue_ID"], df["Utterance_ID"]):
        if (dia, utt) in skip:
            continue  # filtered before load; no wav needed
        seconds = float(np.clip(rng.lognormal(1.0, 0.6), 0.5, 10.0))
        save_wav(os.path.join(out_dir, f"dia{dia}_utt{utt}.wav"), _tone(rng, int(seconds * SAMPLE_RATE)),
                 SAMPLE_RATE)
    return len(rows) - len(skip)


def write_synthetic_meld(root: str, n_dialogues: int = 20, meld_shape: bool = False,
                         split_dialogues: dict[str, int] | None = None,
                         words: tuple[int, int] | None = None,
                         clip_seconds: tuple[float, float] = (0.5, 2.0), max_utterances: int = 7) -> dict[str, int]:
    """Write a synthetic MELD root from seed 0; returns usable utterances
    per CSV. ``split_dialogues`` overrides the dialogue count of a small
    split (``{"train_sent_emo.csv": 100}``); ``words`` = (lo, hi) gives every
    utterance that many seeded words instead of the fixed three (labels and
    wavs are the same either way); ``clip_seconds`` is the range of the small
    splits' clip lengths and ``max_utterances`` their most utterances a
    dialogue (1: one clip a dialogue)."""
    rng = np.random.default_rng(0)
    scale = {"train_sent_emo.csv": 1.0, "dev_sent_emo.csv": 0.4, "test_sent_emo.csv": 0.6}
    counts = {}
    for csv_name in MELD_SPLITS:
        if meld_shape and csv_name == "test_sent_emo.csv":
            counts[csv_name] = write_meld_shaped_test(root, rng, words)
            continue
        n_dia = 2 if meld_shape else max(int(n_dialogues * scale[csv_name]), 2)
        n_dia = (split_dialogues or {}).get(csv_name, n_dia)
        counts[csv_name] = write_split(root, csv_name, n_dia, rng, words, clip_seconds, max_utterances)
    return counts


def main(argv=None) -> dict[str, int]:
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.data.synthetic")
    p.add_argument("out_dir", nargs="?", default="data_synth")
    p.add_argument("--dialogues", type=int, default=20)
    p.add_argument("--meld-shape", action="store_true",
                   help="a test split of MELD's test statistics (2,608 usable utterances); train and dev tiny")
    p.add_argument("--words", type=int, nargs=2, metavar=("LO", "HI"), default=None,
                   help="words per utterance, drawn from a seed in [LO, HI] (default: a fixed three-word utterance)")
    args = p.parse_args(argv)
    counts = write_synthetic_meld(args.out_dir, args.dialogues, args.meld_shape,
                                  words=tuple(args.words) if args.words else None)
    for csv_name, n in counts.items():
        print(f"{csv_name}: {n} utterances")
    print(f"Synthetic MELD root at {os.path.abspath(args.out_dir)}")
    return counts


if __name__ == "__main__":
    main()
