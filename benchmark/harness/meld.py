"""MELD-shaped traffic, made from the run's seed.

The statistics are frozen copies of ``mer_tpu_torch/data/synthetic.py`` at
commit 88254f0 (the synthetic MELD root's test split and its ``--words``
skew) and MELD's own split sizes:

- clip durations lognormal(1.0, 0.6) in seconds, clipped to [0.5, 10]
  (mean about 3.2 s), 16 kHz;
- words per utterance in [lo, hi]: one in twenty in the upper half of the
  range, the rest in its lowest eighth;
- a tone of 150-800 Hz at 0.4 plus noise at 0.05, as 16-bit samples.

Every seed gets the same sizes: the durations, word counts and dialogue
sizes are one fixed draw (the yardstick's own stream), and the seed decides
the samples, the token ids, the labels and, where the batches stay the
same, which clip takes which size. So two seeds give the device the same
work, and two runs of one seed the same inputs.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

SAMPLE_RATE = 16000
MELD_DURATIONS = {"log_mean": 1.0, "log_sigma": 0.6, "clip": [0.5, 10.0]}  # a traffic file's ``durations``
NUM_CLASSES = 7
SIZES_SEED = 20240601  # the fixed stream of sizes every seed shares
_BASE_SAMPLES = 1 << 21  # the seeded signal every clip is cut from (131 s)


def seeded_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


def duration_quantiles(n: int, durations: dict) -> np.ndarray:
    """``n`` clip durations in seconds at the quantiles (i + 0.5) / n of a
    lognormal (``durations``: ``log_mean``, ``log_sigma`` and the ``clip``
    range, as :data:`MELD_DURATIONS`), ascending: the pool's sizes, the same
    for every seed."""
    dist = NormalDist(durations["log_mean"], durations["log_sigma"])
    seconds = np.array([math.exp(dist.inv_cdf((i + 0.5) / n)) for i in range(n)])
    return np.clip(seconds, *durations["clip"])


def seconds_to_samples(seconds: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(seconds) * SAMPLE_RATE).astype(np.int64)


def bucket(n: int, ladder) -> int:
    """The smallest rung of ``ladder`` that holds ``n``; the last rung past it."""
    for rung in ladder:
        if n <= rung:
            return int(rung)
    return int(ladder[-1])


class SignalBank:
    """Clip ``j`` of a seed: a cut of one seeded 16-bit signal at an offset
    that a hash of (seed, j) picks, so a clip is a function of (seed, clip
    index) and costs a slice. Values are multiples of 1 / 32768 in float32,
    as a 16-bit wav decodes."""

    def __init__(self, seed: int):
        rng = seeded_rng(seed, 1)
        # tones of 150-800 Hz changing every quarter second, plus noise
        freq = np.repeat(rng.uniform(150, 800, size=_BASE_SAMPLES // 4000 + 1), 4000)[:_BASE_SAMPLES]
        signal = 0.4 * np.sin(2 * np.pi * np.cumsum(freq) / SAMPLE_RATE) + 0.05 * rng.standard_normal(_BASE_SAMPLES)
        pcm = np.clip(np.round(signal * 32768.0), -32768, 32767)
        self.base = (pcm / 32768.0).astype(np.float32)
        self.seed = int(seed)

    def offset(self, j: int, n: int) -> int:
        h = (self.seed * 0x9E3779B97F4A7C15 + (int(j) + 1) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        h ^= h >> 31
        return int(h % (len(self.base) - n + 1))

    def clip(self, j: int, n: int) -> np.ndarray:
        o = self.offset(j, n)
        return self.base[o: o + n]


def words_per_utterance(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` word counts with the synthetic root's skew, from the fixed stream."""
    rng = seeded_rng(SIZES_SEED, 2)
    long = rng.random(n) < 0.05
    out = rng.integers(lo, lo + max((hi - lo) // 8, 0) + 1, size=n)
    out[long] = rng.integers((lo + hi + 1) // 2, hi + 1, size=int(long.sum()))
    return out


def dialogue_sizes(n_dialogues: int, n_utterances: int, max_size: int) -> np.ndarray:
    """Utterances per dialogue, 1-17 nudged to sum to ``n_utterances`` (the
    synthetic root's MELD-shaped test split), from the fixed stream."""
    rng = seeded_rng(SIZES_SEED, 3)
    counts = rng.integers(1, 18, size=n_dialogues)
    while counts.sum() != n_utterances:
        i = int(rng.integers(0, n_dialogues))
        step = 1 if counts.sum() < n_utterances else -1
        if 1 <= counts[i] + step <= max_size:
            counts[i] += step
    return counts


def interleave_by_class(classes: np.ndarray) -> np.ndarray:
    """An order of the items that spreads every class evenly: the k-th of a
    class of n sits at (k + 0.5) / n, ties by class then position. Any
    prefix then holds each class in its share, within one item."""
    classes = np.asarray(classes)
    key = np.empty(len(classes))
    for c in np.unique(classes):
        where = np.flatnonzero(classes == c)
        key[where] = (np.arange(len(where)) + 0.5) / len(where)
    return np.lexsort((np.arange(len(classes)), classes, key))
