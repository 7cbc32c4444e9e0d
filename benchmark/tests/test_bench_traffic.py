"""The generators: the same seed gives the same inputs; another seed gives
the same sizes in another order."""

import numpy as np

from benchmark.drivers.finetune import ClipPool
from benchmark.drivers.label import Split
from benchmark.harness import meld
from benchmark.tests.tiny_cells import cell

BIG = (1 << 31) + 12345  # more than 32 signed bits hold


def pool(seed):
    c = cell("wav2vec2-base.finetune")
    ladder = [int(s * meld.SAMPLE_RATE) for s in c.traffic["seconds_buckets"]]
    return ClipPool(seed, 40, 4, ladder, c.traffic["durations"])


def widths(p):
    return [meld.bucket(int(p.lengths[i: i + 4].max()), [1600, 3200, 4000]) for i in range(0, len(p), 4)]


def test_pool_is_a_function_of_the_seed():
    a, b = pool(BIG), pool(BIG)
    assert (a.clip_ids == b.clip_ids).all() and (a.lengths == b.lengths).all() and (a.labels == b.labels).all()
    assert all((a.waveform(k) == b.waveform(k)).all() for k in range(len(a)))


def test_pool_seeds_share_sizes():
    a, b = pool(BIG), pool(BIG + 1)
    assert not (a.clip_ids == b.clip_ids).all()
    assert (a.lengths == b.lengths).all()  # the same widths in the same order
    assert widths(a) == widths(b)
    assert not np.array_equal(a.waveform(0), b.waveform(0))


def test_pool_clips_are_pcm():
    a = pool(7)
    w = a.waveform(3)
    assert w.dtype == np.float32 and len(w) == a.lengths[3]
    assert np.array_equal(np.round(w * 32768.0) / 32768.0, w)


def split(seed):
    c = cell("mer-meld.label")
    return Split(seed, c.traffic, c.config["roberta"])


def test_split_is_a_function_of_the_seed():
    a, b = split(BIG), split(BIG)
    for x, y in zip(a.batches, b.batches, strict=True):
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_split_seeds_share_sizes():
    a, b = split(BIG), split(BIG + 1)
    assert [x["text"].shape for x in a.batches] == [y["text"].shape for y in b.batches]
    assert [x["audio"].shape for x in a.batches] == [y["audio"].shape for y in b.batches]
    assert list(a.tokens) == list(b.tokens) and list(a.sizes) == list(b.sizes)
    assert not all(np.array_equal(x["text"], y["text"]) for x, y in zip(a.batches, b.batches))


def test_split_covers_every_row_once():
    a = split(11)
    real = np.concatenate([b["idx"][b["emotion"] != -1] for b in a.batches])
    assert sorted(real) == list(range(len(a.labels)))


def test_interleave_spreads_each_class():
    classes = np.array([0] * 50 + [1] * 30 + [2] * 5)
    order = meld.interleave_by_class(classes)
    assert sorted(order) == list(range(len(classes)))
    for n in range(1, len(classes) + 1):
        for c, share in ((0, 50 / 85), (1, 30 / 85), (2, 5 / 85)):
            assert abs((classes[order[:n]] == c).sum() - n * share) <= 1.0


def test_meld_statistics():
    d = meld.duration_quantiles(9989, meld.MELD_DURATIONS)
    assert 3.1 < d.mean() < 3.3 and d.min() == 0.5 and d.max() == 10.0
    assert meld.dialogue_sizes(280, 2608, 33).sum() == 2608
    w = meld.words_per_utterance(2608, 2, 100)
    assert w.min() >= 2 and w.max() <= 100 and 0.02 < (w >= 51).mean() < 0.08
