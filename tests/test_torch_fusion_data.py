"""The port's fusion data path and metrics against the JAX package's.

Synthetic dialogues, collate, FusionBatcher order and BatchAveragedMetrics
must be identical for the same seed; ``get_text``, ``dialogue_index``,
``load_embeddings`` and ``FusionDataset`` must be equal on the
``meld_like_root`` fixture.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from mer_tpu import core as jax_core
from mer_tpu.core.config import Config as JaxConfig
from mer_tpu.data import fusion as jax_fusion
from mer_tpu.data import synthetic as jax_synthetic
from mer_tpu.objectives import metrics as jax_metrics
from mer_tpu_torch import core
from mer_tpu_torch.core import Config
from mer_tpu_torch.data import fusion, synthetic
from mer_tpu_torch.objectives import metrics


def _assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seed, d", [(0, 8), (2, 12)])
def test_synthetic_dialogues_identical(seed, d):
    got = synthetic.synthetic_dialogues(n_dialogues=20, d_text=d, d_audio=d + 4, seed=seed)
    want = jax_synthetic.synthetic_dialogues(n_dialogues=20, d_text=d, d_audio=d + 4, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["dialogue_id"] == w["dialogue_id"]
        for key in ("text", "audio", "emotion"):
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("n, batch_size", [(3, 5), (5, 5), (1, 4)])
def test_collate_identical(n, batch_size):
    dialogues = synthetic.synthetic_dialogues(n_dialogues=n, d_text=8, d_audio=8, seed=n)
    got = fusion.collate_dialogues(dialogues, batch_size)
    _assert_batches_equal(got, jax_fusion.collate_dialogues(dialogues, batch_size))
    # all-padding rows keep key 0 attendable; pad labels -1, pad features 0
    assert not got["padding_mask"][:, 0].any()
    assert (got["text"][got["emotion"] == -1] == 0).all()


@pytest.mark.parametrize("length", [1, 8, 9, 24, 33, 40])
def test_pick_bucket_identical(length):
    assert fusion.pick_bucket(length, (8, 16, 24, 33)) == jax_fusion.pick_bucket(length, (8, 16, 24, 33))


@pytest.mark.parametrize("shuffle, sort_by_length, batch_size", [
    (False, False, 8), (True, True, 8), (True, False, 9), (False, True, 8),
])
def test_batcher_order_identical(shuffle, sort_by_length, batch_size):
    ds = synthetic.SyntheticFusionDataset(n_dialogues=45, d_text=8, d_audio=8, seed=3)
    kwargs = dict(batch_size=batch_size, shuffle=shuffle, seed=7, sort_by_length=sort_by_length)
    got = fusion.FusionBatcher(ds, **kwargs)
    want = jax_fusion.FusionBatcher(ds, process_index=0, process_count=1, **kwargs)
    assert len(got) == len(want)
    for _ in range(2):  # the shuffle stream carries over between epochs
        got_epoch, want_epoch = list(got), list(want)
        assert len(got_epoch) == len(want_epoch)
        for g, w in zip(got_epoch, want_epoch):
            _assert_batches_equal(g, w)


def test_batch_averaged_metrics_identical():
    rng = np.random.default_rng(0)
    got, want = metrics.BatchAveragedMetrics(), jax_metrics.BatchAveragedMetrics()
    for _ in range(5):
        y_true = rng.integers(-1, 7, size=(4, 9))
        y_pred = rng.integers(0, 7, size=(4, 9))
        got.update(y_true, y_pred)
        want.update(y_true, y_pred)
    assert got.summary() == want.summary()
    assert metrics.weighted_f1(np.array([]), np.array([])) == 0.0


def test_get_text_identical(meld_like_root):
    root, sizes = meld_like_root
    for mode in ("train", "val", "test"):
        got = core.get_text(mode, data_root=root)
        pd.testing.assert_frame_equal(got, jax_core.get_text(mode, data_root=root))
        assert len(got) == sizes[mode]
        assert not got["Utterance"].str.contains("\x92").any()
        pd.testing.assert_frame_equal(core.map_emotions(got), jax_core.map_emotions(got))
        assert core.dialogue_index(got) == jax_core.dialogue_index(got)
    with pytest.raises(ValueError):
        core.get_text("dev", data_root=root)


@pytest.mark.parametrize("as_torch", [True, False])
def test_load_embeddings_identical(tmp_path, as_torch):
    table = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    path = tmp_path / "test.pkl"
    with open(path, "wb") as f:
        pickle.dump(torch.from_numpy(table) if as_torch else table, f)
    got = core.load_embeddings(path)
    np.testing.assert_array_equal(got, jax_core.load_embeddings(path))
    np.testing.assert_array_equal(got, table)
    assert core.embeddings_path(tmp_path, "val") == jax_core.embeddings_path(tmp_path, "val")


def test_fusion_dataset_identical(meld_like_root, tmp_path):
    root, sizes = meld_like_root
    rng = np.random.default_rng(1)
    cfg = {"embeddings": {"text": str(tmp_path / "text"), "audio": str(tmp_path / "audio")}}
    for name, width in (("text", 6), ("audio", 4)):
        os.makedirs(cfg["embeddings"][name])
        with open(core.embeddings_path(cfg["embeddings"][name], "test"), "wb") as f:
            pickle.dump(torch.from_numpy(rng.normal(size=(sizes["test"], width)).astype(np.float32)), f)
    got = fusion.FusionDataset("test", Config(cfg), data_root=root)
    want = jax_fusion.FusionDataset("test", JaxConfig(cfg), data_root=root)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.get_labels(), want.get_labels())
    for i in range(len(want)):
        assert got[i]["dialogue_id"] == want[i]["dialogue_id"]
        for key in ("text", "audio", "emotion"):
            np.testing.assert_array_equal(got[i][key], want[i][key])
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        fusion.FusionDataset("val", Config(cfg), data_root=root)
