"""The port's mel feature extractor (stage 1c) against the JAX package's, on the CPU.

- mining: the sampler's draws, hard mining, the semi-hard mask and the
  semi-hard miner give ``mer_tpu``'s indices exactly, from the same seed;
- losses: adaptive and fixed triplet, variance, covariance and the
  composite within 1e-6 relative;
- data: wav I/O, the embedding pickles and the synthetic MELD writer equal
  ``mer_tpu``'s and ``scripts/make_synthetic_meld.py``'s; the ``--meld-shape``
  test split holds 2,608 usable clips;
- on ``conftest.py::meld_like_root_with_wavs`` at ``max_duration`` 0.5 s:
  spectrogram batches (from the wavs and from the device cache) within one
  quantisation step (1/255 + 1e-6); 3 f32 solver steps from the same weights
  and caches mine the same rows and give losses within 1e-4 (observed
  2.3e-5 on losses near 70); the test split's table after them, exported
  from the wavs, within 1e-3 (observed 3.1e-4: a few pixels part by one
  quantisation step between the frontends); ``fit`` with early stopping,
  restore and resume; the entry points on the CPU, and without a card;
- ``solver.async_mining``: three steps mine ``mer_tpu``'s async epoch's
  indices with losses within 1e-4, and equal to the bit a synchronous loop
  that mines with the weights one step stale;
- ``AUDIO.augmentation_factor`` 2: the native batch decode equals
  ``mer_tpu``'s, the variant-0 rows of an augmented batch equal the clean
  batch exactly, the others change, and a wav at 8 kHz is resampled as
  ``mer_tpu``'s store does (within 1e-6).
"""

import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mer_tpu.core import load_config as jax_load_config
from mer_tpu.core.artifacts import load_embeddings as jax_load_embeddings
from mer_tpu.data import MelFeatureDataset as JaxMelFeatureDataset
from mer_tpu.data.audio_io import load_wav as jax_load_wav
from mer_tpu.data.audio_io import save_wav as jax_save_wav
from mer_tpu.mining import triplet as jax_triplet
from mer_tpu.models.resnet import AudioMelFeatureExtractor as JaxExtractor
from mer_tpu.objectives import embedding as jax_embedding
from mer_tpu.train import MelSolver as JaxMelSolver
from mer_tpu_torch.core import get_text, load_config, load_embeddings, save_embeddings
from mer_tpu_torch.data import MelFeatureDataset, write_synthetic_meld
from mer_tpu_torch.data import audio_io
from mer_tpu_torch.feature_extractors.audio_mel import MEL_CONFIG_PATH
from mer_tpu_torch.feature_extractors.audio_mel import embeddings as embeddings_entry
from mer_tpu_torch.feature_extractors.audio_mel import train as train_entry
from mer_tpu_torch.mining import triplet
from mer_tpu_torch.models import AudioMelFeatureExtractor, mel_state_dict_from_jax
from mer_tpu_torch.objectives import embedding
from mer_tpu_torch.train.checkpoint import load_checkpoint
from mer_tpu_torch.train.mel_solver import MelSolver

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
STEP = 1 / 255 + 1e-6
SMALL = {"DEBUG__enabled": True, "DEBUG__num_samples": 16}  # every split cut to its first 16 rows
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tests run in several worker processes at once; torch's default pool
    (one thread per core in every worker) oversubscribes the cores and slows
    the CPU convolutions here tenfold. Two threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_mel_config(path, **overrides):
    """config_audio_mel.yaml at 0.5 s clips, pools of 16, batches of 8, the
    checkpoints beside ``path``."""
    with open(MEL_CONFIG_PATH) as f:
        raw = yaml.safe_load(f)
    raw["AUDIO"]["max_duration"] = 0.5
    raw["solver"]["len_triplet_picking"] = 16
    for mode in ("train", "val", "test"):
        raw[mode]["data_loader"]["batch_size"] = BATCH
    ckpt = os.path.join(os.path.dirname(path), "ckpt", "checkpoint.ckpt")
    raw["checkpoint"].update(save_path=ckpt, load_path=ckpt)
    for dotted, value in overrides.items():
        node = raw
        *parents, leaf = dotted.split("__")
        for part in parents:
            node = node[part]
        node[leaf] = value
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


# -- mining ------------------------------------------------------------------------


def test_sampler_and_mining_indices_equal_jax():
    labels = np.random.default_rng(0).integers(0, 7, size=300)
    labels[labels == 6] = 5  # an empty class
    for method, arg in (("sample_class_uniform", 100), ("sample_random_triplets", 24)):
        got = getattr(triplet.TripletIndexSampler(labels, seed=3), method)(arg)
        want = getattr(jax_triplet.TripletIndexSampler(labels, seed=3), method)(arg)
        for g, w in zip(got if isinstance(got, tuple) else [got], want if isinstance(want, tuple) else [want]):
            np.testing.assert_array_equal(g, w)

    rng = np.random.default_rng(1)
    emb = rng.normal(size=(96, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    pool_labels = rng.integers(0, 7, size=96)
    got = triplet.hard_triplets_from_pool(torch.from_numpy(emb), torch.from_numpy(pool_labels), 32)
    want = jax_triplet.hard_triplets_from_pool(jnp.asarray(emb), jnp.asarray(pool_labels), 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(triplet.cdist(torch.from_numpy(emb), torch.from_numpy(emb)).numpy(),
                               np.asarray(jax_triplet.cdist(jnp.asarray(emb), jnp.asarray(emb))), rtol=0, atol=1e-6)

    a, p, n = (torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)) for _ in range(3))
    np.testing.assert_array_equal(triplet.semihard_mask(a, p, n, 1.0).numpy(),
                                  np.asarray(jax_triplet.semihard_mask(*(jnp.asarray(t.numpy()) for t in (a, p, n)), 1.0)))

    table = rng.normal(size=(300, 16)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    port_miner = triplet.TripletMiner(labels, lambda idx: torch.from_numpy(table[idx]), len_triplet_picking=40, seed=5)
    jax_miner = jax_triplet.TripletMiner(labels, lambda idx: jnp.asarray(table[idx]), len_triplet_picking=40, seed=5)
    for mining_type in ("hard", "semi-hard", "random"):
        for g, w in zip(port_miner.mine(8, mining_type), jax_miner.mine(8, mining_type)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port_miner.mine_hard_rows_device(8).numpy(),
                                  np.asarray(jax_miner.mine_hard_rows_device(8)))
    assert port_miner.stats == jax_miner.stats


# -- losses ------------------------------------------------------------------------


@pytest.mark.parametrize("name, kwargs", [
    ("adaptive_triplet_margin_loss", {}), ("triplet_margin_loss", {}), ("variance_loss", {}),
    ("covariance_loss", {}), ("m2fnet_audio_embedding_loss", {}),
    ("m2fnet_audio_embedding_loss", {"adaptive": False, "variance_enabled": False}),
])
def test_losses_match_jax(name, kwargs):
    rng = np.random.default_rng(len(name))
    a, p, n = (rng.normal(size=(24, 300)).astype(np.float32) * 0.1 for _ in range(3))
    got = getattr(embedding, name)(*(torch.from_numpy(x) for x in (a, p, n)), **kwargs)
    want = getattr(jax_embedding, name)(*(jnp.asarray(x) for x in (a, p, n)), **kwargs)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# -- data --------------------------------------------------------------------------


def test_wav_io_and_embedding_pickles_equal_jax(tmp_path):
    wave = np.random.default_rng(0).uniform(-1.1, 1.1, size=1234).astype(np.float32)
    audio_io.save_wav(tmp_path / "port.wav", wave, 16000)
    jax_save_wav(tmp_path / "jax.wav", wave, 16000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got, sr = audio_io.load_wav(tmp_path / "jax.wav")
    want, _ = jax_load_wav(tmp_path / "jax.wav")
    assert sr == 16000
    np.testing.assert_array_equal(got, want)
    audio_io.save_wav(tmp_path / "dia0_utt0.wav", wave, 8000)  # another rate: resampled as mer_tpu's store does
    from mer_tpu.data.audio_io import WaveformStore as JaxWaveformStore

    np.testing.assert_allclose(audio_io.WaveformStore(str(tmp_path)).get(0, 0),
                               JaxWaveformStore(str(tmp_path)).get(0, 0), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sample rate"):
        audio_io.WaveformStore(str(tmp_path), resample_if_needed=False).get(0, 0)

    table = np.random.default_rng(1).normal(size=(7, 300)).astype(np.float32)
    save_embeddings(tmp_path / "emb" / "test.pkl", table)
    with open(tmp_path / "emb" / "test.pkl", "rb") as f:
        assert isinstance(pickle.load(f), torch.Tensor)  # the reference layout
    np.testing.assert_array_equal(load_embeddings(tmp_path / "emb" / "test.pkl"), table)
    np.testing.assert_array_equal(jax_load_embeddings(tmp_path / "emb" / "test.pkl"), table)


def _script():
    spec = importlib.util.spec_from_file_location("make_synthetic_meld",
                                                  os.path.join(REPO_ROOT, "scripts", "make_synthetic_meld.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_meld_writer_equals_the_script(tmp_path, monkeypatch):
    script = _script()
    rng = np.random.default_rng(0)
    for csv_name, (wav_dir, corrupted) in script.SPLITS.items():
        script.make_split(str(tmp_path / "script"), csv_name, wav_dir, corrupted, 3, rng)
    counts = write_synthetic_meld(str(tmp_path / "port"), n_dialogues=3,
                                  split_dialogues={name: 3 for name in script.SPLITS})
    files = sorted(p.relative_to(tmp_path / "script") for p in (tmp_path / "script").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "script" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes(), rel
    for mode, csv_name in (("train", "train_sent_emo.csv"), ("val", "dev_sent_emo.csv"), ("test", "test_sent_emo.csv")):
        assert len(get_text(mode, str(tmp_path / "port"))) == counts[csv_name]

    written = []
    monkeypatch.setattr(audio_io, "save_wav", lambda path, wave, sr: written.append(os.path.basename(path)))
    counts = write_synthetic_meld(str(tmp_path / "shape"), meld_shape=True)
    test = get_text("test", str(tmp_path / "shape"))
    assert counts["test_sent_emo.csv"] == len(test) == 2608 == sum(w.startswith("dia") for w in written) - \
        sum(counts[name] + len(corrupted) for name, (_, corrupted) in script.SPLITS.items() if name != "test_sent_emo.csv")
    assert test["Dialogue_ID"].nunique() == 280


# -- dataset, solver and entry points against mer_tpu ------------------------------


@pytest.fixture(scope="module")
def mel(meld_like_root_with_wavs, tmp_path_factory):
    """mer_tpu's solver after 3 f32 steps (rows, losses, the test split's
    table) and its starting weights, on the tiny wav root."""
    root, _ = meld_like_root_with_wavs
    tmp = tmp_path_factory.mktemp("torch_mel")
    jcfg = jax_load_config(_write_mel_config(str(tmp / "jax" / "mel.yaml")))
    jtrain, jval = (JaxMelFeatureDataset(mode, jcfg, data_root=root) for mode in ("train", "val"))
    jsolver = JaxMelSolver(JaxExtractor(), jcfg, jtrain, jval, seed=0)
    jstate = jsolver.init_state()
    start = (jax.tree.map(np.array, jstate.params), jax.tree.map(np.asarray, jsolver._batch_stats))
    rows, losses = [], []
    for _ in range(3):
        r = jsolver._miner(jtrain, jstate.params).mine_hard_rows_device(BATCH)
        rows.append(np.asarray(r))
        jstate, loss = jsolver._train_step(jstate, jtrain.spectrogram_batch(r))
        losses.append(float(loss))
    jtest = JaxMelFeatureDataset("test", jcfg, data_root=root)
    table = jsolver.export_embeddings(jtest, jstate.params, batch_size=BATCH)
    return {"root": root, "tmp": tmp, "jcfg": jcfg, "jtrain": jtrain, "jval": jval, "start": start, "rows": rows,
            "losses": losses, "table": table}


def _port_solver(mel, config_path):
    config = load_config(config_path)
    model = AudioMelFeatureExtractor()
    model.load_state_dict(mel_state_dict_from_jax(*mel["start"]), strict=True)
    data = {mode: MelFeatureDataset(mode, config, data_root=mel["root"], device=CPU) for mode in ("train", "val")}
    return config, MelSolver(model, config, data["train"], data["val"], seed=0)


def test_spectrogram_batches_within_one_step(mel):
    config = load_config(_write_mel_config(str(mel["tmp"] / "spec.yaml")))
    port = MelFeatureDataset("train", config, data_root=mel["root"], device=CPU)
    idx = np.arange(len(port))
    assert port.mel_cfg.max_frames == 51
    got = port.spectrogram_batch(idx)
    want = np.asarray(mel["jtrain"]._spectrogram_from_waveforms(idx)).transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (len(port), 3, 51, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STEP)
    port.build_device_cache(chunk=5)  # ragged last chunk
    assert port.device_cache.dtype == torch.uint8
    cached = port.spectrogram_batch(torch.from_numpy(idx[::-1].copy()))
    np.testing.assert_array_equal(cached.numpy(), got.numpy()[::-1])
    np.testing.assert_allclose(cached.numpy(), np.asarray(mel["jtrain"].spectrogram_batch(idx[::-1].copy()))
                               .transpose(0, 3, 1, 2), rtol=0, atol=STEP)


def test_three_solver_steps_and_export_match_jax(mel):
    """Same weights, same sampler seed: the same mined rows, losses within
    1e-4, and the test split's table within 1e-3 of mer_tpu's after them."""
    _, solver = _port_solver(mel, _write_mel_config(str(mel["tmp"] / "steps.yaml")))
    # mer_tpu's caches, so the steps see the same pixels (the two frontends
    # part by one quantisation step on a few; see the test above)
    for port_ds, jax_ds in ((solver.data_train, mel["jtrain"]), (solver.data_val, mel["jval"])):
        port_ds.device_cache = torch.from_numpy(np.array(jax_ds._device_cache))
    state = solver.init_state()
    losses = []
    for want_rows in mel["rows"]:
        rows = solver._miner(solver.data_train).mine_hard_rows_device(BATCH)
        np.testing.assert_array_equal(rows.numpy(), want_rows)
        losses.append(solver.train_step(state, solver.data_train.spectrogram_batch(rows)).item())
    np.testing.assert_allclose(losses, mel["losses"], rtol=0, atol=1e-4)
    assert state.step == 3
    test = MelFeatureDataset("test", solver.config, data_root=mel["root"], device=CPU)
    table = solver.export_embeddings(test, batch_size=BATCH)
    assert table.shape == mel["table"].shape == (len(test), 300) and len(test) % BATCH  # a padded last batch
    np.testing.assert_allclose(table, mel["table"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(table, axis=1), 1.0, rtol=0, atol=1e-5)


def test_fit_early_stopping_restore_and_resume(mel, monkeypatch):
    """Validation losses are scripted so the early-stopping path is known:
    epochs 0, 1 score 1.0, 0.9 (new bests); the checkpoint of epoch 1 holds
    min_loss_val 1.0 (as mer_tpu's, written before the epoch's update). The
    resumed run scores 1.5 >= 1.0 at epoch 2 and, with patience 1, stops and
    promotes the best weights (epoch 1) to the checkpoint."""
    path = _write_mel_config(str(mel["tmp"] / "fit" / "mel.yaml"), solver__epochs=2,
                             solver__early_stopping__patience=1, **SMALL)
    scripted = iter([1.0, 0.9, 1.5])
    monkeypatch.setattr(MelSolver, "validate", lambda self: next(scripted))
    config, solver = _port_solver(mel, path)
    state, history = solver.fit()
    steps = len(solver.data_train) // BATCH
    assert history["val_loss_values"] == [1.0, 0.9] and len(history["loss_values"]) == 2
    assert all(np.isfinite(history["loss_values"])) and state.step == 2 * steps
    saved = load_checkpoint(config.checkpoint.save_path)
    assert saved["epoch"] == 1 and saved["extra"] == {"step": 2 * steps, "min_loss_val": 1.0, "patience_counter": 0}
    best = load_checkpoint(os.path.join(os.path.dirname(config.checkpoint.save_path), "best_weights.ckpt"))
    assert best["epoch"] == 1

    resume = load_config(path).override(solver__epochs=4, checkpoint__load_checkpoint=True)
    _, solver = _port_solver(mel, path)
    solver.config = resume
    state, history = solver.fit()
    assert history["val_loss_values"] == [1.5] and state.step == 3 * steps
    promoted = load_checkpoint(resume.checkpoint.save_path)
    assert promoted["epoch"] == 1
    for name, value in best["model_state_dict"].items():
        torch.testing.assert_close(promoted["model_state_dict"][name], value, rtol=0, atol=0)
        torch.testing.assert_close(state.model.state_dict()[name], value, rtol=0, atol=0)


def test_entry_points_on_cpu(mel, tmp_path, capsys):
    """train -> checkpoint -> embeddings: [N, 300] unit-norm tables for each
    split that both packages' ``load_embeddings`` read."""
    path = _write_mel_config(str(tmp_path / "mel.yaml"), solver__epochs=1, **SMALL)
    argv = ["--config", path, "--data-root", mel["root"], "--device", "cpu"]
    state, history = train_entry.main(argv)
    assert len(history["loss_values"]) == 1 and np.isfinite(history["loss_values"][0])
    tables = embeddings_entry.main(argv, save_dir=str(tmp_path / "emb"))
    out = capsys.readouterr().out
    assert "Training complete" in out and "DEBUG.visualize is ignored" in out
    for mode, table in tables.items():
        assert table.shape == (SMALL["DEBUG__num_samples"], 300)
        np.testing.assert_allclose(np.linalg.norm(table, axis=1), 1.0, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(jax_load_embeddings(tmp_path / "emb" / f"{mode}.pkl"), table)
    saved = load_checkpoint(load_config(path).checkpoint.save_path)["model_state_dict"]
    for name, value in state.model.state_dict().items():
        torch.testing.assert_close(saved[name], value, rtol=0, atol=0)


@pytest.mark.parametrize("entry", [train_entry, embeddings_entry])
def test_entry_without_a_card_raises(mel, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main(["--config", _write_mel_config(str(mel["tmp"] / "card.yaml")), "--data-root", mel["root"]])


def test_unported_options_raise(mel):
    """Nothing of the mel path is refused any more: an augmenting train split
    builds (without a device cache) and the solver takes async mining; an
    unknown mining type still raises."""
    path = _write_mel_config(str(mel["tmp"] / "unported.yaml"), AUDIO__augmentation_factor=3)
    train = MelFeatureDataset("train", load_config(path), data_root=mel["root"], device=CPU)
    train.build_device_cache()
    assert train.augments and train.device_cache is None
    config, _ = _port_solver(mel, _write_mel_config(str(mel["tmp"] / "async.yaml")))
    assert MelSolver(AudioMelFeatureExtractor(), config.override(solver__async_mining=True), None, None).async_mining
    with pytest.raises(ValueError, match="mining_type"):
        triplet.TripletMiner(np.arange(8) % 2, lambda idx: None).mine(2, "closest")


def test_async_mining_matches_jax_async_epoch(mel):
    """solver.async_mining: three steps of the port's worker-thread epoch
    against ``mer_tpu``'s ``_train_epoch_async`` from the same weights,
    caches and sampler seed: the same mined indices (batch k + 1 mined with
    the weights from before step k's update), losses within 1e-4 (the sync
    test's limit: the frontends' caches are shared, the ResNets' f32 sums
    part by rounding)."""
    path = _write_mel_config(str(mel["tmp"] / "async_steps.yaml"), solver__async_mining=True)
    jcfg = jax_load_config(path)
    jsolver = JaxMelSolver(JaxExtractor(), jcfg, mel["jtrain"], mel["jval"], seed=0)
    jstate = jsolver.init_state()
    mined = {"jax": [], "port": []}

    def recording(miner, key):
        mine = miner.mine

        def wrapped(*args, **kwargs):
            out = mine(*args, **kwargs)
            mined[key].append(np.concatenate([np.asarray(x) for x in out]))
            return out

        miner.mine = wrapped
        return miner

    recording(jsolver._miner(mel["jtrain"], jstate.params), "jax")
    jlosses = []
    step = jsolver._train_step
    jsolver._train_step = lambda st, spec: (lambda out: (jlosses.append(float(out[1])), out)[1])(step(st, spec))
    jsolver._train_epoch_async(jstate, 0, jax.random.PRNGKey(1), 3)

    _, solver = _port_solver(mel, path)
    for port_ds, jax_ds in ((solver.data_train, mel["jtrain"]), (solver.data_val, mel["jval"])):
        port_ds.device_cache = torch.from_numpy(np.array(jax_ds._device_cache))
    state = solver.init_state()
    recording(solver._miner(solver.data_train), "port")
    before = {k: v.clone() for k, v in solver.model.state_dict().items()}
    losses = [loss.item() for loss in solver._train_steps_async(state, 3)]
    assert len(mined["port"]) == len(mined["jax"]) == 3
    for got, want in zip(mined["port"], mined["jax"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert state.step == 3 and solver._mining_model is None
    assert any(not torch.equal(before[k], v) for k, v in solver.model.state_dict().items())


def test_async_mining_equals_sync_with_stale_weights(mel):
    """The port's async epoch equals a synchronous loop that mines batch k
    with the weights from before step k - 1's update (batch 0 and 1 with
    the starting weights): the same indices, losses to the bit."""
    path = _write_mel_config(str(mel["tmp"] / "async_sync.yaml"), solver__async_mining=True)
    results = []
    torch.set_num_threads(1)  # the bit-for-bit comparison: no product's sums split between threads
    for asynchronous in (True, False):
        _, solver = _port_solver(mel, path)
        for port_ds, jax_ds in ((solver.data_train, mel["jtrain"]), (solver.data_val, mel["jval"])):
            port_ds.device_cache = torch.from_numpy(np.array(jax_ds._device_cache))
        state = solver.init_state()
        if asynchronous:
            losses = [loss.item() for loss in solver._train_steps_async(state, 3)]
        else:
            stale = __import__("copy").deepcopy(solver.model)
            solver._mining_model, losses = stale, []
            for step in range(3):
                a, p, n = solver._miner(solver.data_train).mine(BATCH, "hard")
                batch = solver.data_train.spectrogram_batch(np.concatenate([a, p, n]))
                stale.load_state_dict(solver.model.state_dict())  # the weights before this step's update
                losses.append(solver.train_step(state, batch).item())
        results.append((losses, {k: v.clone() for k, v in solver.model.state_dict().items()}))
    assert results[0][0] == results[1][0]
    for name, value in results[1][1].items():
        torch.testing.assert_close(results[0][1][name], value, rtol=0, atol=0)


def test_augmented_batches_keep_clean_rows_and_match_jax_where_clean(mel):
    """AUDIO.augmentation_factor 2 on the train split: no device cache; the
    native batch decode equals ``mer_tpu``'s (bit for bit); a batch asked
    for with a generator keeps its variant-0 rows exactly as the clean batch
    (itself within one quantisation step of ``mer_tpu``'s), changes the
    others, and repeats under the same seed; augmented lengths stay in the
    buffer and within the stretch range."""
    path = _write_mel_config(str(mel["tmp"] / "augment.yaml"), AUDIO__augmentation_factor=2)
    config = load_config(path)
    port = MelFeatureDataset("train", config, data_root=mel["root"], device=CPU)
    jport = JaxMelFeatureDataset("train", jax_load_config(path), data_root=mel["root"])
    idx = np.arange(len(port))
    waves, lengths = port.waveform_batch(idx)
    jwaves, jlengths = jport.waveform_batch(idx)
    np.testing.assert_array_equal(waves, jwaves)
    np.testing.assert_array_equal(lengths, jlengths)
    clean = port.spectrogram_batch(idx)
    np.testing.assert_allclose(clean.numpy(), np.asarray(jport._spectrogram_from_waveforms(idx)).transpose(0, 3, 1, 2),
                               rtol=0, atol=STEP)
    got = port.spectrogram_batch(idx, generator=torch.Generator().manual_seed(5))
    again = port.spectrogram_batch(idx, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, again, rtol=0, atol=0)
    audio = torch.from_numpy(np.clip(waves * 32768.0, -32768, 32767).astype(np.int16)).float()
    _, new_lengths, variant = port.augment(audio, torch.from_numpy(lengths), torch.Generator().manual_seed(5))
    clean_rows, aug_rows = (variant == 0).nonzero()[:, 0], (variant > 0).nonzero()[:, 0]
    assert len(clean_rows) and len(aug_rows)
    torch.testing.assert_close(got[clean_rows], clean[clean_rows], rtol=0, atol=0)
    assert all(not torch.equal(got[r], clean[r]) for r in aug_rows)
    new = new_lengths.numpy()
    assert (new <= port.mel_cfg.max_samples).all() and (new[clean_rows.numpy()] == lengths[clean_rows.numpy()]).all()
    assert (new >= np.floor(lengths / 1.25) - 1).all()
    assert (new <= np.minimum(lengths / 0.8, port.mel_cfg.max_samples)).all()
