"""The port's wav2vec2 feature-extractor pipeline (stage 1b, export and
evaluation) against the JAX package's, on the CPU.

On ``conftest.py::meld_like_root_with_wavs`` (0.25-0.75 s clips, so every
batch pads to the 2 s bucket), with a narrow model in both packages (the base
conv schedule at 32 channels, 2 transformer layers of width 64) holding the
same numpy-perturbed weights:

- the batcher yields ``mer_tpu``'s batches exactly: indices, int16 audio,
  lengths, the bucket width, the last batch filled with its last clip under
  ``emotion`` -1; with shuffling, the same length-grouped order from one seed;
- the exported test table is within 1e-4 of ``mer_tpu``'s per-batch export;
- ``FESolver.test`` gives ``mer_tpu``'s loss within 1e-4 and its metrics;
- both entry points run with ``--device cpu`` from a checkpoint, the export
  also from a ``--pretrained`` backbone file; without a card, without weights,
  and with an unported flag they raise.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mer_tpu.core import load_config as jax_load_config
from mer_tpu.core.artifacts import load_embeddings as jax_load_embeddings
from mer_tpu.data import Wav2Vec2Batcher as JaxBatcher
from mer_tpu.data import Wav2Vec2FeatureDataset as JaxDataset
from mer_tpu.data.wav2vec2_fe import w2v_batch_to_inputs as jax_batch_to_inputs
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.train import FESolver as JaxFESolver
from mer_tpu_torch.core import load_config
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
from mer_tpu_torch.feature_extractors import fe_common
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import embeddings as embeddings_entry
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import test as test_entry
from mer_tpu_torch.models import audio_state_dict_from_jax
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config
from mer_tpu_torch.train.fe_solver import FESolver

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(conv_dim=(32,) * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
CFG = Wav2Vec2Config(**NARROW)
JAX_CFG = jax_w2v.Wav2Vec2Config(**NARROW)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_fe_common():
    spec = importlib.util.spec_from_file_location(
        "jax_fe_common", os.path.join(REPO_ROOT, "src", "feature_extractors", "fe_common.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fe(meld_like_root_with_wavs, tmp_path_factory):
    """The root, mer_tpu's narrow AudioERC with its perturbed params, and the
    port's model holding them; a config whose checkpoint lies in a temp dir."""
    root, sizes = meld_like_root_with_wavs
    tmp = tmp_path_factory.mktemp("torch_w2v_fe")
    jax_model = jax_w2v.AudioERC(JAX_CFG)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 800)), jnp.full((1,), 800, jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    port = AudioERC(CFG)
    port.load_state_dict(audio_state_dict_from_jax(params), strict=True)
    with open(W2V_CONFIG_PATH) as f:
        raw = yaml.safe_load(f)
    raw["checkpoint"]["save_path"] = str(tmp / "ckpt" / "checkpoint.ckpt")
    raw["test"]["data_loader"]["batch_size"] = 6  # a padded last batch on the 20-row test split
    config_path = str(tmp / "w2v.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(raw, f)
    return {"root": root, "sizes": sizes, "tmp": tmp, "jax_model": jax_model, "params": params, "port": port.eval(),
            "config": config_path}


@pytest.fixture
def narrow_base(monkeypatch):
    """The entry points build ``Wav2Vec2Config.base()``; here that is the narrow config."""
    monkeypatch.setattr(fe_common.Wav2Vec2Config, "base", classmethod(lambda cls: CFG))


def _save_checkpoint(fe):
    path = load_config(fe["config"]).checkpoint.save_path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 3, "model_state_dict": fe["port"].state_dict()}, path)
    return path


# -- data --------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size, shuffle", [(6, False), (32, False), (4, True)])
def test_batcher_equals_jax(fe, batch_size, shuffle):
    for mode in ("train", "test"):
        port_ds = Wav2Vec2FeatureDataset(mode, data_root=fe["root"])
        jax_ds = JaxDataset(mode, data_root=fe["root"])
        assert len(port_ds) == len(jax_ds) == fe["sizes"][mode]
        np.testing.assert_array_equal(port_ds.waveform_lengths(), jax_ds.waveform_lengths())
        got = list(Wav2Vec2Batcher(port_ds, batch_size, shuffle=shuffle, seed=3))
        want = list(JaxBatcher(jax_ds, batch_size, shuffle=shuffle, seed=3, process_index=0, process_count=1))
        assert len(got) == len(want) == len(Wav2Vec2Batcher(port_ds, batch_size)) == -(-len(port_ds) // batch_size)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"idx", "audio", "lengths", "emotion"}
            assert g["audio"].dtype == np.int16 and g["audio"].shape == (batch_size, 32000)
            assert g["lengths"].dtype == g["emotion"].dtype == np.int32
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])
        if not shuffle:
            pad = batch_size * len(got) - len(port_ds)
            assert pad > 0 or batch_size != 32
            last, n_real = got[-1], batch_size - pad
            assert (last["emotion"][n_real:] == -1).all() and (last["emotion"][:n_real] != -1).all()
            assert (last["idx"][n_real:] == len(port_ds) - 1).all()
            np.testing.assert_array_equal(np.concatenate([b["idx"] for b in got])[: len(port_ds)],
                                          np.arange(len(port_ds)))


def test_buckets_and_inputs(fe):
    ds = Wav2Vec2FeatureDataset("val", data_root=fe["root"])
    batcher = Wav2Vec2Batcher(ds, 4)
    assert batcher.buckets == (32000, 64000, 96000, 128000, 160000)
    assert [batcher._bucket(n) for n in (1, 32000, 32001, 159999, 10 ** 6)] == [32000, 32000, 64000, 160000, 160000]
    i16 = next(iter(batcher))
    audio, lengths = w2v_batch_to_inputs(i16)
    want_audio, want_lengths = jax_batch_to_inputs(i16)
    assert audio.dtype == torch.float32 and lengths.dtype == torch.int32
    np.testing.assert_array_equal(audio.numpy(), want_audio)
    np.testing.assert_array_equal(lengths.numpy(), want_lengths)
    for i, n in enumerate(i16["lengths"]):  # the wire keeps PCM16's values: what the wav held, zeros after
        np.testing.assert_allclose(audio[i, :n].numpy(), ds.waveform(i16["idx"][i]), rtol=0, atol=1 / 32768)
        assert not audio[i, n:].any()


# -- export and evaluation against mer_tpu ---------------------------------------------


def test_exported_table_matches_jax(fe):
    jax_ds = JaxDataset("test", data_root=fe["root"])
    embed = jax.jit(lambda p, audio, lengths: fe["jax_model"].apply(
        {"params": p}, audio.astype("float32") / 32768.0, lengths, method=jax_w2v.AudioERC.embed))
    batches = []
    for b in JaxBatcher(jax_ds, 6, process_index=0, process_count=1):
        emb = embed(fe["params"], jnp.asarray(b["audio"]), jnp.asarray(b["lengths"]))
        valid = b["emotion"] != -1
        batches.append((b["idx"][valid], np.asarray(emb)[valid]))
    want = _jax_fe_common().export_embedding_table(batches, len(jax_ds), JAX_CFG.hidden_size)
    got = embeddings_entry.export_split(fe["port"], Wav2Vec2FeatureDataset("test", data_root=fe["root"]), batch_size=6)
    assert got.shape == want.shape == (fe["sizes"]["test"], 64) and got.dtype == np.float32
    assert len(jax_ds) % 6 and np.abs(got).sum(axis=1).all()  # a padded last batch; every row written
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(fe_common.export_embedding_table(batches, len(jax_ds), 64), want)


def test_fe_solver_test_matches_jax(fe, capsys):
    jax_config = jax_load_config(fe["config"])
    jax_ds = JaxDataset("test", data_root=fe["root"])
    jax_dl = JaxBatcher(jax_ds, 6, process_index=0, process_count=1)
    jax_solver = JaxFESolver(fe["jax_model"], jax_config, backbone_key="wav2vec2", batch_to_inputs=jax_batch_to_inputs)
    jax_solver.init_state(next(iter(jax_dl)), steps_per_epoch=1)
    want = jax_solver.test(jax_dl, fe["params"])

    solver = FESolver(fe["port"], load_config(fe["config"]), batch_to_inputs=w2v_batch_to_inputs)
    got = solver.test(Wav2Vec2Batcher(Wav2Vec2FeatureDataset("test", data_root=fe["root"]), 6))
    assert set(got) == set(want) and "Weighted_F1=[" in capsys.readouterr().out
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    for key in ("accuracy", "weighted_f1", "pooled_accuracy", "pooled_weighted_f1"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12)
    loss, metrics = solver.evaluate([])
    assert loss == 0.0 and metrics.batch_averaged_accuracy == 0.0


# -- entry points ----------------------------------------------------------------------


def test_entry_points_on_cpu(fe, narrow_base, tmp_path, capsys):
    """checkpoint -> embeddings (three tables both packages read) and -> test."""
    ckpt = _save_checkpoint(fe)
    argv = ["--config", fe["config"], "--data-root", fe["root"], "--random-init", "--f32", "--device", "cpu"]
    tables = embeddings_entry.main(argv, save_dir=str(tmp_path / "emb"))
    out = capsys.readouterr().out
    assert f"Loaded fine-tuned checkpoint {ckpt}" in out and "Saved test embeddings" in out
    for mode, table in tables.items():
        assert table.shape == (fe["sizes"][mode], 64) and np.isfinite(table).all()
        np.testing.assert_array_equal(jax_load_embeddings(tmp_path / "emb" / f"{mode}.pkl"), table)
    direct = embeddings_entry.export_split(fe["port"], Wav2Vec2FeatureDataset("test", data_root=fe["root"]))
    np.testing.assert_allclose(tables["test"], direct, rtol=0, atol=1e-6)

    result = test_entry.main(argv)
    out = capsys.readouterr().out
    assert f"Loaded {fe['sizes']['test']} utterances for testing" in out and "Accuracy=[" in out
    want = FESolver(fe["port"], load_config(fe["config"]), batch_to_inputs=w2v_batch_to_inputs).test(
        Wav2Vec2Batcher(Wav2Vec2FeatureDataset("test", data_root=fe["root"]), 6))
    assert result == pytest.approx(want, abs=1e-6)

    bf16 = embeddings_entry.main([*argv[:-3], "--device", "cpu"], save_dir=str(tmp_path / "emb16"))  # the config's bf16
    assert bf16["test"].dtype == np.float32
    assert np.abs(bf16["test"] - tables["test"]).max() < 0.1 * np.abs(tables["test"]).max()
    os.remove(ckpt)


def test_export_from_a_pretrained_backbone_file(fe, narrow_base, tmp_path, capsys):
    """No checkpoint at save_path: the export takes ``--pretrained FILE`` under
    the seeded head; the evaluation insists on the checkpoint."""
    backbone = tmp_path / "wav2vec2-base.pt"
    torch.save({**fe["port"].wav2vec2.state_dict(), "masked_spec_embed": torch.zeros(64)}, backbone)
    argv = ["--config", fe["config"], "--data-root", fe["root"], "--f32", "--device", "cpu"]
    tables = embeddings_entry.main([*argv, "--pretrained", str(backbone)], save_dir=str(tmp_path / "emb"))
    assert "exporting with pretrained backbone" in capsys.readouterr().out
    direct = embeddings_entry.export_split(fe["port"], Wav2Vec2FeatureDataset("val", data_root=fe["root"]))
    np.testing.assert_allclose(tables["val"], direct, rtol=0, atol=1e-6)
    with pytest.raises(FileNotFoundError, match="Checkpoint not found"):
        test_entry.main([*argv, "--random-init"])
    with pytest.raises(ValueError, match="Checkpoint not found"):
        embeddings_entry.main([*argv, "--random-init"], save_dir=str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="--pretrained <state_dict file>"):
        embeddings_entry.main(argv, save_dir=str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="unavailable"):
        test_entry.main([*argv, "--pretrained", str(tmp_path / "missing.pt")])


@pytest.mark.parametrize("entry", [embeddings_entry, test_entry])
def test_entry_without_a_card_raises(fe, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main(["--config", fe["config"], "--data-root", fe["root"], "--random-init"])


@pytest.mark.parametrize("flag", [["--int8"], ["--pp", "2"], ["--remat"], ["--zero1"]])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        fe_common.parse_args(["--random-init", *flag])


def test_resolve_compute_dtype(fe):
    config = load_config(fe["config"])
    parse = lambda *flags: fe_common.parse_args(list(flags))
    assert fe_common.resolve_compute_dtype(parse(), config) == torch.bfloat16  # the shipped config's choice
    assert fe_common.resolve_compute_dtype(parse("--f32"), config) == torch.float32
    assert fe_common.resolve_compute_dtype(parse("--bf16"), config.override(tpu__compute_dtype="float32")) \
        == torch.bfloat16
    assert fe_common.resolve_compute_dtype(parse(), config.override(tpu__compute_dtype="float32")) == torch.float32
    assert fe_common.resolve_compute_dtype(parse(), None) == torch.float32
    with pytest.raises(SystemExit):
        parse("--bf16", "--f32")
    model, pretrained = fe_common.load_wav2vec2_model(parse("--random-init", "--f32"), config=config)
    assert pretrained is None and model.cfg == Wav2Vec2Config.base() and model.dtype == torch.float32
    assert sum(p.numel() for p in model.parameters()) == 94_966_791  # wav2vec2-base + the head
