"""The port's text feature-extractor pipeline (stage 1a: data, export and
evaluation) against the JAX package's, on the CPU.

On a synthetic MELD root with long utterances (``write_synthetic_meld(...,
words=(2, 100))``: context windows in the 64, 128 and 256 token buckets), with
the hash tokenizer (one process, so both packages hash alike) and a narrow
model in both packages (hidden 32, 2 layers, 2 heads, vocabulary 100) holding
the same numpy-perturbed weights:

- the context strings, the tokenizer's output and the batches (``idx``,
  ``text``, ``attention_mask``, ``emotion``, the bucket widths, the last batch
  filled with its last row under ``emotion`` -1; with shuffling, the same order
  from one seed) equal ``mer_tpu``'s exactly;
- the exported tables of the three splits are within 1e-4 of ``mer_tpu``'s
  per-batch export;
- ``FESolver.test`` gives ``mer_tpu``'s loss within 1e-4 and its metrics;
- the ``test`` and ``embeddings`` entry points run with ``--device cpu`` from a
  checkpoint (``test`` from ``test.model_path``), the export also from a
  ``--pretrained`` backbone file; without the tokenizer's files, without
  weights and without a card they raise.
"""

import collections
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mer_tpu.core import get_text as jax_get_text
from mer_tpu.core import get_utterance_with_context as jax_context
from mer_tpu.core import load_config as jax_load_config
from mer_tpu.core.artifacts import load_embeddings as jax_load_embeddings
from mer_tpu.data import TextBatcher as JaxBatcher
from mer_tpu.data import TextFeatureDataset as JaxDataset
from mer_tpu.data import text_fe as jax_text_fe
from mer_tpu.models import roberta as jax_roberta
from mer_tpu.train import FESolver as JaxFESolver
from mer_tpu_torch.core import get_text, get_utterance_with_context, load_config
from mer_tpu_torch.data import write_synthetic_meld
from mer_tpu_torch.data.text_fe import (
    TOKEN_BUCKETS,
    TextBatcher,
    TextFeatureDataset,
    ToyWhitespaceTokenizer,
    load_roberta_tokenizer,
    pad_tokens_to,
    text_batch_to_inputs,
)
from mer_tpu_torch.feature_extractors import fe_common
from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH
from mer_tpu_torch.feature_extractors.text import embeddings as embeddings_entry
from mer_tpu_torch.feature_extractors.text import test as test_entry
from mer_tpu_torch.models import text_state_dict_from_jax
from mer_tpu_torch.models.roberta import RobertaConfig, TextERC
from mer_tpu_torch.train.fe_solver import FESolver

NARROW = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=520)
CFG = RobertaConfig(**NARROW)
JAX_CFG = jax_roberta.RobertaConfig(**NARROW)
MODES = ("train", "val", "test")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fe(tmp_path_factory):
    """The root with long utterances, mer_tpu's narrow TextERC with perturbed
    params, the port's model holding them, and a config whose checkpoints lie
    in a temp dir."""
    tmp = tmp_path_factory.mktemp("torch_text_fe")
    root = str(tmp / "meld")
    counts = write_synthetic_meld(root, 12, words=(2, 100))
    sizes = dict(zip(MODES, counts.values()))
    jax_model = jax_roberta.TextERC(JAX_CFG)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    port = TextERC(CFG)
    port.load_state_dict(text_state_dict_from_jax(params), strict=True)
    with open(TEXT_CONFIG_PATH) as f:
        raw = yaml.safe_load(f)
    raw["checkpoint"]["save_path"] = str(tmp / "ckpt" / "checkpoint.ckpt")
    raw["test"]["model_path"] = str(tmp / "ckpt" / "tuned.ckpt")
    raw["test"]["data_loader"]["batch_size"] = 6
    config_path = str(tmp / "text.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(raw, f)
    return {"root": root, "sizes": sizes, "tmp": tmp, "jax_model": jax_model, "params": params, "port": port.eval(),
            "config": config_path, "tokenizer": ToyWhitespaceTokenizer(vocab_size=CFG.vocab_size),
            "jax_tokenizer": jax_text_fe.ToyWhitespaceTokenizer(vocab_size=CFG.vocab_size)}


@pytest.fixture
def narrow_base(monkeypatch):
    """The entry points build ``RobertaConfig.base()``; here that is the narrow config."""
    monkeypatch.setattr(fe_common.RobertaConfig, "base", classmethod(lambda cls: CFG))


def _save(fe, key):
    path = load_config(fe["config"]).get_path(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 3, "model_state_dict": fe["port"].state_dict()}, path)
    return path


# -- data --------------------------------------------------------------------------


def test_context_strings_equal_jax(fe, meld_like_root):
    for root in (fe["root"], meld_like_root[0]):  # long utterances; cp1252 fixes and one-utterance dialogues
        for mode in MODES:
            df, jax_df = get_text(mode, root), jax_get_text(mode, root)
            got = [get_utterance_with_context(df, i, "</s>") for i in range(len(df))]
            assert got == [jax_context(jax_df, i, "</s>") for i in range(len(jax_df))]
            assert all(t.count("</s>") == 2 for t in got)
    df = get_text("val", fe["root"])
    first = get_utterance_with_context(df, 0, "<sep>")
    assert first.startswith("<sep> ") and (df["Dialogue_ID"] == df["Dialogue_ID"][0]).sum() > 1
    last = get_utterance_with_context(df, len(df) - 1, "<sep>")
    assert last.endswith(" <sep>")


def test_tokenizer_and_padding_equal_jax(fe):
    ds = TextFeatureDataset("val", fe["tokenizer"], data_root=fe["root"])
    jax_ds = JaxDataset("val", fe["jax_tokenizer"], data_root=fe["root"])
    assert ds.texts == jax_ds.texts and len(ds) == fe["sizes"]["val"]
    np.testing.assert_array_equal(ds.get_labels(), jax_ds.get_labels())
    for pad_to in (None, 64, 16):  # 16 truncates
        for g, w in zip(fe["tokenizer"](ds.texts[:5], pad_to=pad_to), fe["jax_tokenizer"](jax_ds.texts[:5], pad_to=pad_to)):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    ids, mask = fe["tokenizer"](ds.texts[:5])
    for g, w in zip(pad_tokens_to(ids, mask, 256, 1), jax_text_fe.pad_tokens_to(ids, mask, 256, 1)):
        np.testing.assert_array_equal(g, w)
    same = pad_tokens_to(ids, mask, ids.shape[1], 1)
    np.testing.assert_array_equal(same[0], ids)
    with pytest.raises(ValueError, match="only pads"):
        pad_tokens_to(ids, mask, ids.shape[1] - 1, 1)


@pytest.mark.parametrize("batch_size, shuffle", [(6, False), (32, False), (4, True)])
def test_batcher_equals_jax(fe, batch_size, shuffle):
    widths = collections.Counter()
    for mode in MODES:
        ds = TextFeatureDataset(mode, fe["tokenizer"], data_root=fe["root"])
        jax_ds = JaxDataset(mode, fe["jax_tokenizer"], data_root=fe["root"])
        got = list(TextBatcher(ds, batch_size, shuffle=shuffle, seed=3))
        want = list(JaxBatcher(jax_ds, batch_size, shuffle=shuffle, seed=3, process_index=0, process_count=1))
        assert len(got) == len(want) == len(TextBatcher(ds, batch_size)) == -(-len(ds) // batch_size)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"idx", "text", "attention_mask", "emotion"}
            assert g["text"].dtype == g["attention_mask"].dtype == g["emotion"].dtype == np.int32
            assert g["text"].shape == g["attention_mask"].shape and g["text"].shape[1] in TOKEN_BUCKETS
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])
            widths[g["text"].shape[1]] += 1
        if not shuffle:
            pad = batch_size * len(got) - len(ds)
            last, n_real = got[-1], batch_size - pad
            assert (last["emotion"][n_real:] == -1).all() and (last["emotion"][:n_real] != -1).all()
            assert (last["idx"][n_real:] == len(ds) - 1).all()
    assert len(widths) >= 2 and max(widths) >= 128  # the long utterances leave the 64 bucket


def test_long_rows_are_truncated_to_the_largest_bucket(fe):
    ds = TextFeatureDataset("val", fe["tokenizer"], data_root=fe["root"])
    ds.texts = [" ".join(["word"] * 700)] * len(ds.texts)
    batch = next(iter(TextBatcher(ds, 2)))
    assert batch["text"].shape == (2, 512) and batch["attention_mask"].all()
    ids, mask = text_batch_to_inputs(batch)
    assert ids.dtype == torch.int64 and mask.dtype == torch.int32 and ids.shape == (2, 512)


def test_hf_tokenizer_without_files_raises():
    with pytest.raises(RuntimeError, match="--toy-tokenizer"):
        load_roberta_tokenizer(os.path.join(os.path.dirname(__file__), "no-such-tokenizer-dir"))


# -- export and evaluation against mer_tpu ---------------------------------------------


def test_exported_tables_match_jax(fe):
    embed = jax.jit(lambda p, ids, mask: fe["jax_model"].apply({"params": p}, ids, mask,
                                                               method=jax_roberta.TextERC.embed))
    for mode in MODES:
        jax_ds = JaxDataset(mode, fe["jax_tokenizer"], data_root=fe["root"])
        want = np.zeros((len(jax_ds), 32), np.float32)
        for b in JaxBatcher(jax_ds, 6, process_index=0, process_count=1):  # the per-batch export loop
            emb = np.asarray(embed(fe["params"], jnp.asarray(b["text"]), jnp.asarray(b["attention_mask"])))
            valid = b["emotion"] != -1
            want[b["idx"][valid]] = emb[valid]
        got = embeddings_entry.export_split(fe["port"], TextFeatureDataset(mode, fe["tokenizer"], data_root=fe["root"]),
                                            batch_size=6)
        assert got.shape == want.shape == (fe["sizes"][mode], 32) and got.dtype == np.float32
        assert np.abs(got).sum(axis=1).all()  # every row written
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fe_solver_test_matches_jax(fe, capsys):
    jax_ds = JaxDataset("test", fe["jax_tokenizer"], data_root=fe["root"])
    jax_dl = JaxBatcher(jax_ds, 6, process_index=0, process_count=1)
    jax_solver = JaxFESolver(fe["jax_model"], jax_load_config(fe["config"]), backbone_key="roberta",
                             batch_to_inputs=lambda b: (b["text"], b["attention_mask"]))
    jax_solver.init_state(next(iter(jax_dl)), steps_per_epoch=1)
    want = jax_solver.test(jax_dl, fe["params"])

    solver = FESolver(fe["port"], load_config(fe["config"]), batch_to_inputs=text_batch_to_inputs)
    got = solver.test(TextBatcher(TextFeatureDataset("test", fe["tokenizer"], data_root=fe["root"]), 6))
    assert set(got) == set(want) and "Weighted_F1=[" in capsys.readouterr().out
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    for key in ("accuracy", "weighted_f1", "pooled_accuracy", "pooled_weighted_f1"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12)


# -- entry points ----------------------------------------------------------------------


def test_entry_points_on_cpu(fe, narrow_base, tmp_path, capsys):
    """checkpoint.save_path -> embeddings (three tables both packages read);
    test.model_path -> test."""
    ckpt = _save(fe, "checkpoint.save_path")
    argv = ["--config", fe["config"], "--data-root", fe["root"], "--random-init", "--toy-tokenizer", "--f32",
            "--device", "cpu"]
    tables = embeddings_entry.main(argv, save_dir=str(tmp_path / "emb"))
    out = capsys.readouterr().out
    assert f"Loaded fine-tuned checkpoint {ckpt}" in out and "Saved test embeddings" in out
    for mode, table in tables.items():
        assert table.shape == (fe["sizes"][mode], 32) and np.isfinite(table).all()
        np.testing.assert_array_equal(jax_load_embeddings(tmp_path / "emb" / f"{mode}.pkl"), table)
    direct = embeddings_entry.export_split(fe["port"], TextFeatureDataset("test", fe["tokenizer"], data_root=fe["root"]))
    np.testing.assert_allclose(tables["test"], direct, rtol=0, atol=1e-6)

    with pytest.raises(FileNotFoundError, match="tuned.ckpt"):  # test reads test.model_path, not save_path
        test_entry.main(argv)
    tuned = _save(fe, "test.model_path")
    result = test_entry.main(argv)
    out = capsys.readouterr().out
    assert f"Loaded {fe['sizes']['test']} utterances for testing" in out and "Accuracy=[" in out
    want = FESolver(fe["port"], load_config(fe["config"]), batch_to_inputs=text_batch_to_inputs).test(
        TextBatcher(TextFeatureDataset("test", fe["tokenizer"], data_root=fe["root"]), 6))
    assert result == pytest.approx(want, abs=1e-6)

    bf16 = embeddings_entry.main([a for a in argv if a != "--f32"], save_dir=str(tmp_path / "emb16"))  # the config's
    assert bf16["test"].dtype == np.float32
    assert np.abs(bf16["test"] - tables["test"]).max() < 0.1 * np.abs(tables["test"]).max()
    os.remove(ckpt)
    os.remove(tuned)


def test_export_from_a_pretrained_backbone(fe, narrow_base, tmp_path, capsys):
    """No checkpoint at save_path: the export takes ``--pretrained`` (a file,
    or a directory holding ``pytorch_model.bin``) under the seeded head."""
    folder = tmp_path / "roberta-base"
    folder.mkdir()
    torch.save({**fe["port"].roberta.state_dict(), "pooler.dense.bias": torch.zeros(32)}, folder / "pytorch_model.bin")
    argv = ["--config", fe["config"], "--data-root", fe["root"], "--toy-tokenizer", "--f32", "--device", "cpu"]
    direct = embeddings_entry.export_split(fe["port"], TextFeatureDataset("val", fe["tokenizer"], data_root=fe["root"]))
    for pretrained in (folder, folder / "pytorch_model.bin"):
        tables = embeddings_entry.main([*argv, "--pretrained", str(pretrained)], save_dir=str(tmp_path / "emb"))
        assert "exporting with pretrained backbone" in capsys.readouterr().out
        np.testing.assert_allclose(tables["val"], direct, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="Checkpoint not found"):
        embeddings_entry.main([*argv, "--random-init"], save_dir=str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="--pretrained <state_dict file>"):
        embeddings_entry.main(argv, save_dir=str(tmp_path / "none"))
    no_toy = [a for a in argv if a != "--toy-tokenizer"]
    with pytest.raises(RuntimeError, match="tokenizer"):  # the folder holds no vocabulary
        embeddings_entry.main([*no_toy, "--pretrained", str(folder)], save_dir=str(tmp_path / "none"))


def test_variant_resolution(fe):
    parse = lambda *flags: fe_common.parse_args(["--random-init", "--toy-tokenizer", *flags])
    config = load_config(fe["config"])
    with torch.device("meta"):
        model, tokenizer, pretrained = fe_common.load_text_model_and_tokenizer(parse("--f32"), config=config)
        assert pretrained is None and model.cfg == RobertaConfig.base() and model.dtype == torch.float32
        assert tokenizer.vocab_size == 50265 and tokenizer.sep_token == "</s>"
        large = fe_common.load_text_model_and_tokenizer(parse("--variant", "roberta-large"), config=config)[0]
        assert large.cfg == RobertaConfig.large() and large.dtype == torch.bfloat16  # the config's compute dtype
        by_config = fe_common.load_text_model_and_tokenizer(
            parse(), config=config.override(test__pretrained_model="roberta-large"))[0]
        assert by_config.cfg == RobertaConfig.large()
        by_argument = fe_common.load_text_model_and_tokenizer(parse(), variant="roberta-large", config=None)[0]
        assert by_argument.cfg == RobertaConfig.large()


@pytest.mark.parametrize("entry", [embeddings_entry, test_entry])
def test_entry_without_a_card_raises(fe, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main(["--config", fe["config"], "--data-root", fe["root"], "--random-init", "--toy-tokenizer"])
