"""The port's freeze / fine-tune solver against the JAX package's, on the CPU.

``FESolver.fit`` of both packages from the same numpy-perturbed weights, over
the same batches (one shuffle seed) and the same config (dropout rates 0, f32,
2 frozen + 2 fine-tune epochs, warmup 1 epoch; ``mer_tpu`` with
``tpu.train_scan_chunk: 0``, its arrival-order loop), for the text extractor
(text schema; also with ``grad_accum_steps: 2`` over an odd number of steps an
epoch and 1 frozen + 3 fine-tune epochs, so accumulation windows stay open
across epochs and across the unfreeze) and the wav2vec2 extractor (its
per-phase schema), at narrow sizes:

- per-epoch train and validation losses within 1e-4 relative, final
  parameters within 1e-4 of each tensor's largest entry (the attention's key
  biases, whose true gradient is zero, within the learning rate per update);
- the frozen phase leaves the backbone bit for bit and moves the head; the
  first fine-tune update (lr 0) leaves every parameter unchanged, the second
  moves them all; AdamW's state is f32 under bf16 compute;
- checkpoints hold ``{"epoch", "model_state_dict"}`` only; early stopping
  restores the best weights, promotes them to ``save_path`` and removes
  ``best_weights.ckpt``;
- the entry points run train -> test -> embeddings with ``--device cpu``.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mer_tpu.core import load_config as jax_load_config
from mer_tpu.data import TextBatcher as JaxTextBatcher
from mer_tpu.data import TextFeatureDataset as JaxTextDataset
from mer_tpu.data import Wav2Vec2Batcher as JaxW2VBatcher
from mer_tpu.data import Wav2Vec2FeatureDataset as JaxW2VDataset
from mer_tpu.data import text_fe as jax_text_fe
from mer_tpu.data.wav2vec2_fe import w2v_batch_to_inputs as jax_w2v_inputs
from mer_tpu.models import roberta as jax_roberta
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.train import FESolver as JaxFESolver
from mer_tpu_torch.core import load_config
from mer_tpu_torch.data.text_fe import TextBatcher, TextFeatureDataset, ToyWhitespaceTokenizer, text_batch_to_inputs
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
from mer_tpu_torch.feature_extractors import fe_common
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import embeddings as w2v_embeddings_entry
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import test as w2v_test_entry
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import train as w2v_train_entry
from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH
from mer_tpu_torch.feature_extractors.text import embeddings as text_embeddings_entry
from mer_tpu_torch.feature_extractors.text import test as text_test_entry
from mer_tpu_torch.feature_extractors.text import train as text_train_entry
from mer_tpu_torch.models import audio_state_dict_from_jax, text_state_dict_from_jax
from mer_tpu_torch.models.roberta import RobertaConfig, TextERC
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config
from mer_tpu_torch.train.checkpoint import load_checkpoint
from mer_tpu_torch.train.fe_solver import FESolver
from mer_tpu_torch.train.solver import adamw, constant_with_warmup

NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
TEXT_NARROW = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=520)
W2V_NARROW = dict(conv_dim=(32,) * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
EPOCHS, FROZEN = 4, 2


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_config(path, kind: str, ckpt_dir, accum: int = 1, frozen: int = FROZEN, **solver) -> str:
    """A training config in the text or the wav2vec2 schema, dropout-free runs' settings."""
    phases = ({"frozen_lr": 1e-3, "finetuning_lr": 2e-4, "weight_decay": 0.01, "warmup_epochs": 1} if kind == "text"
              else {"frozen": {"lr": 1e-3, "weight_decay": 0.01},
                    "finetuning": {"lr": 2e-4, "weight_decay": 5e-3, "warmup_epochs": 1}})
    raw = {
        "checkpoint": {"save_path": str(ckpt_dir / "checkpoint.ckpt"), "save_checkpoint": True},
        "solver": {"loss_fn": "CE", "balance_classes": False, "num_frozen_epochs": frozen, "epochs": EPOCHS,
                   "grad_accum_steps": accum,
                   "early_stopping": {"enabled": True, "patience": 50, "restore_best_weights": True}, **phases, **solver},
        "wandb": {"enabled": False},
        "tpu": {"compute_dtype": "float32", "seed": 0, "train_scan_chunk": 0},
    }
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _text_setup(root, batch_size):
    """(jax model, params, jax batchers, port model, port batchers, converter, inputs)."""
    cfg, jax_cfg = RobertaConfig(**TEXT_NARROW, **NO_DROPOUT), jax_roberta.RobertaConfig(**TEXT_NARROW, **NO_DROPOUT)
    jax_model = jax_roberta.TextERC(jax_cfg)
    params = _perturbed(jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                       jnp.ones((1, 8), jnp.int32))["params"])
    tok, jax_tok = ToyWhitespaceTokenizer(100), jax_text_fe.ToyWhitespaceTokenizer(100)
    jax_dl = lambda mode, shuffle: JaxTextBatcher(JaxTextDataset(mode, jax_tok, data_root=root), batch_size,
                                                  shuffle=shuffle, seed=0, process_index=0, process_count=1)
    dl = lambda mode, shuffle: TextBatcher(TextFeatureDataset(mode, tok, data_root=root), batch_size, shuffle=shuffle,
                                           seed=0)
    port = TextERC(cfg)
    port.load_state_dict(text_state_dict_from_jax(params), strict=True)
    return dict(jax_model=jax_model, params=params, jax_dl=jax_dl, dl=dl, port=port, convert=text_state_dict_from_jax,
                backbone="roberta", jax_inputs=lambda b: (b["text"], b["attention_mask"]), inputs=text_batch_to_inputs)


def _w2v_setup(root, batch_size):
    cfg, jax_cfg = Wav2Vec2Config(**W2V_NARROW, **NO_DROPOUT), jax_w2v.Wav2Vec2Config(**W2V_NARROW, **NO_DROPOUT)
    jax_model = jax_w2v.AudioERC(jax_cfg)
    params = _perturbed(jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 800)),
                                       jnp.full((1,), 800, jnp.int32))["params"])
    jax_dl = lambda mode, shuffle: JaxW2VBatcher(JaxW2VDataset(mode, data_root=root), batch_size, shuffle=shuffle,
                                                 seed=0, process_index=0, process_count=1)
    dl = lambda mode, shuffle: Wav2Vec2Batcher(Wav2Vec2FeatureDataset(mode, data_root=root), batch_size,
                                               shuffle=shuffle, seed=0)
    port = AudioERC(cfg)
    port.load_state_dict(audio_state_dict_from_jax(params), strict=True)
    return dict(jax_model=jax_model, params=params, jax_dl=jax_dl, dl=dl, port=port,
                convert=audio_state_dict_from_jax, backbone="wav2vec2", jax_inputs=jax_w2v_inputs,
                inputs=w2v_batch_to_inputs)


@pytest.fixture(scope="module", params=["text", "text-accum2", "wav2vec2"])
def fitted(request, meld_like_root_with_wavs, tmp_path_factory):
    """One ``fit`` of each package per case, from the same weights and batches."""
    root, sizes = meld_like_root_with_wavs
    kind, accum = request.param.split("-")[0], 2 if request.param.endswith("accum2") else 1
    tmp = tmp_path_factory.mktemp(f"torch_fe_training_{kind}{accum}")
    # with accumulation: an odd number of steps an epoch and one frozen epoch, so a window stays open across the
    # fine-tune epochs and the frozen phase's open window is dropped at the unfreeze
    frozen = 1 if accum == 2 else FROZEN
    batch_size = 4 if kind == "wav2vec2" else next(b for b in (6, 5, 7, 8) if accum == 1 or -(-sizes["train"] // b) % 2)
    s = (_text_setup if kind == "text" else _w2v_setup)(root, batch_size)
    (tmp / "jax").mkdir()
    (tmp / "port").mkdir()
    jax_config = jax_load_config(_write_config(tmp / "jax.yaml", kind, tmp / "jax", accum, frozen))
    config = load_config(_write_config(tmp / "port.yaml", kind, tmp / "port", accum, frozen))

    jax_solver = JaxFESolver(s["jax_model"], jax_config, backbone_key=s["backbone"], batch_to_inputs=s["jax_inputs"])
    jax_train, jax_val = s["jax_dl"]("train", True), s["jax_dl"]("val", False)
    state = jax_solver.init_state(next(iter(s["jax_dl"]("train", False))), steps_per_epoch=len(jax_train))
    state["params"] = jax.tree.map(jnp.asarray, s["params"])
    state, jax_history = jax_solver.fit(jax_train, jax_val, state=state)

    before = {k: v.clone() for k, v in s["port"].state_dict().items()}
    solver = FESolver(s["port"], config, backbone_key=s["backbone"], batch_to_inputs=s["inputs"])
    train, val = s["dl"]("train", True), s["dl"]("val", False)
    port_state, history = solver.fit(train, val)
    return dict(kind=kind, accum=accum, frozen=frozen, steps_per_epoch=len(train), jax_history=jax_history, history=history,
                jax_final=s["convert"](jax.tree.map(np.asarray, state["params"])), port=s["port"], before=before,
                port_state=port_state, config=config, solver=solver, setup=s, tmp=tmp)


def test_fit_losses_match_jax(fitted):
    for key in ("loss_values", "val_loss_values"):
        got, want = fitted["history"][key], fitted["jax_history"][key]
        assert len(got) == len(want) == EPOCHS
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=key)
    assert fitted["history"]["loss_values"][-1] < fitted["history"]["loss_values"][0]


def test_fit_final_parameters_match_jax(fitted):
    got = fitted["port"].state_dict()
    assert set(got) == set(fitted["jax_final"])
    moved = 0
    updates = (EPOCHS - fitted["frozen"]) * fitted["steps_per_epoch"] // fitted["accum"]
    for name, want in fitted["jax_final"].items():
        atol = 1e-4 * want.abs().max().item()
        if name.endswith(("key.bias", "k_proj.bias")):
            # softmax ignores a key bias (it shifts a query's scores alike), so its gradient is rounding noise,
            # which AdamW normalises to a step of up to the learning rate per update, in either direction
            atol = 2e-4 * updates
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0, atol=atol, err_msg=name)
        moved += not torch.equal(got[name], fitted["before"][name])
    assert moved == len(got)  # weight decay alone moves every tensor in the fine-tune phase


def test_fit_counts_steps_and_keeps_f32_state(fitted):
    state, steps, frozen = fitted["port_state"], fitted["steps_per_epoch"], fitted["frozen"]
    assert state.micro_step == EPOCHS * steps
    assert state.frozen.step == frozen * steps and state.finetune.step == (EPOCHS - frozen) * steps
    if fitted["accum"] == 2:
        assert steps % 2 == 1 and frozen == 1
    n_head = sum(1 for n, _ in fitted["port"].named_parameters() if not n.startswith(fitted["setup"]["backbone"]))
    assert len(state.frozen.optimizer.param_groups[0]["params"]) == n_head
    moments = [v for s in state.finetune.optimizer.state.values() for k, v in s.items() if k != "step"]
    assert moments and all(m.dtype == torch.float32 for m in moments)
    updates = {int(s["step"].item()) for s in state.finetune.optimizer.state.values()}
    assert updates == {(EPOCHS - frozen) * steps // fitted["accum"]}


def test_checkpoint_holds_parameters_only(fitted):
    ckpt = load_checkpoint(fitted["config"].checkpoint.save_path)
    assert set(ckpt) == {"epoch", "model_state_dict"} and ckpt["epoch"] == EPOCHS - 1
    for name, value in fitted["port"].state_dict().items():
        assert torch.equal(ckpt["model_state_dict"][name], value)
    assert not os.path.exists(os.path.join(os.path.dirname(fitted["config"].checkpoint.save_path), "best_weights.ckpt")) \
        or fitted["history"]["val_loss_values"]  # the best-weights shadow is only removed on an early stop


# -- phases, port only --------------------------------------------------------------------


def _fresh_text_solver(tmp_path, meld_like_root, dtype=torch.float32, **solver):
    root, _ = meld_like_root
    s = _text_setup(root, 6)
    config = load_config(_write_config(tmp_path / "c.yaml", "text", tmp_path, **solver))
    port = s["port"].set_compute_dtype(dtype)
    return FESolver(port, config, backbone_key="roberta", batch_to_inputs=text_batch_to_inputs), s


def test_frozen_phase_keeps_the_backbone_and_lr_zero_keeps_everything(tmp_path, meld_like_root):
    solver, s = _fresh_text_solver(tmp_path, meld_like_root)
    model = solver.model
    batches = list(s["dl"]("train", False))
    state = solver.init_state(len(batches))
    snapshot = lambda: {k: v.clone() for k, v in model.state_dict().items()}
    start = snapshot()
    solver.train_epoch(state, batches, epoch=0)
    frozen = snapshot()
    assert model.training and all(p.requires_grad for p in model.parameters())
    for name in start:
        same = torch.equal(start[name], frozen[name])
        assert same == name.startswith("roberta."), name  # the backbone bit for bit, the head moved
    solver.train_epoch(state, batches[:1], epoch=FROZEN)  # the first fine-tune update runs at lr 0
    assert all(torch.equal(frozen[n], v) for n, v in model.state_dict().items())
    assert state.finetune.optimizer.param_groups[0]["lr"] == 0.0
    solver.train_epoch(state, batches[1:2], epoch=FROZEN)  # the second moves every parameter
    assert not any(torch.equal(frozen[n], v) for n, v in model.state_dict().items())
    assert state.finetune.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4 / len(batches))


def test_schedule_and_optimizer_follow_mer_tpu():
    from mer_tpu.train.solver import constant_with_warmup as jax_schedule

    for warmup in (0, 1, 7):
        got, want = constant_with_warmup(3e-4, warmup), jax_schedule(3e-4, warmup)
        np.testing.assert_allclose([got(n) for n in range(12)], [float(want(n)) for n in range(12)], rtol=1e-6)
    assert constant_with_warmup(1.0, 4)(0) == 0.0 and constant_with_warmup(1.0, 4)(9) == 1.0
    opt = adamw([torch.nn.Parameter(torch.ones(2))], 1e-3, 0.05)
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW) and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.05


def test_bf16_compute_trains_f32_parameters(tmp_path, meld_like_root):
    solver, s = _fresh_text_solver(tmp_path, meld_like_root, dtype=torch.bfloat16)
    batches = list(s["dl"]("train", False))[:3]
    state = solver.init_state(len(batches))
    _, loss = solver.train_epoch(state, batches, epoch=FROZEN)
    assert np.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in solver.model.parameters())
    assert all(v.dtype == torch.float32 for st in state.finetune.optimizer.state.values() for v in st.values())


def test_early_stopping_restores_promotes_and_removes_the_best_weights(tmp_path, meld_like_root, monkeypatch, capsys):
    solver, s = _fresh_text_solver(tmp_path, meld_like_root, epochs=6,
                                   early_stopping={"enabled": True, "patience": 2, "restore_best_weights": True})
    val_losses, seen = iter([1.0, 0.5, 0.7, 0.9, 0.1, 0.1]), []
    evaluate = solver.evaluate

    def scripted(batcher):
        seen.append({k: v.clone() for k, v in solver.model.state_dict().items()})
        return next(val_losses), evaluate(batcher)[1]

    monkeypatch.setattr(solver, "evaluate", scripted)
    _, history = solver.fit(s["dl"]("train", True), s["dl"]("val", False))
    assert history["val_loss_values"] == [1.0, 0.5, 0.7, 0.9]  # stopped at patience 2 after the best epoch 1
    assert "Best model at epoch 1 restored" in capsys.readouterr().out
    save_path = solver.config.checkpoint.save_path
    assert not os.path.exists(os.path.join(os.path.dirname(save_path), "best_weights.ckpt"))
    promoted = load_checkpoint(save_path)
    assert promoted["epoch"] == 1 and set(promoted) == {"epoch", "model_state_dict"}
    for name, value in solver.model.state_dict().items():
        assert torch.equal(value, seen[1][name]) and torch.equal(promoted["model_state_dict"][name], value)
    assert not all(torch.equal(seen[1][n], seen[3][n]) for n in seen[1])


def test_training_needs_a_backbone_key(tmp_path, meld_like_root):
    solver, _ = _fresh_text_solver(tmp_path, meld_like_root)
    solver.backbone_key = None
    with pytest.raises(ValueError, match="backbone_key"):
        solver.init_state(3)


# -- entry points ----------------------------------------------------------------------


def _entry_config(src, tmp_path, **test_block):
    with open(src) as f:
        raw = yaml.safe_load(f)
    raw["checkpoint"]["save_path"] = str(tmp_path / "ckpt" / "checkpoint.ckpt")
    raw["train"]["data_loader"]["batch_size"] = raw["val"]["data_loader"]["batch_size"] = 6
    raw["test"]["data_loader"]["batch_size"] = 6
    raw["test"].update(test_block)
    path = str(tmp_path / "entry.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, raw["checkpoint"]["save_path"]


def test_text_entry_points_train_test_embeddings(meld_like_root, tmp_path, monkeypatch, capsys):
    root, sizes = meld_like_root
    monkeypatch.setattr(fe_common.RobertaConfig, "base", classmethod(lambda cls: RobertaConfig(**TEXT_NARROW)))
    config, ckpt = _entry_config(TEXT_CONFIG_PATH, tmp_path, model_path=str(tmp_path / "ckpt" / "checkpoint.ckpt"))
    argv = ["--config", config, "--data-root", root, "--random-init", "--toy-tokenizer", "--f32", "--device", "cpu"]
    state, history = text_train_entry.main([*argv, "--epochs", "3"])  # 2 frozen + 1 fine-tune, dropout 0.1 on
    out = capsys.readouterr().out
    assert f"Loaded {sizes['train']} utterances for training" in out and "Training complete" in out
    assert len(history["loss_values"]) == 3 and np.isfinite(history["loss_values"] + history["val_loss_values"]).all()
    assert state.frozen.step == 2 * -(-sizes["train"] // 6) and state.finetune.step == -(-sizes["train"] // 6)
    assert set(load_checkpoint(ckpt)) == {"epoch", "model_state_dict"}
    result = text_test_entry.main(argv)
    assert np.isfinite(result["loss"]) and 0 <= result["accuracy"] <= 1
    tables = text_embeddings_entry.main(argv, save_dir=str(tmp_path / "emb"))
    assert f"Loaded fine-tuned checkpoint {ckpt}" in capsys.readouterr().out
    assert {m: t.shape for m, t in tables.items()} == {m: (sizes[m], 32) for m in ("train", "val", "test")}
    assert all(np.isfinite(t).all() for t in tables.values())


def test_w2v_entry_points_train_test_embeddings(meld_like_root_with_wavs, tmp_path, monkeypatch, capsys):
    root, sizes = meld_like_root_with_wavs
    monkeypatch.setattr(fe_common.Wav2Vec2Config, "base", classmethod(lambda cls: Wav2Vec2Config(**W2V_NARROW)))
    config, ckpt = _entry_config(W2V_CONFIG_PATH, tmp_path)
    argv = ["--config", config, "--data-root", root, "--random-init", "--f32", "--device", "cpu"]
    state, history = w2v_train_entry.main([*argv, "--epochs", "3"])
    assert "Training complete" in capsys.readouterr().out
    steps = -(-sizes["train"] // 16)  # tpu.batch_size_override, not the loader's 6
    assert state.frozen.step == 2 * steps and state.finetune.step == steps
    assert len(history["loss_values"]) == 3 and np.isfinite(history["loss_values"] + history["val_loss_values"]).all()
    assert set(load_checkpoint(ckpt)) == {"epoch", "model_state_dict"}
    result = w2v_test_entry.main(argv)
    assert np.isfinite(result["loss"]) and 0 <= result["accuracy"] <= 1
    tables = w2v_embeddings_entry.main(argv, save_dir=str(tmp_path / "emb"))
    assert {m: t.shape for m, t in tables.items()} == {m: (sizes[m], 64) for m in ("train", "val", "test")}


@pytest.mark.parametrize("entry", [text_train_entry, w2v_train_entry])
def test_train_entry_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main(["--random-init", "--toy-tokenizer"])
