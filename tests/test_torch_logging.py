"""The port's run logger and ``watch_norms`` (``mer_tpu_torch/utils/logging.py``)
against ``mer_tpu/utils/logging.py``, on the CPU, under a wandb stub like
``tests/test_logging_watch.py``'s:

- ``RunLogger`` reads the ``wandb`` block as ``mer_tpu``'s does (the same
  ``wants_*``, ``watch_log`` and ``watch_freq`` for the same configs), and
  the payloads of ``log_epoch``, ``log_step``, ``log_image`` and ``log_html``
  equal ``mer_tpu``'s;
- the fusion, feature-extractor and mel solvers log a running loss per step
  and the norms on steps 0, freq, 2 freq, ... of an epoch, as ``mer_tpu``'s
  fusion solver does on the same batches (the same sequence of payload kinds);
- ``watch_norms`` of the port's M2FNet equal ``mer_tpu``'s ``watch_norms``
  for the same weights and batch within 1e-5, matched through
  ``convert.py``'s names (a port tensor's norm is that of the ``mer_tpu``
  leaves it is made of), in the three modes;
- with wandb enabled but not installed the logger says so in one line and
  logs to the console; with nothing recording an epoch fetches its loss from
  the device once (no per-step ``.item()``).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mer_tpu.core import Config as JaxConfig
from mer_tpu.data import FusionBatcher as JaxFusionBatcher
from mer_tpu.data import SyntheticFusionDataset as JaxSyntheticFusionDataset
from mer_tpu.models import M2FNet as JaxM2FNet
from mer_tpu.objectives import cross_entropy as jax_cross_entropy
from mer_tpu.train import Solver as JaxSolver
from mer_tpu.utils import logging as jax_logging
from mer_tpu_torch.core import CONFIG_PATH, Config, load_config
from mer_tpu_torch.feature_extractors.audio_mel import MEL_CONFIG_PATH
from mer_tpu_torch.models import M2FNet, RobertaConfig, TextERC, state_dict_from_jax
from mer_tpu_torch.models.resnet import mel_extractor_from_seed
from mer_tpu_torch.objectives import cross_entropy
from mer_tpu_torch.train import FESolver, Solver, TrainState
from mer_tpu_torch.train.mel_solver import MelSolver
from mer_tpu_torch.utils.logging import RunLogger, watch_norms

D = 16


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def wandb_stub(monkeypatch):
    """A minimal wandb lookalike that records every init() and log() payload."""
    stub = types.ModuleType("wandb")
    stub.logged, stub.inits = [], []
    stub.init = lambda **kw: stub.inits.append(kw)
    stub.log = lambda payload: stub.logged.append(payload)
    stub.finish = lambda: stub.logged.append("finish")
    stub.Image = lambda path: ("image", path)
    stub.Html = lambda path: ("html", path)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return stub


def _cfg(freq=2, watch_log="all", enabled=True, watch_model=True):
    return {
        "checkpoint": {"save_path": "unused.ckpt", "save_checkpoint": False},
        "model": {"dropout": 0.0},
        "solver": {"lr": 1e-3, "weight_decay": 0.0, "epochs": 1, "early_stopping": {"enabled": False}},
        "wandb": {"enabled": enabled, "project_name": "test", "entity": "", "watch_model": watch_model,
                  "watch_log": watch_log, "watch_log_freq": freq, "resume_run": True, "resume_run_id": "abc"},
        "tpu": {"seed": 0, "compute_dtype": "float32"},
    }


@pytest.mark.parametrize("enabled, watch_model, watch_log, freq", [
    (True, True, "all", 2), (True, False, "gradients", 5), (False, True, "parameters", 3)])
def test_logger_reads_the_wandb_block_as_mer_tpu(wandb_stub, enabled, watch_model, watch_log, freq):
    raw = _cfg(freq, watch_log, enabled, watch_model)
    port, ref = RunLogger(Config(raw)), jax_logging.RunLogger(JaxConfig(raw))
    for attr in ("wants_step_logs", "wants_watch_logs", "watch_log", "watch_freq"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    if enabled:
        port_init, ref_init = wandb_stub.inits
        assert port_init.keys() == ref_init.keys()
        for key in ("project", "entity", "resume", "id", "config"):
            assert port_init[key] == ref_init[key], key
    assert RunLogger(None).watch_freq == jax_logging.RunLogger(None).watch_freq == 100


def test_payloads_equal_mer_tpu(wandb_stub):
    raw = _cfg()
    loggers = (RunLogger(Config(raw)), jax_logging.RunLogger(JaxConfig(raw)))
    logs = []
    for logger in loggers:
        wandb_stub.logged.clear()
        logger.log_step(1.5)
        logger.log_step(1.25)
        logger.log_epoch(3, lr=1e-4, loss_train=1.0, loss_val=2.0, accuracy=0.5, weighted_f1=0.25,
                         epoch_seconds=1.5, extra={"Perf/Tokens": 10})
        logger.log_epoch(4, lr=1e-4, loss_train=1.0, loss_val=2.0, accuracy=0.5, weighted_f1=0.25)
        logger.log_image("Visualization_png", "a.png")
        logger.log_html("Visualization_html", "a.html")
        logger.finish()
        logs.append(list(wandb_stub.logged))
    assert logs[0] == logs[1]


def _batches(n_dialogues=24):
    data = JaxSyntheticFusionDataset(n_dialogues=n_dialogues, seed=0, d_text=D, d_audio=D, mean_len=4.0, max_len=8)
    return list(JaxFusionBatcher(data, batch_size=8, shuffle=False, process_index=0, process_count=1))


def _model_block() -> dict:
    """src/config.yaml's model block at d 16, 2 heads, one layer a stack, dropout 0."""
    with open(CONFIG_PATH) as f:
        model = yaml.safe_load(f)["model"]
    for block in ("AUDIO", "TEXT", "FAM"):
        model[block].update(embedding_size=D, n_head=2)
    model["AUDIO"]["n_encoder_layers"] = model["TEXT"]["n_encoder_layers"] = model["FAM"]["n_layers"] = 1
    model["CLASSIFIER"]["hidden_size"] = D
    model["dropout"] = 0.0
    return model


def _model_cfg():
    return Config(_model_block())


@pytest.fixture(scope="module")
def fusion():
    """mer_tpu's narrow M2FNet and its params, the port's model holding them."""
    jax_model = JaxM2FNet.from_config(JaxConfig(_model_block()))
    x = jnp.zeros((1, 8, D))
    params = jax_model.init(jax.random.PRNGKey(0), x, x, jnp.zeros((1, 8), bool))["params"]
    params = jax.tree.map(np.array, params)
    return {"jax_model": jax_model, "params": params}


def _port_model(fusion):
    model = M2FNet.from_config(_model_cfg())
    model.load_state_dict(state_dict_from_jax(fusion["params"], _model_cfg()), strict=True)
    return model


def _kinds(logged):
    return ["watch" if any(k.startswith(("gradients/", "parameters/")) for k in p) else
            "step" if "Train/Running_loss" in p else "other" for p in logged if p != "finish"]


def test_fusion_solver_logs_like_mer_tpu(fusion, wandb_stub):
    """Three batches at freq 2: norms on steps 0 and 2 and a running loss on
    every step, in mer_tpu's order; the running losses within 1e-5."""
    batches = _batches()
    raw = _cfg(freq=2)
    jsolver = JaxSolver(fusion["jax_model"], JaxConfig(raw))
    jstate = jsolver.init_state(batches[0], steps_per_epoch=len(batches)).replace(
        params=jax.tree.map(jnp.array, fusion["params"]))
    jsolver.train_epoch(jstate, batches, jax.random.PRNGKey(0))
    want = list(wandb_stub.logged)
    wandb_stub.logged.clear()
    solver = Solver(_port_model(fusion), Config(raw))
    state = solver.init_state(steps_per_epoch=len(batches))
    solver.train_epoch(state, batches)
    got = list(wandb_stub.logged)
    assert _kinds(got) == _kinds(want) == ["watch", "step", "step", "watch", "step"]
    np.testing.assert_allclose([p["Train/Running_loss"] for p in got if "Train/Running_loss" in p],
                               [p["Train/Running_loss"] for p in want if "Train/Running_loss" in p], rtol=1e-5)
    assert [p["Params/Global_step"] for p in got if "Train/Running_loss" in p] == [1, 2, 3]


def _leaf_ids(tree):
    """``tree`` with every leaf filled with its own index (exact in f32)."""
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, [np.full(np.shape(l), i, np.float32) for i, l in enumerate(leaves)]), leaves


@pytest.mark.parametrize("watch_log", ["all", "gradients", "parameters"])
def test_watch_norms_equal_mer_tpu(fusion, watch_log):
    """Same weights, same batch, the reference CE: each port tensor's norm is
    the root of the sum of its mer_tpu leaves' squared norms (the leaves are
    found by converting a tree of leaf indices), within 1e-5."""
    batch = _batches()[0]
    params = jax.tree.map(jnp.asarray, fusion["params"])

    def loss_fn(p):
        logits = fusion["jax_model"].apply({"params": p}, batch["text"], batch["audio"], batch["padding_mask"],
                                           deterministic=True)
        return jax_cross_entropy(logits, batch["emotion"], label_smoothing=0.1, ignore_index=-1)

    grads = jax.grad(loss_fn)(params)
    want = {k: float(v) for k, v in jax_logging.watch_norms(grads, params, watch_log).items()}

    model = _port_model(fusion)
    logits = model(*(torch.from_numpy(np.asarray(batch[k])) for k in ("text", "audio", "padding_mask")))
    cross_entropy(logits, torch.from_numpy(np.asarray(batch["emotion"])), label_smoothing=0.1,
                  ignore_index=-1).backward()
    got = {k: float(v) for k, v in watch_norms(model, watch_log).items()}

    ids, _ = _leaf_ids(fusion["params"])
    paths = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(fusion["params"])[0]]
    members = {name: sorted({int(i) for i in np.unique(t.numpy())})
               for name, t in state_dict_from_jax(ids, _model_cfg()).items()}
    prefixes = [p for p in ("gradients", "parameters") if watch_log in (p, "all")]
    assert set(got) == {f"{p}/{name}" for p in prefixes for name, _ in model.named_parameters()}
    for key, value in got.items():
        prefix, name = key.split("/", 1)
        expect = np.sqrt(sum(want[f"{prefix}/{paths[i]}"] ** 2 for i in members[name]))
        np.testing.assert_allclose(value, expect, rtol=1e-5, atol=1e-7, err_msg=key)


def test_fe_and_mel_solvers_watch_every_freq_steps(wandb_stub):
    """The feature-extractor solver (five text batches, freq 2) and the mel
    solver's watched step: norms on steps 0, 2, 4 and a running loss on each."""
    cfg = RobertaConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                        intermediate_size=32, max_position_embeddings=40)
    raw = _cfg(freq=2)
    raw["solver"].update(frozen_lr=1e-3, finetuning_lr=1e-3, warmup_epochs=1, num_frozen_epochs=0,
                         early_stopping={"enabled": False, "patience": 1, "restore_best_weights": False})
    rng = np.random.default_rng(0)
    batches = [{"text": rng.integers(3, 50, (4, 12)).astype(np.int32), "attention_mask": np.ones((4, 12), np.int32),
                "emotion": rng.integers(0, 7, 4).astype(np.int32)} for _ in range(5)]
    to_inputs = lambda b, device: tuple(torch.from_numpy(b[k]).to(device) for k in ("text", "attention_mask"))
    solver = FESolver(TextERC(cfg), Config(raw), batch_to_inputs=to_inputs, backbone_key="roberta")
    state = solver.init_state(steps_per_epoch=5)
    solver.train_epoch(state, batches, epoch=0)
    assert _kinds(wandb_stub.logged) == ["watch", "step", "step", "watch", "step", "step", "watch", "step"]
    watched = [p for p in wandb_stub.logged if "parameters/roberta.embeddings.word_embeddings.weight" in p]
    assert len(watched) == 3 and all(np.isfinite(list(p.values())).all() for p in watched)

    wandb_stub.logged.clear()
    mel_cfg = load_config(MEL_CONFIG_PATH).override(wandb=raw["wandb"])
    mel = MelSolver(mel_extractor_from_seed(0), mel_cfg, None, None)
    mel._schedule = lambda n: 1e-4
    state = TrainState(mel.model, torch.optim.Adam(mel.model.parameters(), lr=1e-4))
    loss = mel.train_step(state, torch.rand(6, 3, 16, 16), watch=True)
    payload, = wandb_stub.logged
    assert torch.isfinite(loss) and set(payload) == {f"{p}/{n}" for p in ("gradients", "parameters")
                                                     for n, _ in mel.model.named_parameters()}


def test_without_wandb_the_console_and_no_step_fetch(fusion, monkeypatch, capsys):
    """wandb enabled but absent: one line, then the console; an epoch of
    three steps fetches from the device once in the solver (``.item()`` of
    its mean loss), and with the stub recording once per step more."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    logger = RunLogger(Config(_cfg()))
    assert capsys.readouterr().out == "wandb enabled in config but not installed; falling back to console logging\n"
    assert not logger.wants_step_logs and not logger.wants_watch_logs and not logger.watch_step(0)
    logger.log_watch({"gradients/w": torch.ones(())})
    logger.log_image("k", "a.png")
    logger.log_epoch(0, lr=1e-3, loss_train=1.0, loss_val=2.0, accuracy=0.5, weighted_f1=0.4, epoch_seconds=1.2)
    assert "Epoch: 0" in capsys.readouterr().out
    assert RunLogger(Config(_cfg(enabled=False))) and capsys.readouterr().out == ""

    calls = []
    item = torch.Tensor.item

    def counted(self):  # the fetches the solver itself makes (the optimizer reads its step counts too)
        if sys._getframe(1).f_code.co_filename.endswith(os.path.join("train", "solver.py")):
            calls.append(1)
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", counted)
    batches = _batches()
    solver = Solver(_port_model(fusion), Config(_cfg()))
    solver.train_epoch(solver.init_state(steps_per_epoch=3), batches)
    assert len(calls) == 1

    stub = types.ModuleType("wandb")
    stub.init, stub.log = (lambda **kw: None), (lambda payload: None)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    calls.clear()
    solver = Solver(_port_model(fusion), Config(_cfg(watch_model=False)))
    solver.train_epoch(solver.init_state(steps_per_epoch=3), batches)
    assert len(calls) == 1 + len(batches)
