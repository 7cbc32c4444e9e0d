"""The port's fusion training against the JAX package's, on the CPU.

At a narrow width (d 32, 2 heads, 2 + 2 encoder layers, 1 FAM layer,
float32, dropout 0) both packages start from the same weights
(``state_dict_from_jax``) and see the same batches (the same synthetic
dialogues and batcher seed):

- ``cross_entropy`` and ``balanced_class_weights`` equal ``mer_tpu``'s;
- the optimizer (Adam with L2 decay, ExponentialLR per epoch of updates,
  gradient accumulation 1 and 2) equals ``optimizer_from_config``;
- ``Solver`` trajectories: per-step losses within 2e-5 and parameters after
  8 steps within 2 x lr x steps (below), also from an Adam state carried
  over with ``adam_state_from_jax``;
- ``fit`` with early stopping: the same epochs, losses within 1e-4, the best
  weights restored;
- resume: 2 + 1 epochs equal 3 epochs; ``DeviceFusionBatcher`` equals
  ``FusionBatcher``; the train -> checkpoint -> ``mer_tpu_torch.test`` flow;
  a ``mer_tpu`` msgpack checkpoint is refused, not misread.

Parameter tolerance: Adam divides the first moment by the root of the
second, so a gradient near 0, whose f32 rounding differs in sign or size
between the two packages, moves its parameter by up to lr in either
direction on each step. Such parameters can part by up to 2 x lr x steps
however close the gradients (see ``_assert_params_close``).
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from mer_tpu.core import load_config as jax_load_config
from mer_tpu.data import FusionBatcher as JaxFusionBatcher
from mer_tpu.data import SyntheticFusionDataset as JaxSyntheticFusionDataset
from mer_tpu.models import M2FNet as JaxM2FNet
from mer_tpu.objectives import balanced_class_weights as jax_balanced_class_weights
from mer_tpu.objectives import cross_entropy as jax_cross_entropy
from mer_tpu.train import Solver as JaxSolver
from mer_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mer_tpu.train.solver import optimizer_from_config as jax_optimizer_from_config
from mer_tpu_torch import test as eval_entry
from mer_tpu_torch import train as train_entry
from mer_tpu_torch.core import load_config
from mer_tpu_torch.data import DeviceFusionBatcher, FusionBatcher, SyntheticFusionDataset
from mer_tpu_torch.models import M2FNet, adam_state_from_jax, load_reference_checkpoint, state_dict_from_jax
from mer_tpu_torch.objectives import balanced_class_weights, cross_entropy
from mer_tpu_torch.train import Solver, TrainState, accumulate_and_step, load_checkpoint, optimizer_from_config

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
BATCH = 8
DATA = dict(d_text=D, d_audio=D, mean_len=4.0, max_len=8)  # one length bucket: one compiled shape
LR = 5e-5


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tests run in several worker processes at once; torch's default pool
    (one thread per core in every worker) oversubscribes the cores. Two
    threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_config(path, **solver):
    with open(os.path.join(REPO_ROOT, "src", "config.yaml")) as f:
        raw = yaml.safe_load(f)
    for block in ("AUDIO", "TEXT", "FAM"):
        raw["model"][block].update(embedding_size=D, n_head=2)
    raw["model"]["AUDIO"]["n_encoder_layers"] = raw["model"]["TEXT"]["n_encoder_layers"] = 2
    raw["model"]["FAM"]["n_layers"] = 1
    raw["model"]["CLASSIFIER"]["hidden_size"] = D
    raw["model"]["dropout"] = 0.0
    raw["tpu"].update(compute_dtype="float32", scan_layers=False)
    for mode in ("train", "val", "test"):
        raw[mode]["data_loader"]["batch_size"] = BATCH
    ckpt = os.path.join(os.path.dirname(path), "ckpt", "m2fnet.ckpt")
    raw["checkpoint"].update(save_path=ckpt, load_path=ckpt)
    raw["solver"].update({"lr": LR, **solver})
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _jax_params(config_path, seed=0):
    cfg = jax_load_config(config_path)
    model = JaxM2FNet.from_config(cfg.model)
    x = jnp.zeros((1, 8, D))
    return model, model.init(jax.random.PRNGKey(seed), x, x, jnp.zeros((1, 8), bool))["params"]


def _port_model(config_path, params):
    config = load_config(config_path)
    model = M2FNet.from_config(config.model)
    model.load_state_dict(state_dict_from_jax(_np_params(params), config.model), strict=True)
    return model


def _np_params(params):
    return jax.tree.map(np.array, params)  # copies: mer_tpu's train step donates its state


def _assert_params_close(model, params, model_cfg, steps, lr=LR):
    """Every parameter within 2 lr steps. The key biases (the middle third of
    each in_proj_bias) have a gradient of exactly 0 in exact arithmetic (a
    softmax does not change when a row's scores shift together), so their
    updates are Adam's answer to rounding noise and take either sign; of the
    other parameters, all but one in 10^4 agree within lr / 50 (1e-6 at the
    config's lr)."""
    got = model.state_dict()
    far = total = 0
    for name, want in state_dict_from_jax(_np_params(params), model_cfg).items():
        diff = (got[name] - want).abs()
        assert diff.max().item() <= 2 * lr * steps + 1e-6, name
        if name.endswith("in_proj_bias"):
            d = diff.numel() // 3
            diff = torch.cat([diff[:d], diff[2 * d:]])
        far += int((diff > lr / 50).sum())
        total += diff.numel()
    assert far <= total // 10_000, f"{far} of {total} parameters differ by more than {lr / 50}"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_training")
    path = _write_config(str(tmp / "tiny.yaml"))
    jax_model, params = _jax_params(path)
    return {"tmp": tmp, "config": path, "jax_model": jax_model, "params": params}


# -- objectives ------------------------------------------------------------------


@pytest.mark.parametrize("smoothing, weighted", [(0.0, False), (0.1, False), (0.1, True)])
def test_cross_entropy_matches_jax(smoothing, weighted):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 9, 7)).astype(np.float32) * 3
    labels = rng.integers(-1, 7, size=(4, 9)).astype(np.int32)
    weights = rng.random(7).astype(np.float32) + 0.5 if weighted else None
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), label_smoothing=smoothing,
                             class_weights=None if weights is None else jnp.asarray(weights), ignore_index=-1)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), label_smoothing=smoothing,
                        class_weights=None if weights is None else torch.from_numpy(weights), ignore_index=-1)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # and torch's own CrossEntropyLoss, which the reference trains with
    ref = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).reshape(-1, 7), torch.from_numpy(labels).long().reshape(-1), ignore_index=-1,
        label_smoothing=smoothing, weight=None if weights is None else torch.from_numpy(weights))
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)


def test_balanced_class_weights_match_jax():
    labels = np.array([0, 0, 0, 1, 2, 2, -1, 4, 4, 4, 4])
    np.testing.assert_array_equal(balanced_class_weights(labels), jax_balanced_class_weights(labels))


# -- optimizer -------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_jax_optimizer_from_config(accum):
    """Six micro-steps of random gradients; ExponentialLR with 2 updates per
    epoch, so the learning rate changes within the run. f32: 1e-6."""
    solver_cfg = load_config(os.path.join(REPO_ROOT, "src", "config.yaml")).solver.to_dict()
    solver_cfg.update(lr=1e-2, grad_accum_steps=accum,
                      scheduler={"enabled": True, "scheduler_fn": "ExponentialLR", "gamma": 0.5})
    from mer_tpu_torch.core import Config

    steps_per_epoch = 2 * accum
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(6)]

    opt, _ = jax_optimizer_from_config(Config(solver_cfg), steps_per_epoch)
    params = jax.tree.map(jnp.asarray, p0)
    opt_state = opt.init(params)
    for g in grads:
        updates, opt_state = opt.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    optimizer, schedule = optimizer_from_config(Config(solver_cfg), list(tparams.values()), steps_per_epoch)
    state = TrainState(model=None, optimizer=optimizer)
    updated = []
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy()) if p.grad is None else p.grad + torch.from_numpy(g[k])
        updated.append(accumulate_and_step(state, accum, schedule))
    assert updated == [(i + 1) % accum == 0 for i in range(6)]
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0, atol=1e-6)
    # the moments agree too (found inside MultiSteps when accumulating)
    from mer_tpu_torch.models.convert import _find_adam_moments

    count, mu, nu = _find_adam_moments(opt_state)
    assert int(count) == 6 // accum
    for k, p in tparams.items():
        assert float(optimizer.state[p]["step"]) == 6 // accum
        np.testing.assert_allclose(optimizer.state[p]["exp_avg"].numpy(), np.asarray(mu[k]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(optimizer.state[p]["exp_avg_sq"].numpy(), np.asarray(nu[k]), rtol=0, atol=1e-7)


# -- solver ----------------------------------------------------------------------


def _jax_batches(n_dialogues, seed, shuffle, epochs=1):
    data = JaxSyntheticFusionDataset(n_dialogues=n_dialogues, seed=seed, **DATA)
    batcher = JaxFusionBatcher(data, batch_size=BATCH, shuffle=shuffle, seed=0, sort_by_length=shuffle,
                               process_index=0, process_count=1)
    return [b for _ in range(epochs) for b in batcher]


def test_solver_trajectory_matches_jax(setup):
    """8 steps (f32, dropout 0) from the same weights over the same batches:
    per-step losses within 2e-5, parameters as the module docstring says.
    Then the port resumes from mer_tpu's params and Adam state after step 4
    (``adam_state_from_jax``) and follows mer_tpu through steps 5-8."""
    from mer_tpu.utils.rng import dropout_key

    batches = _jax_batches(40, 0, shuffle=True, epochs=2)[:8]
    jcfg = jax_load_config(setup["config"])
    jsolver = JaxSolver(setup["jax_model"], jcfg)
    jstate = jsolver.init_state(batches[0], steps_per_epoch=5).replace(
        params=jax.tree.map(jnp.array, setup["params"]))
    rng = dropout_key(1)
    jlosses, mid = [], None
    for i, batch in enumerate(batches):
        jstate, loss = jsolver.train_epoch(jstate, [batch], rng)
        jlosses.append(loss)
        if i == 3:
            mid = jax.tree.map(np.array, (jstate.params, jstate.opt_state))

    config = load_config(setup["config"])
    model = _port_model(setup["config"], setup["params"])
    solver = Solver(model, config)
    state = solver.init_state(steps_per_epoch=5)
    losses = [solver.train_epoch(state, [batch])[1] for batch in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-5)
    assert state.step == 8 and losses[-1] < losses[0]
    _assert_params_close(model, jstate.params, config.model, steps=8)

    resumed = _port_model(setup["config"], mid[0])
    solver = Solver(resumed, config)
    state = solver.init_state(steps_per_epoch=5)
    state.optimizer.load_state_dict({**state.optimizer.state_dict(),
                                     "state": adam_state_from_jax(mid[1], mid[0], config.model)})
    state.step = 4
    losses = [solver.train_epoch(state, [batch])[1] for batch in batches[4:]]
    np.testing.assert_allclose(losses, jlosses[4:], rtol=0, atol=2e-5)
    _assert_params_close(resumed, jstate.params, config.model, steps=4)


def _fit_config(tmp, name, **solver):
    os.makedirs(os.path.join(tmp, name), exist_ok=True)
    return _write_config(os.path.join(tmp, name, "tiny.yaml"), **solver)


EARLY_STOP = dict(lr=1e-3, epochs=8, early_stopping={"enabled": True, "patience": 1, "restore_best_weights": True})


def _shifted_labels(dataset) -> list[dict]:
    """The dialogues with every label moved to the next class: the better a
    model fits ``dataset``, the worse its loss here."""
    return [{**d, "emotion": (d["emotion"] + 1) % 7} for d in (dataset[i] for i in range(len(dataset)))]


def test_fit_with_early_stopping_matches_jax(setup):
    """Validation on the training dialogues with shifted labels, so its loss
    rises once training fits and patience 1 stops the run. Both packages stop
    at the same epoch, per-epoch losses within 1e-4 (lr 1e-3), and both
    restore the best epoch's weights. mer_tpu's ``fit`` draws one example
    batch from the train batcher first, which advances its shuffle by an
    epoch; the port's batcher is advanced the same way."""
    tmp = str(setup["tmp"])
    train = dict(n_dialogues=40, seed=0, **DATA)

    jcfg = jax_load_config(_fit_config(tmp, "fit_jax", **EARLY_STOP))
    jtrain = JaxFusionBatcher(JaxSyntheticFusionDataset(**train), batch_size=BATCH, shuffle=True, seed=0,
                              process_index=0, process_count=1)
    jval = JaxFusionBatcher(_shifted_labels(JaxSyntheticFusionDataset(**train)), batch_size=BATCH, shuffle=False,
                            sort_by_length=False, process_index=0, process_count=1)
    jsolver = JaxSolver(setup["jax_model"], jcfg)
    jstate = jsolver.init_state(next(iter(jval)), len(jtrain)).replace(  # jval: no shuffle to advance
        params=jax.tree.map(jnp.array, setup["params"]))
    jstate, jhistory = jsolver.fit(jtrain, jval, jstate)

    path = _fit_config(tmp, "fit_port", **EARLY_STOP)
    config = load_config(path)
    cpu = torch.device("cpu")
    ptrain = DeviceFusionBatcher(SyntheticFusionDataset(**train), batch_size=BATCH, shuffle=True, seed=0, device=cpu)
    pval = DeviceFusionBatcher(_shifted_labels(SyntheticFusionDataset(**train)), batch_size=BATCH, shuffle=False,
                               sort_by_length=False, device=cpu)
    next(iter(ptrain))
    model = _port_model(path, setup["params"])
    state, history = Solver(model, config).fit(ptrain, pval)

    n = len(jhistory["loss_values"])
    assert 2 <= n < 8 and len(history["loss_values"]) == n
    assert history["val_loss_values"][-1] > min(history["val_loss_values"])
    for key in ("loss_values", "val_loss_values"):
        np.testing.assert_allclose(history[key], jhistory[key], rtol=0, atol=1e-4)
    best = int(np.argmin(history["val_loss_values"]))
    saved = load_checkpoint(config.checkpoint.save_path)
    assert saved["epoch"] == best and not os.path.exists(os.path.join(tmp, "fit_port", "ckpt", "best_weights.ckpt"))
    for name, value in model.state_dict().items():
        torch.testing.assert_close(saved["model_state_dict"][name], value, rtol=0, atol=0)
    _assert_params_close(model, jstate.params, config.model, steps=5 * (best + 1), lr=1e-3)


@pytest.mark.parametrize("accum, first", [(1, 2), (2, 1)])
def test_resume_two_plus_one_epochs_equals_three(setup, accum, first):
    """Checkpoint after ``first`` epochs, resume for the rest (optimizer
    state, step, best loss and patience restored): the same weights as 3
    epochs straight, bit for bit (f32, CPU). With accumulation 2 and 3 steps
    per epoch the checkpoint falls inside an accumulation window, whose
    gradients it carries. The resumed run's batcher seeks its shuffle to
    the epoch it resumes at."""
    tmp = str(setup["tmp"])
    cpu = torch.device("cpu")
    data = SyntheticFusionDataset(n_dialogues=24, seed=0, **DATA)
    resume = dict(epochs=3, grad_accum_steps=accum,
                  early_stopping={"enabled": True, "patience": 5, "restore_best_weights": True})

    def run(name, epochs, load=False):
        path = _fit_config(tmp, name, **resume)
        config = load_config(path)
        if load:
            config = config.override(checkpoint__load_checkpoint=True, checkpoint__load_path=load)
        config = config.override(solver__epochs=epochs)
        batcher = DeviceFusionBatcher(data, batch_size=BATCH, shuffle=True, seed=0, device=cpu)
        val = DeviceFusionBatcher(data, batch_size=BATCH, sort_by_length=False, device=cpu)
        model = _port_model(path, setup["params"])
        state, history = Solver(model, config).fit(batcher, val)
        return config, state, history

    _, straight, history3 = run(f"straight{accum}", 3)
    config, _, _ = run(f"resumed{accum}", first)
    if accum == 2:
        assert load_checkpoint(config.checkpoint.save_path)["accumulated_grads"]
    _, resumed, history = run(f"resumed{accum}", 3, load=config.checkpoint.save_path)
    assert resumed.step == straight.step == 9 and history["loss_values"] == history3["loss_values"][first:]
    for name, value in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[name], value, rtol=0, atol=0, msg=name)


def test_resume_replays_dropout_and_shuffle(setup):
    """Dropout 0.4 (``nn.Dropout`` and attention dropout), f32: 2 epochs, a
    checkpoint, and a resumed third epoch give the losses (within 1e-6) and
    the weights of 3 epochs straight. The dropout generators are seeded from
    (seed, step) and the resumed batcher seeks its shuffle to epoch 2, so
    nothing here advances it by hand."""
    tmp = str(setup["tmp"])
    cpu = torch.device("cpu")
    data = SyntheticFusionDataset(n_dialogues=16, seed=0, **DATA)
    resume = dict(epochs=3, early_stopping={"enabled": False, "patience": 5, "restore_best_weights": False})

    def run(name, epochs, load=None):
        config = load_config(_fit_config(tmp, name, **resume)).override(model__dropout=0.4, solver__epochs=epochs)
        if load:
            config = config.override(checkpoint__load_checkpoint=True, checkpoint__load_path=load)
        batcher = DeviceFusionBatcher(data, batch_size=BATCH, shuffle=True, seed=0, device=cpu)
        val = DeviceFusionBatcher(data, batch_size=BATCH, sort_by_length=False, device=cpu)
        model = M2FNet.from_config(config.model)
        model.load_state_dict(_port_model(setup["config"], setup["params"]).state_dict())
        state, history = Solver(model, config).fit(batcher, val)
        return config, state, history

    _, straight, history3 = run("dropout_straight", 3)
    config, _, history2 = run("dropout_resumed", 2)
    _, resumed, history1 = run("dropout_resumed", 3, load=config.checkpoint.save_path)
    assert resumed.step == straight.step == 6
    np.testing.assert_allclose(history2["loss_values"] + history1["loss_values"], history3["loss_values"],
                               rtol=0, atol=1e-6)
    for name, value in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[name], value, rtol=0, atol=0, msg=name)


def test_device_batcher_equals_fusion_batcher():
    """Same seed, same batches, two epochs, a partial last batch and several
    buckets; tables on the CPU here, on the card in training."""
    data = SyntheticFusionDataset(n_dialogues=30, seed=4, d_text=6, d_audio=5)
    for shuffle in (True, False):
        host = FusionBatcher(data, batch_size=8, shuffle=shuffle, seed=3, sort_by_length=shuffle)
        device = DeviceFusionBatcher(data, batch_size=8, shuffle=shuffle, seed=3, sort_by_length=shuffle,
                                     device="cpu")
        assert len(device) == len(host) == 4
        for want, got in zip([b for _ in range(2) for b in host], [b for _ in range(2) for b in device]):
            assert set(got) == set(want)
            for key, value in want.items():
                assert got[key].dtype == torch.from_numpy(value).dtype, key
                np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_train_entry_without_a_card_raises(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_entry.main(["--synthetic", "--config", setup["config"], "--epochs", "1"])


def test_train_checkpoint_test_flow(setup, tmp_path, capsys):
    """``python -m mer_tpu_torch.train`` writes a checkpoint that
    ``python -m mer_tpu_torch.test --checkpoint`` reads, with the trained
    weights; a mer_tpu msgpack checkpoint at that path is refused."""
    path = _write_config(str(tmp_path / "flow.yaml"), epochs=2)
    state, history = train_entry.main(["--synthetic", "--config", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Loaded 200 dialogues for training" in out and "Training complete" in out
    assert len(history["loss_values"]) == 2 and all(np.isfinite(history["loss_values"]))
    ckpt = load_config(path).checkpoint.save_path
    saved = load_checkpoint(ckpt)
    assert saved["epoch"] == 1 and saved["extra"]["step"] == 2 * 25 and saved["optimizer_state_dict"]["state"]
    for name, value in state.model.state_dict().items():
        torch.testing.assert_close(load_reference_checkpoint(ckpt)[name], value, rtol=0, atol=0)
    metrics = eval_entry.main(["--synthetic", "--config", path, "--checkpoint", ckpt, "--device", "cpu"])
    assert set(metrics) == {"accuracy", "weighted_f1", "pooled_accuracy", "pooled_weighted_f1"}

    jax_save_checkpoint(ckpt, epoch=0, params=setup["params"])
    with pytest.raises(ValueError, match="not a torch checkpoint"):
        eval_entry.main(["--synthetic", "--config", path, "--checkpoint", ckpt, "--device", "cpu"])
    resume = load_config(path).override(checkpoint__load_checkpoint=True)
    with pytest.raises(ValueError, match="not a torch checkpoint"):
        Solver(_port_model(path, setup["params"]), resume).fit([], [])


def test_bf16_training_keeps_f32_weights_and_adam_state(setup, monkeypatch):
    """compute_dtype bf16, dropout 0.4: forward and backward run under
    autocast, every attention call takes bf16 q, k, v with dropout on, and
    the weights and Adam moments stay f32."""
    from mer_tpu_torch.ops import flash_attention as fa

    config = load_config(setup["config"]).override(tpu__compute_dtype="bfloat16", model__dropout=0.4)
    model = M2FNet.from_config(config.model)
    model.load_state_dict(_port_model(setup["config"], setup["params"]).state_dict())
    seen = []
    forward = fa.flash_attention_forward
    monkeypatch.setattr(fa, "flash_attention_forward",
                        lambda q, k, v, mask, seed, rate: (seen.append((q.dtype, rate)), forward(q, k, v, mask, seed, rate))[1])
    solver = Solver(model, config)
    state = solver.init_state(steps_per_epoch=2)
    _, loss = solver.train_epoch(state, _jax_batches(16, 0, shuffle=False))
    assert np.isfinite(loss) and state.step == 2
    assert seen == [(torch.bfloat16, 0.4)] * (2 * (2 + 2 + 1))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    moments = [s[k] for s in state.optimizer.state.values() for k in ("exp_avg", "exp_avg_sq")]
    assert moments and {m.dtype for m in moments} == {torch.float32}
