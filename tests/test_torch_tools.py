"""The port's reader of ``mer_tpu`` checkpoints and ``python -m
mer_tpu_torch.tools`` against the JAX package's, on the CPU.

- ``train/flax_msgpack.py`` (plain Python, no msgpack or flax) equals
  ``mer_tpu.train.checkpoint.load_checkpoint`` / ``load_checkpoint_sharded`` leaf
  by leaf, exactly, on files ``mer_tpu`` writes here: fusion (unrolled and
  scanned encoders, bf16 leaves, arrays chunked by a lowered
  ``flax.serialization.MAX_CHUNK_SIZE``, a two-process shard directory), mel
  with ``batch_stats``, and the text and wav2vec2 extractors in both layouts;
  each converts to a ``state_dict`` the port's model loads strictly. A missing
  shard file, an uncovered region and a file that is no checkpoint raise;
- the fusion evaluation reads a ``mer_tpu`` checkpoint: logits within 1e-4 of
  ``mer_tpu``'s, and ``.test`` the metrics of the same weights in a ``.pth``;
  the text ``.test`` and the wav2vec2 ``.embeddings`` take ``mer_tpu`` files
  (scanned file, shard directory) and give what the same weights in a torch
  file give;
- resume: the fusion solver (accumulation 1 and 2, the second inside an open
  window) and the mel solver continue ``mer_tpu``'s trajectory for 3 steps
  from its checkpoint, losses within 1e-5 relative, dropout off; a file
  without Adam moments is refused by name;
- ``tools``: ``inspect`` gives ``mer_tpu.tools.inspect_checkpoint``'s dict,
  ``export-torch`` writes ``mer_tpu.tools.export_torch``'s ``state_dict``
  exactly, ``preflight`` passes ``tests/test_utils.py``'s cases, exits 0 when
  everything is present and raises nothing without a card; a subprocess that
  reads a ``mer_tpu`` file and runs the tools imports no msgpack, flax, JAX or
  huggingface_hub.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from mer_tpu import tools as jax_tools
from mer_tpu.core import load_config as jax_load_config
from mer_tpu.data import FusionBatcher as JaxFusionBatcher
from mer_tpu.data import MelFeatureDataset as JaxMelFeatureDataset
from mer_tpu.data import SyntheticFusionDataset as JaxSyntheticFusionDataset
from mer_tpu.models import M2FNet as JaxM2FNet
from mer_tpu.models import roberta as jax_roberta
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.models.resnet import AudioMelFeatureExtractor as JaxExtractor
from mer_tpu.train import MelSolver as JaxMelSolver
from mer_tpu.train import Solver as JaxSolver
from mer_tpu.train import checkpoint as jax_ckpt
from mer_tpu.utils.rng import dropout_key
from mer_tpu_torch import test as eval_entry
from mer_tpu_torch import tools
from mer_tpu_torch.core import load_config
from mer_tpu_torch.data import MelFeatureDataset
from mer_tpu_torch.feature_extractors import fe_common
from mer_tpu_torch.feature_extractors.audio_mel import MEL_CONFIG_PATH
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import embeddings as w2v_embeddings_entry
from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH
from mer_tpu_torch.feature_extractors.text import test as text_test_entry
from mer_tpu_torch.models import (AudioERC, AudioMelFeatureExtractor, M2FNet, RobertaConfig, TextERC,
                                  Wav2Vec2Config, audio_state_dict_from_jax, mel_state_dict_from_jax,
                                  state_dict_from_jax, text_state_dict_from_jax)
from mer_tpu_torch.models.convert import load_model_state_dict, read_checkpoint
from mer_tpu_torch.serving.engine import build_model
from mer_tpu_torch.train import Solver, load_checkpoint
from mer_tpu_torch.train import flax_msgpack
from mer_tpu_torch.train.mel_solver import MelSolver

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, BATCH, LR = 32, 8, 5e-5
DATA = dict(d_text=D, d_audio=D, mean_len=4.0, max_len=8)
TEXT_NARROW = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=520)
W2V_NARROW = dict(conv_dim=(32,) * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_fusion_config(path, **solver):
    """src/config.yaml at d 32, 2 heads, 2 + 2 encoder layers, 1 FAM layer,
    float32, dropout 0, checkpoints beside ``path``."""
    with open(os.path.join(REPO_ROOT, "src", "config.yaml")) as f:
        raw = yaml.safe_load(f)
    for block in ("AUDIO", "TEXT", "FAM"):
        raw["model"][block].update(embedding_size=D, n_head=2)
    raw["model"]["AUDIO"]["n_encoder_layers"] = raw["model"]["TEXT"]["n_encoder_layers"] = 2
    raw["model"]["FAM"]["n_layers"] = 1
    raw["model"]["CLASSIFIER"]["hidden_size"] = D
    raw["model"]["dropout"] = 0.0
    raw["tpu"].update(compute_dtype="float32", scan_layers=False, train_scan_chunk=0)
    for mode in ("train", "val", "test"):
        raw[mode]["data_loader"]["batch_size"] = BATCH
    ckpt = os.path.join(os.path.dirname(path), "ckpt", "m2fnet.ckpt")
    raw["checkpoint"].update(save_path=ckpt, load_path=ckpt)
    raw["solver"].update({"lr": LR, **solver})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _fusion_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    a = rng.normal(size=(2, 5, D)).astype(np.float32)
    mask = np.zeros((2, 5), bool)
    mask[1, 3:] = True
    return x, a, mask


@pytest.fixture(scope="module")
def fusion(tmp_path_factory):
    """The narrow config and mer_tpu's M2FNet params in both layouts."""
    tmp = tmp_path_factory.mktemp("torch_tools")
    path = _write_fusion_config(str(tmp / "fusion" / "tiny.yaml"))
    cfg = jax_load_config(path)
    x = jnp.zeros((1, 8, D))
    out = {"tmp": tmp, "config": path}
    for scan in (False, True):
        model = JaxM2FNet.from_config(cfg.model, scan_layers=scan)
        params = model.init(jax.random.PRNGKey(0), x, x, jnp.zeros((1, 8), bool))["params"]
        out["scan" if scan else "unrolled"] = (model, _np_tree(params))
    return out


@pytest.fixture(scope="module")
def extractors():
    """mer_tpu's mel extractor (params and perturbed batch stats) and the
    narrow text and wav2vec2 extractors in both layouts."""
    mel = JaxExtractor().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 16, 3)))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda s: np.asarray(s) + np.abs(rng.normal(size=s.shape)).astype(np.float32) * 0.1,
                         mel["batch_stats"])
    out = {"mel": (_np_tree(mel["params"]), stats)}
    for scan in (False, True):
        text = jax_roberta.TextERC(jax_roberta.RobertaConfig(**TEXT_NARROW), scan_layers=scan).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
        w2v = jax_w2v.AudioERC(jax_w2v.Wav2Vec2Config(**W2V_NARROW), scan_layers=scan).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 800)), jnp.full((1,), 800, jnp.int32))["params"]
        layout = "scan" if scan else "unrolled"
        out[f"text_{layout}"], out[f"wav2vec2_{layout}"] = _np_tree(text), _np_tree(w2v)
    return out


def _assert_trees_equal(got, want, where="payload"):
    """Leaf by leaf, exactly: the same structure, dtypes and values
    (bfloat16 leaves by their bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{where}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and str(np.asarray(want).dtype) == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16), err_msg=where)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and np.shape(got) == np.shape(want), where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def _write_sharded(dirpath, tree, opt_state=None, extra=None):
    """A two-process shard directory as ``mer_tpu`` writes it: leaves whose
    first axis is even split over two devices, the rest replicated."""
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("x",))

    def place(x):
        spec = P("x") if np.ndim(x) and np.shape(x)[0] % 2 == 0 else P()
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    placed = jax.tree.map(place, tree)
    for pi in (0, 1):
        jax_ckpt.save_checkpoint_sharded(dirpath, epoch=4, params=placed, opt_state=opt_state,
                                         extra=extra, process_index=pi, process_count=2)
    return str(dirpath)


def _case(name, fusion, extractors, tmp, monkeypatch):
    """(path, kind, convert) for one case: ``convert(params, extra)`` is the
    port's converter over ``mer_tpu``'s loaded params."""
    cfg = load_config(fusion["config"]).model
    path = str(tmp / f"{name}.ckpt")
    extra = {"step": 7, "min_loss_val": 0.5, "patience_counter": 2}
    fusion_sd = lambda params, extra: state_dict_from_jax(params, cfg)
    if name.startswith("fusion"):
        params = fusion["scan" if name == "fusion_scan" else "unrolled"][1]
        if name == "fusion_bf16":
            params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
        if name == "fusion_chunked":
            monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)  # arrays of over 64 f32 chunk
        if name == "fusion_sharded":
            return _write_sharded(tmp / name, params, extra=extra), "fusion", fusion_sd
        jax_ckpt.save_checkpoint(path, epoch=4, params=params, extra=extra)
        return path, "fusion", fusion_sd
    if name == "mel":
        params, stats = extractors["mel"]
        jax_ckpt.save_checkpoint(path, epoch=4, params=params, extra={**extra, "batch_stats": stats})
        return path, "mel", lambda params, extra: mel_state_dict_from_jax(params, extra["batch_stats"])
    convert = text_state_dict_from_jax if name.startswith("text") else audio_state_dict_from_jax
    jax_ckpt.save_checkpoint(path, epoch=4, params=extractors[name])
    return path, name.split("_")[0], lambda params, extra: convert(params)


def _port_model(kind):
    return {"fusion": None, "mel": AudioMelFeatureExtractor, "text": lambda: TextERC(RobertaConfig(**TEXT_NARROW)),
            "wav2vec2": lambda: AudioERC(Wav2Vec2Config(**W2V_NARROW))}[kind]


CASES = ["fusion_unrolled", "fusion_scan", "fusion_bf16", "fusion_chunked", "fusion_sharded", "mel",
         "text_unrolled", "text_scan", "wav2vec2_unrolled", "wav2vec2_scan"]


@pytest.mark.parametrize("name", CASES)
def test_reader_equals_mer_tpu_and_converts(name, fusion, extractors, tmp_path, monkeypatch):
    """The payload equals mer_tpu's reader's leaf by leaf; the converted
    ``state_dict`` equals the converter over mer_tpu's loaded params and
    loads strictly into the port's model."""
    path, kind, convert = _case(name, fusion, extractors, tmp_path, monkeypatch)
    want = jax_ckpt.load_checkpoint_auto(path)
    got = flax_msgpack.load(path)
    _assert_trees_equal(got, want)
    if name == "fusion_chunked":  # the file really holds chunks
        with open(path, "rb") as f:
            assert b"__msgpack_chunked_array__" in f.read()
    cfg = load_config(fusion["config"]).model
    sd = load_model_state_dict(path, kind, cfg)
    expect = convert(want["params"] if "bf16" not in name else jax.tree.map(lambda x: x.astype(np.float32),
                                                                           want["params"]), want["extra"])
    assert set(sd) == set(expect)
    for k, v in expect.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    model = M2FNet.from_config(cfg) if kind == "fusion" else _port_model(kind)()
    model.load_state_dict(sd, strict=True)
    payload = load_checkpoint(path, kind, cfg)
    assert payload["epoch"] == 4 and "optimizer_state_dict" not in payload
    if kind in ("fusion", "mel"):
        assert payload["extra"] == {"step": 7, "min_loss_val": 0.5, "patience_counter": 2}
    if kind == "mel":
        np.testing.assert_array_equal(sd["resnet18.bn1.running_var"].numpy(),
                                      np.asarray(extractors["mel"][1]["resnet18"]["bn1"]["var"]))
    with pytest.raises(ValueError, match="not a"):
        load_model_state_dict(path, "text" if kind != "text" else "mel", cfg)


def test_shard_directory_faults_raise(fusion, tmp_path):
    """A missing shard file, a region no shard covers and a file that is no
    checkpoint raise, as in mer_tpu."""
    params = fusion["unrolled"][1]
    shard_dir = _write_sharded(tmp_path / "two", params)
    os.remove(os.path.join(shard_dir, "shard00000-of-00002.msgpack"))
    for reader in (jax_ckpt.load_checkpoint_sharded, flax_msgpack.load):
        with pytest.raises(ValueError, match="shard files"):
            reader(shard_dir)

    torn = tmp_path / "torn"
    torn.mkdir()
    leaf = {"__ckpt_leaf__": 1, "kind": "sharded", "shape": [4, 2], "dtype": "float32",
            "shards": {json.dumps([[0, 2], [0, 2]]): np.ones((2, 2), np.float32)}}
    for pi in (0, 1):
        payload = {"epoch": np.int64(0), "process_index": np.int64(pi), "process_count": np.int64(2),
                   "params": {"w": leaf}, "opt_state": {}, "extra": {}}
        with open(torn / f"shard{pi:05d}-of-00002.msgpack", "wb") as f:
            f.write(serialization.msgpack_serialize(payload))
    for reader in (jax_ckpt.load_checkpoint_sharded, flax_msgpack.load):
        with pytest.raises(ValueError, match="uncovered"):
            reader(str(torn))

    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"\x00\x01 not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch checkpoint"):
        read_checkpoint(str(junk))
    assert flax_msgpack.unpackb(bytes([0x93, 0x01, 0xA1, 0x61, 0xC0])) == [1, "a", None]
    with pytest.raises(ValueError, match="extra data"):
        flax_msgpack.unpackb(bytes([0x01, 0x02]))


@pytest.mark.parametrize("layout", ["unrolled", "scan", "sharded"])
def test_eval_on_a_mer_tpu_checkpoint_matches_its_logits(fusion, tmp_path, layout, capsys):
    """``build_model`` over a mer_tpu file: logits within 1e-4 of mer_tpu's;
    ``.test --checkpoint`` gives the metrics of the same weights in a .pth."""
    jax_model, params = fusion["scan" if layout == "scan" else "unrolled"]
    if layout == "sharded":
        path = _write_sharded(tmp_path / "shards", params)
    else:
        path = str(tmp_path / "m2fnet.ckpt")
        jax_ckpt.save_checkpoint(path, epoch=2, params=params)
    config = load_config(fusion["config"])
    x, a, mask = _fusion_inputs()
    want = np.asarray(jax_model.apply({"params": params}, x, a, mask, deterministic=True))
    model = build_model(config, CPU, checkpoint=path)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, a, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    argv = ["--synthetic", "--config", fusion["config"], "--device", "cpu", "--checkpoint"]
    metrics = eval_entry.main([*argv, path])
    pth = str(tmp_path / "m2fnet.pth")
    tools.export_torch(path, pth, fusion["config"])
    assert eval_entry.main([*argv, pth]) == metrics
    assert "Accuracy=[" in capsys.readouterr().out


# -- resume ---------------------------------------------------------------------------


def _jax_batches(n_dialogues, seed):
    data = JaxSyntheticFusionDataset(n_dialogues=n_dialogues, seed=seed, **DATA)
    batcher = JaxFusionBatcher(data, batch_size=BATCH, shuffle=True, seed=0, sort_by_length=True,
                               process_index=0, process_count=1)
    return [b for _ in range(2) for b in batcher]


@pytest.mark.parametrize("accum", [1, 2])
def test_fusion_resume_continues_mer_tpu_trajectory(fusion, tmp_path, accum):
    """mer_tpu takes 3 steps, writes its checkpoint (step, early-stop state,
    Adam moments; with accumulation 2 inside an open window), then 3 more.
    The port's solver restores from the file and takes the same 3 steps:
    losses within 1e-5 relative, weights within 2 lr per update."""
    path = _write_fusion_config(str(tmp_path / "tiny.yaml"), grad_accum_steps=accum)
    batches = _jax_batches(40, 0)[:6]
    jsolver = JaxSolver(fusion["unrolled"][0], jax_load_config(path))
    jstate = jsolver.init_state(batches[0], steps_per_epoch=5).replace(
        params=jax.tree.map(jnp.array, fusion["unrolled"][1]))
    rng = dropout_key(1)
    ckpt, jlosses = str(tmp_path / "mer_tpu.ckpt"), []
    for i, batch in enumerate(batches):
        jstate, loss = jsolver.train_epoch(jstate, [batch], rng)
        jlosses.append(loss)
        if i == 2:
            jax_ckpt.save_checkpoint(ckpt, epoch=0, params=jstate.params, opt_state=jstate.opt_state,
                                     extra={"step": int(jstate.step), "min_loss_val": 1.25, "patience_counter": 1})

    config = load_config(path)
    model = M2FNet.from_config(config.model)
    solver = Solver(model, config)
    state = solver.init_state(steps_per_epoch=5)
    assert solver.restore(state, ckpt) == (1, 1.25, 1)
    assert state.step == 3
    if accum == 2:
        assert all(p.grad is not None for p in model.parameters())  # the open window's gradients
    losses = [solver.train_epoch(state, [batch])[1] for batch in batches[3:]]
    np.testing.assert_allclose(losses, jlosses[3:], rtol=1e-5, atol=0)
    want = state_dict_from_jax(_np_tree(jstate.params), config.model)
    for name, value in model.state_dict().items():
        assert (value - want[name]).abs().max().item() <= 2 * LR * 3 + 1e-6, name

    jax_ckpt.save_checkpoint(ckpt, epoch=0, params=fusion["unrolled"][1])  # weights alone
    with pytest.raises(ValueError, match="no optimizer state"):
        solver.restore(solver.init_state(steps_per_epoch=5), ckpt)


@pytest.fixture(scope="module")
def mel_resume(meld_like_root_with_wavs, tmp_path_factory):
    """mer_tpu's mel solver on the tiny wav root: 3 steps, its checkpoint
    (Adam moments, batch stats, early-stop state), then 3 more steps' rows
    and losses."""
    root, _ = meld_like_root_with_wavs
    tmp = tmp_path_factory.mktemp("torch_tools_mel")
    with open(MEL_CONFIG_PATH) as f:
        raw = yaml.safe_load(f)
    raw["AUDIO"]["max_duration"] = 0.5
    raw["solver"]["len_triplet_picking"] = 16
    raw["DEBUG"].update(enabled=True, num_samples=16)
    for mode in ("train", "val", "test"):
        raw[mode]["data_loader"]["batch_size"] = BATCH
    ckpt = str(tmp / "ckpt" / "checkpoint.ckpt")
    raw["checkpoint"].update(save_path=ckpt, load_path=ckpt)
    path = str(tmp / "mel.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    jcfg = jax_load_config(path)
    jtrain, jval = (JaxMelFeatureDataset(mode, jcfg, data_root=root) for mode in ("train", "val"))
    jsolver = JaxMelSolver(JaxExtractor(), jcfg, jtrain, jval, seed=0)
    jstate = jsolver.init_state()
    mer_ckpt = str(tmp / "mer_tpu_mel.ckpt")
    rows, losses = [], []
    for step in range(6):
        if step == 3:
            jax_ckpt.save_checkpoint(mer_ckpt, epoch=0, params=jstate.params, opt_state=jstate.opt_state, extra={
                "min_loss_val": 2.5, "patience_counter": 1,
                "batch_stats": jax.tree.map(np.asarray, jsolver._batch_stats)})
        r = jsolver._miner(jtrain, jstate.params).mine_hard_rows_device(BATCH)
        rows.append(np.asarray(r))
        jstate, loss = jsolver._train_step(jstate, jtrain.spectrogram_batch(r))
        losses.append(float(loss))
    return {"root": root, "config": path, "ckpt": mer_ckpt, "rows": rows, "losses": losses,
            "caches": {"train": np.array(jtrain._device_cache), "val": np.array(jval._device_cache)},
            "params": _np_tree(jstate.params)}


def test_mel_resume_continues_mer_tpu_trajectory(mel_resume):
    """The port's mel solver, from other weights, restores mer_tpu's
    checkpoint (Adam moments, BatchNorm statistics, early-stop state; the
    micro-step from the Adam count) and takes mer_tpu's next 3 steps on the
    same rows: losses within 1e-5 relative."""
    config = load_config(mel_resume["config"])
    data = {m: MelFeatureDataset(m, config, data_root=mel_resume["root"], device=CPU) for m in ("train", "val")}
    for mode, ds in data.items():
        ds.device_cache = torch.from_numpy(mel_resume["caches"][mode])
    solver = MelSolver(AudioMelFeatureExtractor(), config, data["train"], data["val"], seed=0)
    state = solver.init_state()
    assert solver.restore(state, mel_resume["ckpt"]) == (1, 2.5, 1)
    assert state.step == 3
    first = next(iter(state.optimizer.state.values()))
    assert float(first["step"]) == 3 and first["exp_avg"].abs().max() > 0
    losses = [solver.train_step(state, data["train"].spectrogram_batch(torch.from_numpy(r.copy()))).item()
              for r in mel_resume["rows"][3:]]
    np.testing.assert_allclose(losses, mel_resume["losses"][3:], rtol=1e-5, atol=0)


# -- tools ----------------------------------------------------------------------------


def test_inspect_matches_mer_tpu(fusion, extractors, tmp_path):
    """The same dict for mer_tpu files (with and without Adam state); the
    same fields for the port's own checkpoint."""
    cfg = jax_load_config(fusion["config"])
    batches = _jax_batches(16, 0)[:1]
    jsolver = JaxSolver(fusion["unrolled"][0], cfg)
    jstate = jsolver.init_state(batches[0], steps_per_epoch=2)
    with_adam = str(tmp_path / "adam.ckpt")
    jax_ckpt.save_checkpoint(with_adam, epoch=3, params=jstate.params, opt_state=jstate.opt_state,
                             extra={"step": 0, "min_loss_val": float("inf"), "patience_counter": 0})
    mel = str(tmp_path / "mel.ckpt")
    jax_ckpt.save_checkpoint(mel, epoch=1, params=extractors["mel"][0],
                             extra={"min_loss_val": 0.25, "patience_counter": 3})
    for path in (with_adam, mel):
        want = jax_tools.inspect_checkpoint(path)
        got = tools.inspect_checkpoint(path)
        assert json.dumps(got, default=str, sort_keys=True) == json.dumps(want, default=str, sort_keys=True)

    port = str(tmp_path / "port.ckpt")
    model = M2FNet.from_config(load_config(fusion["config"]).model)
    torch.save({"epoch": 2, "model_state_dict": model.state_dict(),
                "optimizer_state_dict": {"state": {0: {"exp_avg": torch.zeros(3, 4)}}, "param_groups": []},
                "extra": {"step": 9, "min_loss_val": 0.5}}, port)
    info = tools.inspect_checkpoint(port)
    assert info["epoch"] == 2 and info["n_opt_state"] == 12 and info["extra"] == {"step": 9, "min_loss_val": 0.5}
    assert info["n_params"] == sum(v.numel() for v in model.state_dict().values())
    assert info["top_level"] == sorted({k.split(".")[0] for k in model.state_dict()})


@pytest.mark.parametrize("layout", ["unrolled", "scan", "port"])
def test_export_torch_matches_mer_tpu(fusion, tmp_path, layout, capsys):
    """The .pth export equals mer_tpu's export of the same file exactly
    (from the port's own checkpoint: its weights)."""
    params = fusion["scan" if layout == "scan" else "unrolled"][1]
    src = str(tmp_path / "src.ckpt")
    jax_ckpt.save_checkpoint(src, epoch=5, params=params)
    want_path, got_path = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    jax_tools.export_torch(src, want_path, fusion["config"])
    if layout == "port":
        port = str(tmp_path / "port.ckpt")
        torch.save({"epoch": 5, "model_state_dict": torch.load(want_path)["model_state_dict"],
                    "optimizer_state_dict": {}, "extra": {}}, port)
        src = port
    assert tools.main(["export-torch", src, got_path, fusion["config"]]) == 0
    assert "torch model_state_dict layout" in capsys.readouterr().out
    want, got = torch.load(want_path), torch.load(got_path)
    assert got["epoch"] == want["epoch"] == 5 and set(got["model_state_dict"]) == set(want["model_state_dict"])
    for k, v in want["model_state_dict"].items():
        assert got["model_state_dict"][k].dtype == v.dtype
        torch.testing.assert_close(got["model_state_dict"][k], v, rtol=0, atol=0, msg=k)


def test_preflight_cases(tmp_path, capsys, monkeypatch):
    """``tests/test_utils.py``'s cases (missing assets; a synthetic root's
    CSVs and wavs), no card raising nothing, and exit 0 with everything
    present."""
    assert tools.preflight(str(tmp_path)) == 1
    out = capsys.readouterr().out
    assert "MISSING" in out and "MELD_download.sh" in out
    assert "[MISSING] card (torch.cuda.is_available() is false)" in out
    for name in ("logmel_fwd", "flash_attention_fwd", "w2v_conv_tail"):
        assert f"kernel {name} (" in out

    root = tmp_path / "meld"
    r = subprocess.run([sys.executable, "scripts/make_synthetic_meld.py", str(root), "--dialogues", "4"],
                       cwd=REPO_ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    tools.preflight(str(root))
    out = capsys.readouterr().out
    assert "[ok] train CSV" in out and "[ok] train wavs" in out

    # everything present: a card and nvcc reported, every library built,
    # local pretrained files and the stage-1 pickles
    from mer_tpu_torch.ops import _build

    monkeypatch.setattr(tools, "card_summary", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(tools, "_nvcc_path", lambda: "/usr/local/cuda/bin/nvcc")
    built = tmp_path / "built.so"
    built.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda name: str(built))
    monkeypatch.setattr(tools, "REPO_ROOT", str(tmp_path / "repo"))
    config = load_config(os.path.join(REPO_ROOT, "src", "config.yaml"))
    for key in ("text", "audio"):
        d = tmp_path / "repo" / str(config.embeddings[key])
        d.mkdir(parents=True)
        for split in ("train", "val", "test"):
            (d / f"{split}.pkl").write_bytes(b"")
    weights = tmp_path / "weights"
    weights.mkdir()
    (weights / "pytorch_model.bin").write_bytes(b"")
    assert tools.main(["preflight", str(root), "--pretrained-text", str(weights),
                       "--pretrained-wav2vec2", str(weights / "pytorch_model.bin")]) == 0
    out = capsys.readouterr().out
    assert "MISSING" not in out and "All assets present" in out and "[ok] card (NVIDIA H100" in out


def test_tools_subprocess_imports_nothing_it_must_not(fusion, tmp_path):
    """``python -m mer_tpu_torch.tools inspect`` on a mer_tpu file, then the
    reader, export and preflight in one process: no msgpack, flax, JAX,
    mer_tpu or huggingface_hub module is loaded."""
    path = str(tmp_path / "m.ckpt")
    jax_ckpt.save_checkpoint(path, epoch=6, params=fusion["unrolled"][1])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "mer_tpu_torch.tools", "inspect", path], cwd=REPO_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["epoch"] == 6
    code = ("import sys; from mer_tpu_torch import tools; "
            f"tools.export_torch({path!r}, {str(tmp_path / 'x.pth')!r}, {fusion['config']!r}); "
            f"tools.preflight({str(tmp_path)!r}); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'msgpack', 'mer_tpu', 'huggingface_hub', 'sklearn', 'matplotlib', 'plotly')); "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("MISSING") > 0
    assert tools.main([]) == 1


# -- the extractors' entry points ---------------------------------------------------


def test_text_test_entry_on_a_scanned_mer_tpu_checkpoint(extractors, meld_like_root, tmp_path, monkeypatch):
    """``.test`` reads test.model_path as a mer_tpu file (scan layout) and
    gives the metrics of the same weights in a torch file."""
    cfg = RobertaConfig(**TEXT_NARROW)
    monkeypatch.setattr(fe_common.RobertaConfig, "base", classmethod(lambda cls: cfg))
    with open(TEXT_CONFIG_PATH) as f:
        raw = yaml.safe_load(f)
    raw["test"]["model_path"] = str(tmp_path / "tuned.ckpt")
    raw["test"]["data_loader"]["batch_size"] = 6
    config = str(tmp_path / "text.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(raw, f)
    argv = ["--config", config, "--data-root", meld_like_root[0], "--random-init", "--toy-tokenizer", "--f32",
            "--device", "cpu"]
    jax_ckpt.save_checkpoint(raw["test"]["model_path"], epoch=1, params=extractors["text_scan"])
    got = text_test_entry.main(argv)
    torch.save({"epoch": 1, "model_state_dict": text_state_dict_from_jax(extractors["text_scan"])},
               raw["test"]["model_path"])
    assert text_test_entry.main(argv) == got


def test_w2v_embeddings_entry_on_a_mer_tpu_shard_directory(extractors, meld_like_root_with_wavs, tmp_path,
                                                          monkeypatch):
    """``.embeddings`` reads checkpoint.save_path as a mer_tpu shard
    directory and writes the tables of the same weights in a torch file."""
    cfg = Wav2Vec2Config(**W2V_NARROW)
    monkeypatch.setattr(fe_common.Wav2Vec2Config, "base", classmethod(lambda cls: cfg))
    with open(W2V_CONFIG_PATH) as f:
        raw = yaml.safe_load(f)
    raw["checkpoint"]["save_path"] = str(tmp_path / "shards")
    config = str(tmp_path / "w2v.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(raw, f)
    argv = ["--config", config, "--data-root", meld_like_root_with_wavs[0], "--random-init", "--f32",
            "--device", "cpu"]
    _write_sharded(tmp_path / "shards", extractors["wav2vec2_unrolled"])
    got = w2v_embeddings_entry.main(argv, save_dir=str(tmp_path / "emb"))
    raw["checkpoint"]["save_path"] = str(tmp_path / "w2v.pth")
    with open(config, "w") as f:
        yaml.safe_dump(raw, f)
    torch.save({"epoch": 1, "model_state_dict": audio_state_dict_from_jax(extractors["wav2vec2_unrolled"])},
               raw["checkpoint"]["save_path"])
    want = w2v_embeddings_entry.main(argv, save_dir=str(tmp_path / "emb2"))
    for mode in want:
        np.testing.assert_array_equal(got[mode], want[mode])


# -- the two configurations repaired or stated ---------------------------------------


@pytest.mark.parametrize("solver_kind, async_checkpoint", [("fusion", False), ("fusion", True), ("mel", False)])
def test_async_checkpoint_key(fusion, mel_resume, tmp_path, monkeypatch, solver_kind, async_checkpoint):
    """``tpu.async_checkpoint: false`` writes every checkpoint on the training
    thread before the epoch goes on (mer_tpu/train/solver.py:411-412), with no
    background writer at all: the file is whole when ``fit`` returns, with no
    ``wait()``. The default writes on a background thread."""
    import threading

    from mer_tpu_torch.data import DeviceFusionBatcher, SyntheticFusionDataset
    from mer_tpu_torch.train import checkpoint as ckpt_mod

    on_main = []
    write = ckpt_mod.write_checkpoint
    monkeypatch.setattr(ckpt_mod, "write_checkpoint", lambda path, payload: (
        on_main.append(threading.current_thread() is threading.main_thread()), write(path, payload))[1])
    if not async_checkpoint:
        def refuse(*args, **kwargs):
            raise AssertionError("no background writer under tpu.async_checkpoint: false")

        monkeypatch.setattr(ckpt_mod.AsyncCheckpointer, "__init__", refuse)
    if solver_kind == "fusion":
        path = _write_fusion_config(str(tmp_path / "tiny.yaml"), epochs=2)
        config = load_config(path).override(tpu__async_checkpoint=async_checkpoint, checkpoint__save_checkpoint=True)
        data = SyntheticFusionDataset(n_dialogues=16, seed=0, **DATA)
        batcher = lambda shuffle: DeviceFusionBatcher(data, batch_size=BATCH, shuffle=shuffle, seed=0, device=CPU)
        Solver(M2FNet.from_config(config.model), config).fit(batcher(True), batcher(False))
    else:
        config = load_config(mel_resume["config"]).override(
            tpu__async_checkpoint=False, solver__epochs=1, checkpoint__save_path=str(tmp_path / "mel.ckpt"))
        data = {m: MelFeatureDataset(m, config, data_root=mel_resume["root"], device=CPU) for m in ("train", "val")}
        for mode, ds in data.items():
            ds.device_cache = torch.from_numpy(mel_resume["caches"][mode])
        MelSolver(AudioMelFeatureExtractor(), config, data["train"], data["val"], seed=0).fit()
    assert on_main and all(on_main) != async_checkpoint
    saved = load_checkpoint(config.checkpoint.save_path)
    assert saved["epoch"] == int(config.solver.epochs) - 1 and saved["optimizer_state_dict"]["state"]


def test_bn_mode_train_on_a_dp_mesh_is_refused():
    """A standing difference (ROADMAP.md): mer_tpu never trains BatchNorm,
    while the port's ``bn_mode: train`` follows ``model.train()`` and on a dp
    mesh would see a rank's rows alone, so there it is refused; one process
    takes it."""
    from mer_tpu_torch.parallel.mesh import Mesh

    config = load_config(MEL_CONFIG_PATH)
    with pytest.raises(NotImplementedError, match="bn_mode 'train' on a dp mesh"):
        MelSolver(AudioMelFeatureExtractor(bn_mode="train"), config, None, None, mesh=Mesh(dp=2))
    assert MelSolver(AudioMelFeatureExtractor(bn_mode="train"), config, None, None).mesh.dp == 1
    assert MelSolver(AudioMelFeatureExtractor(), config, None, None, mesh=Mesh(dp=2)).mesh.dp == 2
