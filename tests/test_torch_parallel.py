"""The port's parallelism against the JAX package's, on the CPU.

- the sharding rules as data: ``partition_spec_for`` and
  ``zero1_param_specs`` give ``mer_tpu``'s splits on the same M2FNet,
  RoBERTa and wav2vec2 trees (both encoder layouts); ``pad_batch_to_dp`` and
  the mesh sizing equal ``mer_tpu``'s; the port's ``state_dict`` slicing
  (``shard_params``) is ``mer_tpu``'s split of the same tree, converted;
- process sharding: ``resolve_process``, ``shard_batches`` and
  ``local_num_batches``, and the fusion, text and wav2vec2 batchers' slices
  with ``process_index`` / ``process_count``, equal ``mer_tpu``'s;
- fusion training on two gloo ranks (one spawn for the module,
  ``tests/_torch_parallel_worker.py``) at dp = 2, tp = 2 and dp = 2 with
  ZeRO-1, held against ``mer_tpu``'s step on meshes of its virtual devices
  with the same weights, batches and class weights: each step's global loss
  and the first step's gradients within 1e-5, the weights after 3 steps
  within 1e-5 (the key biases excepted: a softmax does not see them, their
  gradient is rounding noise that Adam scales up to the learning rate; the
  other tests of the port say the same). The batches pad unevenly: one dp
  rank's rows hold most of the labels, so the weighted cross-entropy's
  per-rank denominators differ, and DDP's average of per-rank means, planted
  as a fault, misses ``mer_tpu`` by far more than the limit;
- the text extractor's ``FESolver`` at tp = 2 (RoBERTa's classifier
  ``out_proj`` takes a slice of its replicated input) and at dp = 2 with
  ZeRO-1, and the mel extractor's ``MelSolver`` at dp = 2 with ZeRO-1 (a loss
  over the whole batch's embeddings), against the same steps in one process
  of the port: losses within 1e-5, weights within 1e-5 (key biases excepted);
- the weight rule of the card's checks (``parallel_check.weight_check``)
  passes those runs and fails a rank that never stepped and the DDP mean;
- ZeRO-1 keeps about half the optimizer bytes a rank, and its checkpoint,
  written after two steps, resumes in one process into the third step of
  the two-rank run; ``DevicePrefetcher(sharding=...)`` yields each rank's
  rows of ``mer_tpu``'s padded batch.
"""

import concurrent.futures
import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mer_tpu.core import load_config as jax_load_config
from mer_tpu.data import FusionBatcher as JaxFusionBatcher
from mer_tpu.data import SyntheticFusionDataset as JaxSyntheticFusionDataset
from mer_tpu.data import process_sharding as jax_process_sharding
from mer_tpu.data.text_fe import TextBatcher as JaxTextBatcher
from mer_tpu.data.text_fe import ToyWhitespaceTokenizer as JaxToyTokenizer
from mer_tpu.data.wav2vec2_fe import Wav2Vec2Batcher as JaxW2VBatcher
from mer_tpu.models import M2FNet as JaxM2FNet
from mer_tpu.models import roberta as jax_roberta
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.parallel import batch_sharding
from mer_tpu.parallel import make_mesh as jax_make_mesh
from mer_tpu.parallel import mesh as jax_mesh
from mer_tpu.train import Solver as JaxSolver
from mer_tpu_torch.core import load_config
from mer_tpu_torch.data import DeviceFusionBatcher, FusionBatcher, SyntheticFusionDataset, process_sharding
from mer_tpu_torch.data.text_fe import TextBatcher, ToyWhitespaceTokenizer
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher
from mer_tpu_torch.models import M2FNet, audio_state_dict_from_jax, state_dict_from_jax, text_state_dict_from_jax
from mer_tpu_torch.parallel import mesh
from mer_tpu_torch.scripts import parallel_check
from mer_tpu_torch.train import Solver, load_checkpoint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, "tests", "_torch_parallel_worker.py")
D, U, B = 32, 8, 8
LR = 1e-4
TOL = 1e-5
CLASS_WEIGHTS = np.array([0.5, 1.0, 2.0, 1.5, 3.0, 0.7, 1.2], np.float32)
LENGTHS = (8, 7, 8, 6, 1, 2, 1, 3)  # rows 0-3 (dp rank 0) hold most of the labels
TEXT = dict(vocab_size=100, hidden_size=D, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
W2V = dict(conv_dim=(32,) * 7, hidden_size=D, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_path(tmp, zero1=False):
    with open(os.path.join(REPO_ROOT, "src", "config.yaml")) as f:
        raw = yaml.safe_load(f)
    for block in ("AUDIO", "TEXT", "FAM"):
        raw["model"][block].update(embedding_size=D, n_head=2)
    raw["model"]["AUDIO"]["n_encoder_layers"] = raw["model"]["TEXT"]["n_encoder_layers"] = 1
    raw["model"]["FAM"]["n_layers"] = 1
    raw["model"]["CLASSIFIER"]["hidden_size"] = D
    raw["model"]["dropout"] = 0.0
    raw["tpu"].update(compute_dtype="float32", scan_layers=False, zero1=zero1, donate_state=False)
    raw["solver"].update(lr=LR)
    raw["checkpoint"].update(save_checkpoint=False)
    path = os.path.join(tmp, f"fusion{'_zero1' if zero1 else ''}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _flat(tree) -> dict:
    return {jax_mesh._path_str(path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _trees() -> dict:
    """Shape trees (``jax.eval_shape``: no init is run) of ``mer_tpu``'s
    M2FNet, TextERC and AudioERC, unrolled and scan-stacked."""
    block = load_config(os.path.join(REPO_ROOT, "src", "config.yaml")).model.override(
        TEXT__embedding_size=D, AUDIO__embedding_size=D, FAM__embedding_size=D, TEXT__n_head=4, AUDIO__n_head=4,
        FAM__n_head=4, TEXT__n_encoder_layers=2, AUDIO__n_encoder_layers=2, FAM__n_layers=1, CLASSIFIER__hidden_size=D)
    key, x, m = jax.random.PRNGKey(0), jnp.zeros((2, 4, D)), jnp.zeros((2, 4), bool)
    trees = {}
    for scan in (False, True):
        fusion = JaxM2FNet.from_config(block, scan_layers=scan)
        trees[f"fusion scan={scan}"] = (jax.eval_shape(fusion.init, key, x, x, m)["params"], block)
        text = jax_roberta.TextERC(jax_roberta.RobertaConfig(**TEXT), scan_layers=scan)
        trees[f"text scan={scan}"] = (jax.eval_shape(text.init, key, jnp.zeros((2, 8), jnp.int32),
                                                     jnp.ones((2, 8), jnp.int32))["params"], None)
        audio = jax_w2v.AudioERC(jax_w2v.Wav2Vec2Config(**W2V), scan_layers=scan)
        trees[f"audio scan={scan}"] = (jax.eval_shape(audio.init, key, jnp.zeros((2, 1600)),
                                                      jnp.full((2,), 1600))["params"], None)
    return trees


@pytest.fixture(scope="module")
def trees():
    return _trees()


# -- the rules as data -------------------------------------------------------------------


def test_partition_specs_equal_mer_tpu(trees):
    split = 0
    for name, (tree, _) in trees.items():
        for path in _flat(tree):
            want = tuple(jax_mesh.partition_spec_for(path))
            assert mesh.partition_spec_for(path) == want, (name, path)
            split += "tp" in want
    assert split >= 40  # q, k, v, the outputs and the feed-forwards of every tree


@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 2), (8, 1), (3, 1)])
def test_zero1_specs_equal_mer_tpu(trees, dp, tp):
    jmesh = jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    for name, (tree, _) in trees.items():
        want = {path: tuple(spec) for path, spec in _flat(jax_mesh.zero1_param_specs(tree, jmesh)).items()}
        shapes = {path: tuple(leaf.shape) for path, leaf in _flat(tree).items()}
        assert mesh.zero1_param_specs(shapes, dp) == want, name


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_pad_batch_to_dp_equals_mer_tpu(dp):
    rng = np.random.default_rng(dp)
    mask = rng.random((5, 6)) < 0.3
    mask[2] = True  # an all-padding row: key 0 becomes attendable
    batch = {"text": rng.normal(size=(5, 6, 3)).astype(np.float32), "emotion": rng.integers(-1, 7, (5, 6)),
             "padding_mask": mask}
    want = jax_mesh.pad_batch_to_dp({k: v.copy() for k, v in batch.items()}, dp)
    got = mesh.pad_batch_to_dp(batch, dp)
    as_torch = mesh.pad_batch_to_dp({k: torch.from_numpy(v) for k, v in batch.items()}, dp)
    for key in batch:
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(as_torch[key].numpy(), want[key])
    shards = [mesh.dp_row_shard(batch, dp, r) for r in range(dp)]
    for key in batch:
        np.testing.assert_array_equal(np.concatenate([s[key] for s in shards]), want[key])


def test_mesh_sizing_equals_mer_tpu():
    for dp, tp, sp in [(-1, 1, 1), (-1, 2, 1), (2, 2, 1), (-1, 2, 2), (1, 1, 4), (4, 1, 1)]:
        want = jax_make_mesh(dp=dp, tp=tp, sp=sp).shape
        assert dict(zip(("dp", "tp", "sp"), mesh.mesh_shape(dp, tp, sp, 8))) == {"sp": 1, **want}
    for dp, tp, sp in [(3, 3, 1), (16, 1, 1), (1, 4, 4)]:
        with pytest.raises(ValueError):
            jax_make_mesh(dp=dp, tp=tp, sp=sp)
        with pytest.raises(ValueError):
            mesh.mesh_shape(dp, tp, sp, 8)
    one = mesh.mesh_from_config(load_config(os.path.join(REPO_ROOT, "src", "config.yaml")))
    assert (one.dp, one.tp, one.sp, one.size) == (1, 1, 1, 1)  # one process: the config's dp = -1 takes it
    with pytest.raises(ValueError, match="needs 2 devices"):
        mesh.mesh_from_config(load_config(os.path.join(REPO_ROOT, "src", "config.yaml")).override(tpu__mesh__tp=2))


def _tp_part(path: str, x: np.ndarray, rank: int, tp: int) -> np.ndarray:
    spec = jax_mesh.partition_spec_for(path)
    for axis, name in enumerate(spec):
        if name == "tp":
            return np.split(x, tp, axis)[rank]
    return x


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_is_mer_tpus_split_converted(trees, tp):
    """The port's tp slice of a ``state_dict`` equals the ``state_dict`` of
    ``mer_tpu``'s tp slice of the same tree: the same weights on each rank."""
    rng = np.random.default_rng(tp)
    for name, (tree, block) in trees.items():
        values = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), tree)
        convert = (lambda t: state_dict_from_jax(t, block)) if name.startswith("fusion") else \
            text_state_dict_from_jax if name.startswith("text") else audio_state_dict_from_jax
        whole = convert(values)
        for rank in range(tp):
            part = jax.tree_util.tree_map_with_path(
                lambda path, x: _tp_part(jax_mesh._path_str(path), x, rank, tp), values)
            want = convert(part)
            got = mesh.shard_params(whole, mesh.Mesh(tp=tp, rank=rank))
            assert got.keys() == want.keys()
            for key in want:
                torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=lambda m: f"{name} {key}: {m}")


# -- process sharding ----------------------------------------------------------------------


@pytest.mark.parametrize("index,count", [(0, 1), (0, 3), (2, 3), (1, 2)])
def test_process_sharding_equals_mer_tpu(index, count):
    assert process_sharding.resolve_process(index, count) == jax_process_sharding.resolve_process(index, count)
    for n in (0, 1, 5, 7):
        assert process_sharding.shard_batches(list(range(n)), index, count) == \
            jax_process_sharding.shard_batches(list(range(n)), index, count)
        assert process_sharding.local_num_batches(n, index, count) == \
            jax_process_sharding.local_num_batches(n, index, count)


def test_resolve_process_without_a_group_and_bad_values():
    assert process_sharding.resolve_process(None, None) == (0, 1) == jax_process_sharding.resolve_process(None, None)
    for bad in ((3, 3), (-1, 2), (0, 0)):
        with pytest.raises(ValueError):
            process_sharding.resolve_process(*bad)
        with pytest.raises(ValueError):
            jax_process_sharding.resolve_process(*bad)


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (2, 3)])
def test_fusion_batchers_process_slices_equal_mer_tpu(index, count):
    data = dict(n_dialogues=21, d_text=D, d_audio=D, seed=4)
    ours, theirs = SyntheticFusionDataset(**data), JaxSyntheticFusionDataset(**data)
    kw = dict(batch_size=4, shuffle=True, seed=3, process_index=index, process_count=count)
    want = list(JaxFusionBatcher(theirs, **kw))
    for batcher in (FusionBatcher(ours, **kw), DeviceFusionBatcher(ours, device="cpu", **kw)):
        got = list(batcher)
        assert len(got) == len(want) == len(batcher)
        for g, w in zip(got, want):
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))


class _Texts:
    """The attributes both packages' ``TextBatcher`` read."""

    def __init__(self, tokenizer, n=11):
        rng = np.random.default_rng(5)
        self.tokenizer = tokenizer
        self.texts = [" ".join(f"w{int(i)}" for i in rng.integers(0, 50, int(m))) for m in rng.integers(1, 30, n)]
        self.labels = rng.integers(0, 7, n)

    def __len__(self):
        return len(self.texts)


class _Waves:
    """The attributes both packages' ``Wav2Vec2Batcher`` read."""

    sample_rate = 16000

    def __init__(self, n=11):
        rng = np.random.default_rng(6)
        self._waves = [rng.uniform(-0.5, 0.5, int(m)).astype(np.float32) for m in rng.integers(800, 40000, n)]
        self.labels = rng.integers(0, 7, n)

    def __len__(self):
        return len(self._waves)

    def waveform(self, i):
        return self._waves[i]

    def waveform_lengths(self):
        return np.array([len(w) for w in self._waves])


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (1, 3)])
def test_text_and_wav2vec2_batchers_process_slices_equal_mer_tpu(index, count):
    kw = dict(batch_size=4, shuffle=True, seed=2, process_index=index, process_count=count)
    for ours, theirs in ((TextBatcher(_Texts(ToyWhitespaceTokenizer()), **kw),
                          JaxTextBatcher(_Texts(JaxToyTokenizer()), **kw)),
                         (Wav2Vec2Batcher(_Waves(), seconds_buckets=(1.0, 3.0), **kw),
                          JaxW2VBatcher(_Waves(), seconds_buckets=(1.0, 3.0), **kw))):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) == len(theirs)
        for g, w in zip(got, want):
            assert g.keys() <= w.keys()
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])


# -- two gloo ranks against mer_tpu's mesh ----------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batches(n=3):
    """Global batches [B, U, D] whose first half of rows holds most labels."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        emotion = np.full((B, U), -1, np.int32)
        for row, length in enumerate(LENGTHS):
            emotion[row, :length] = rng.integers(0, 7, length)
        mask = emotion == -1
        out.append({"text": rng.normal(size=(B, U, D)).astype(np.float32),
                    "audio": rng.normal(size=(B, U, D)).astype(np.float32), "padding_mask": mask,
                    "emotion": emotion})
    return out


def _softmax_blind(name: str) -> bool:
    return name.endswith("in_proj_bias")  # its middle third, the key biases (the q and v thirds are held)


def _key_bias(name: str) -> bool:
    return name.endswith(("key.bias", "k_proj.bias"))  # RoBERTa's and wav2vec2's key biases


def _assert_weights_close(got: dict, want: dict, what: str):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = np.asarray(got[name])
        if _key_bias(name):
            continue
        if _softmax_blind(name):
            d = w.shape[0] // 3
            g, w = np.concatenate([g[:d], g[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def fusion_runs(tmp_path_factory):
    """Spawn the two ranks once; meanwhile run ``mer_tpu``'s steps on its meshes."""
    workdir = str(tmp_path_factory.mktemp("fusion_mesh"))
    batches = _batches()
    jcfg = jax_load_config(_config_path(workdir))
    model = JaxM2FNet.from_config(jcfg.model)
    state0 = JaxSolver(model, jcfg, class_weights=CLASS_WEIGHTS).init_state(batches[0], steps_per_epoch=3)
    params0 = jax.tree.map(np.array, state0.params)
    weights = state_dict_from_jax(params0, jcfg.model)
    np.savez(os.path.join(workdir, "fusion_inputs.npz"), class_weights=CLASS_WEIGHTS,
             **{f"w.{k}": v.numpy() for k, v in weights.items()},
             **{f"b{i}.{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    port, env = _free_port(), {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, WORKER, "fusion", str(r), "2", str(port), workdir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]

    configs = {zero1: jax_load_config(_config_path(workdir, zero1)) for zero1 in (False, True)}

    def mesh_steps(dp, tp, zero1):
        jmesh = jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
        solver = JaxSolver(model, configs[zero1], mesh=jmesh, class_weights=CLASS_WEIGHTS)
        state = solver.init_state(batches[0], steps_per_epoch=3)
        solver._build_steps()
        losses = []
        for b in batches:
            state, loss = solver._train_step(state, jax.device_put(b, batch_sharding(jmesh)), jax.random.PRNGKey(0))
            losses.append(float(loss))
        return {"losses": np.array(losses),
                "params": state_dict_from_jax(jax.tree.map(np.array, state.params), jcfg.model)}

    meshes = {"dp2": (2, 1, False), "tp2": (1, 2, False), "dp2_zero1": (2, 1, True)}
    with concurrent.futures.ThreadPoolExecutor(len(meshes)) as pool:  # XLA compiles outside the GIL
        want = dict(zip(meshes, pool.map(lambda args: mesh_steps(*args), meshes.values())))
    loss_fn = JaxSolver(model, jcfg, class_weights=CLASS_WEIGHTS).loss_fn
    b0 = batches[0]
    grads = jax.jit(jax.grad(lambda p: loss_fn(model.apply({"params": p}, b0["text"], b0["audio"], b0["padding_mask"],
                                                           deterministic=True), b0["emotion"])))(state0.params)
    want["grads"] = state_dict_from_jax(jax.tree.map(np.array, grads), jcfg.model)

    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    got = {}
    for case in ("fe_tp2", "fe_dp2_zero1", "mel_dp2_zero1"):
        z = np.load(os.path.join(workdir, f"{case}.npz"))
        got[case] = {"losses": z["losses"], "params": {k[2:]: z[k] for k in z.files if k.startswith("p.")}}
    for case in ("dp2", "tp2", "dp2_zero1", "dp2_mean"):
        z = np.load(os.path.join(workdir, f"fusion_{case}.npz"))
        got[case] = {"losses": z["losses"], "moment_bytes": z["moment_bytes"],
                     "params": {k[2:]: z[k] for k in z.files if k.startswith("p.")},
                     "grads": {k[2:]: z[k] for k in z.files if k.startswith("g.")}}
    return {"got": got, "want": want, "workdir": workdir, "batches": batches}


@pytest.mark.parametrize("case", ["dp2", "tp2", "dp2_zero1"])
def test_two_rank_steps_equal_mer_tpu_mesh(fusion_runs, case):
    got, want = fusion_runs["got"][case], fusion_runs["want"][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=TOL)
    _assert_weights_close(got["params"], {k: v.numpy() for k, v in want["params"].items()}, case)
    if got["grads"]:  # the first step's gradients, summed over dp (or gathered over tp)
        _assert_weights_close(got["grads"], {k: v.numpy() for k, v in fusion_runs["want"]["grads"].items()}, case)


def _worker_module():
    spec = importlib.util.spec_from_file_location("_torch_parallel_worker", WORKER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", ["fe_tp2", "fe_dp2_zero1"])
def test_text_extractor_steps_equal_one_process(fusion_runs, case):
    solver, batches = _worker_module().fe_setup(mesh.Mesh())
    state = solver.init_state(3)
    _, loss = solver.train_epoch(state, batches, 0)
    got = fusion_runs["got"][case]
    np.testing.assert_allclose(got["losses"], [loss], rtol=0, atol=TOL)
    _assert_weights_close(got["params"], {k: v.numpy() for k, v in solver.model.state_dict().items()}, case)


def test_mel_extractor_steps_equal_one_process(fusion_runs):
    solver, batches = _worker_module().mel_setup(mesh.Mesh())
    state = solver.init_state()
    losses = [solver.train_step(state, b).item() for b in batches]
    got = fusion_runs["got"]["mel_dp2_zero1"]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=TOL)
    want = {k: v.numpy() for k, v in solver.model.state_dict().items()}
    # Adam's rounding-noise rule (the key biases' above): a weight whose gradient is near 0 moves by up to the
    # learning rate either way, so a few of 11 M part by more than TOL; none by more than 2 x lr x steps
    lr = float(solver.config.solver.lr)
    diffs = np.concatenate([np.abs(np.asarray(got["params"][k], np.float64) - w).ravel() for k, w in want.items()])
    assert diffs.max() <= 2 * lr * len(batches) and (diffs > TOL).mean() <= 1e-5, (diffs.max(), (diffs > TOL).sum())


def test_ddp_mean_of_rank_means_misses_mer_tpu(fusion_runs):
    """The planted fault (each rank its own mean, gradients averaged) breaks
    the limit the real step keeps: the ranks' denominators differ."""
    got, want = fusion_runs["got"]["dp2_mean"], fusion_runs["want"]["dp2"]
    misses = {n: np.abs(g - fusion_runs["want"]["grads"][n].numpy()).max() for n, g in got["grads"].items()}
    assert max(misses.values()) > 100 * TOL
    assert np.abs(got["losses"][1:] - want["losses"][1:]).max() > TOL


def _port_tensors(tree: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("case", ["dp2", "tp2", "dp2_zero1"])
def test_card_weight_rule_passes_the_two_rank_steps(fusion_runs, case):
    """``parallel_check.weight_check`` (the rule the card's phase 6m and the
    four-card check hold the weights to) on the two-rank runs against
    ``mer_tpu``'s mesh steps."""
    want = fusion_runs["want"]
    held = parallel_check.weight_check(_port_tensors(fusion_runs["got"][case]["params"]), want[case]["params"],
                                       parallel_check.STRAY_SHARE[torch.float32], TOL)
    assert held["excess"] <= 0, held


@pytest.mark.parametrize("fault", ["no_step", "ddp_mean"])
def test_card_weight_rule_fails_planted_faults(fusion_runs, fault):
    """The same rule on a rank that never stepped (the weights it started
    from) and on DDP's mean of rank means (a wrong gradient): both far
    beyond it, even at the bf16 allowance."""
    want = fusion_runs["want"]
    if fault == "no_step":
        start = np.load(os.path.join(fusion_runs["workdir"], "fusion_inputs.npz"))
        got = {k[2:]: start[k] for k in start.files if k.startswith("w.")}
    else:
        got = fusion_runs["got"]["dp2_mean"]["params"]
    held = parallel_check.weight_check(_port_tensors(got), want["dp2"]["params"],
                                       parallel_check.STRAY_SHARE[torch.bfloat16], TOL)
    assert held["beyond_tol"] > 0.1 * held["held"], held  # ten times the looser (bf16) allowance, at least


def test_zero1_keeps_half_the_optimizer_bytes(fusion_runs):
    plain, sharded = fusion_runs["got"]["dp2"]["moment_bytes"], fusion_runs["got"]["dp2_zero1"]["moment_bytes"]
    assert plain[0] == plain[1]
    assert 0.5 <= sharded.max() / plain[0] <= 0.52  # a [7] bias divides no dp axis: kept whole


def test_zero1_checkpoint_resumes_in_one_process(fusion_runs):
    """Two ZeRO-1 steps on two ranks, the checkpoint (moments gathered), then
    the third step in one process: the two-rank run's third step."""
    workdir = fusion_runs["workdir"]
    ckpt = load_checkpoint(os.path.join(workdir, "zero1_step2.pth"))
    config = load_config(_config_path(workdir, zero1=True))
    model = M2FNet.from_config(config.model)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    solver = Solver(model, config, class_weights=CLASS_WEIGHTS)
    state = solver.init_state(steps_per_epoch=3)
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt["extra"]["step"])
    assert state.step == 2 and set(ckpt["optimizer_state_dict"]["state"]) == set(range(len(list(model.parameters()))))
    state, loss = solver.train_epoch(state, [fusion_runs["batches"][2]])
    np.testing.assert_allclose(loss, fusion_runs["got"]["dp2_zero1"]["losses"][2], rtol=0, atol=TOL)
    _assert_weights_close({k: v.numpy() for k, v in model.state_dict().items()},
                          fusion_runs["got"]["dp2_zero1"]["params"], "resumed")


def test_prefetcher_shards_equal_mer_tpu_padded_rows(fusion_runs):
    batch = {k: v[:7] for k, v in fusion_runs["batches"][0].items()}  # 7 rows: padded to 8 over dp = 2
    want = jax_mesh.pad_batch_to_dp({k: v.copy() for k, v in batch.items()}, 2)
    for rank in range(2):
        z = np.load(os.path.join(fusion_runs["workdir"], f"prefetch_{rank}.npz"))
        for key in batch:
            np.testing.assert_array_equal(z[key], want[key][4 * rank:4 * (rank + 1)])
