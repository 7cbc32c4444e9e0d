"""The port's pipeline parallelism (GPipe, ``--pp``) against the JAX package's, on the CPU.

Four gloo ranks, one spawn for the module (``tests/_torch_parallel_worker.py
pipeline``), beside ``mer_tpu``'s meshes on the virtual CPU devices of
``tests/conftest.py``:

- ``pipeline_apply`` over four dense layers at pp 4 and pp 2 x dp 2, M = pp
  and 2 pp, with and without a mask ``extra``: the outputs within 1e-5 of
  ``mer_tpu``'s ``pipeline_apply``, the layers' and the input's gradients
  within 1e-5 of the sequential stack's (each stage holds its own layers);
- ``text_erc_logits_pp`` and ``audio_erc_logits_pp`` at pp 2 x dp 2 on
  weights converted from ``mer_tpu``'s scanned models: within 1e-4 of
  ``mer_tpu``'s pipelined logits;
- dropout on: the logits at pp 4 and pp 2 equal one process's (pp 1, the
  same M = 4 and seed words) bit for bit, the gradients within 1e-6;
- three ``FESolver`` text steps at pp 2 x dp 2 (M = 2), with and without
  ``--remat dots``, against one process: losses within 1e-5, the gathered
  weights within 1e-5, the key biases excepted as elsewhere;
- ``mer_tpu``'s errors for a batch that does not divide into microbatches,
  layers that do not divide by pp and microbatch rows that do not divide dp,
  and its mesh sizing.
"""

import concurrent.futures
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mer_tpu.models import roberta as jax_roberta
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.parallel import pipeline as jax_pipeline
from mer_tpu.parallel import pp_forward as jax_pp
from mer_tpu_torch.models import audio_state_dict_from_jax, text_state_dict_from_jax
from mer_tpu_torch.parallel import mesh as port_mesh
from mer_tpu_torch.parallel.pipeline import pipeline_apply, stage_range

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, "tests", "_torch_parallel_worker.py")
TOL = 1e-5
B, S, D, L = 8, 4, 8, 4


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _worker():
    spec = importlib.util.spec_from_file_location("_torch_parallel_worker", WORKER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_models(w):
    off = {"hidden_dropout": 0.0, "attention_dropout": 0.0}
    text_cfg = jax_roberta.RobertaConfig(**{**w.PP_TEXT, **off})
    audio_cfg = jax_w2v.Wav2Vec2Config(**{**w.PP_W2V, **off})
    return (jax_roberta.TextERC(text_cfg, scan_layers=True), text_cfg), (jax_w2v.AudioERC(audio_cfg, scan_layers=True),
                                                                        audio_cfg)


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Spawn the four ranks once; meanwhile run ``mer_tpu``'s side."""
    w = _worker()
    workdir = str(tmp_path_factory.mktemp("pipeline"))
    rng = np.random.default_rng(0)
    stack = {"w": (rng.normal(size=(L, D, D)) / np.sqrt(D)).astype(np.float32),
             "b": (0.1 * rng.normal(size=(L, D))).astype(np.float32)}
    x, g = rng.normal(size=(B, S, D)).astype(np.float32), rng.normal(size=(B, S, D)).astype(np.float32)
    xmask = rng.random((B, S)) < 0.3
    mask = (np.arange(16)[None, :] < rng.integers(4, 17, (B, 1))).astype(np.int32)
    ids = (rng.integers(3, 100, (B, 16)) * mask + (1 - mask)).astype(np.int32)
    ids[:, 0] = 0
    waves = rng.normal(size=(B, 3200)).astype(np.float32)
    lengths = rng.integers(1500, 3201, B).astype(np.int32)
    (text, _), (audio, _) = _jax_models(w)
    perturb = lambda p: jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), p)
    jtext = perturb(jax.jit(text.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"])
    jaudio = perturb(jax.jit(audio.init)(jax.random.PRNGKey(1), jnp.asarray(waves), jnp.asarray(lengths))["params"])
    np.savez(os.path.join(workdir, "pipe_inputs.npz"), x=x, g=g, xmask=xmask, ids=ids, mask=mask, waves=waves,
             lengths=lengths, logit_g=rng.normal(size=(B, 7)).astype(np.float32), **stack,
             **{f"text.{k}": v.numpy() for k, v in text_state_dict_from_jax(jtext).items()},
             **{f"audio.{k}": v.numpy() for k, v in audio_state_dict_from_jax(jaudio).items()})
    port, env = _free_port(), {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, WORKER, "pipeline", str(r), "4", str(port), workdir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]

    def jax_pipe(case):
        pp, dp, m, masked = case
        mesh = jax_pipeline.make_pp_mesh(pp, dp, devices=jax.devices()[:pp * dp])
        fn = (lambda p, h, e: jnp.where(e[..., None], h, jnp.tanh(h @ p["w"] + p["b"]))) if masked else \
            (lambda p, h: jnp.tanh(h @ p["w"] + p["b"]))
        out = jax_pipeline.pipeline_apply(stack, jnp.asarray(x), fn, mesh, microbatches=m,
                                          extra=jnp.asarray(xmask) if masked else None,
                                          batch_axis="dp" if dp > 1 else None)
        return np.asarray(out)

    def jax_logits(kind):
        (tm, tc), (am, ac) = _jax_models(w)
        mesh = jax_pipeline.make_pp_mesh(2, 2, devices=jax.devices()[:4])
        if kind == "text":
            fn = lambda p: jax_pp.text_erc_logits_pp(p, tc, mesh, jnp.asarray(ids), jnp.asarray(mask), microbatches=2)
            return np.asarray(jax.jit(fn)(jtext))
        fn = lambda p: jax_pp.audio_erc_logits_pp(p, ac, mesh, jnp.asarray(waves), jnp.asarray(lengths),
                                                  microbatches=2)
        return np.asarray(jax.jit(fn)(jaudio))

    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:  # XLA compiles outside the GIL
            pipes = dict(zip(w.PIPE_CASES, pool.map(jax_pipe, w.PIPE_CASES)))
            logits = dict(zip(("text", "audio"), pool.map(jax_logits, ("text", "audio"))))
        outputs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return {"workdir": workdir, "w": w, "stack": stack, "x": x, "g": g, "xmask": xmask, "pipes": pipes,
            "logits": logits, "inputs": np.load(os.path.join(workdir, "pipe_inputs.npz"))}


def _rank_files(workdir, name, world=4):
    return [np.load(os.path.join(workdir, f"{name}_r{r}.npz")) for r in range(world)]


def _sequential(run, masked):
    """Output and gradients of the four layers in one process, the whole batch."""
    layers = run["w"].dense_stack(run["stack"])
    x = torch.from_numpy(run["x"]).requires_grad_()
    h = x
    for layer in layers:
        h = layer(h, torch.from_numpy(run["xmask"]) if masked else None)
    (h * torch.from_numpy(run["g"])).sum().backward()
    return h.detach().numpy(), x.grad.numpy(), {f"{n}{i}": getattr(layers[i], n).grad.numpy()
                                                for i in range(L) for n in ("w", "b")}


@pytest.mark.parametrize("case", [(pp, dp, m, masked) for pp, dp in ((4, 1), (2, 2)) for m in (pp, 2 * pp)
                                  for masked in (False, True)])
def test_pipeline_apply_matches_jax_and_the_sequential_stack(pp_runs, case):
    pp, dp, m, masked = case
    files = _rank_files(pp_runs["workdir"], f"pipe_pp{pp}_m{m}_{masked}")
    # rank = dp_rank * pp + pp_rank: every stage returns its dp rows' output
    out = np.concatenate([files[d * pp]["out"] for d in range(dp)])
    for d in range(dp):
        for s in range(pp):
            np.testing.assert_array_equal(files[d * pp + s]["out"], files[d * pp]["out"])
    np.testing.assert_allclose(out, pp_runs["pipes"][case], rtol=0, atol=TOL)
    want_out, want_dx, want_grads = _sequential(pp_runs, masked)
    np.testing.assert_allclose(out, want_out, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.concatenate([files[d * pp]["dx"] for d in range(dp)]), want_dx, rtol=0, atol=TOL)
    seen = set()
    for name, want in want_grads.items():
        held = [f for f in files if name in f.files]
        assert len(held) == dp  # one stage of each dp replica holds the layer
        seen.add(name)
        np.testing.assert_allclose(sum(f[name] for f in held), want, rtol=0, atol=TOL, err_msg=name)
    assert len(seen) == 2 * L


@pytest.mark.parametrize("kind", ["text", "audio"])
def test_pipelined_logits_match_jax(pp_runs, kind):
    files = _rank_files(pp_runs["workdir"], f"logits_{kind}")
    got = np.concatenate([files[0]["logits"], files[2]["logits"]])  # the two dp replicas' rows
    np.testing.assert_array_equal(files[1]["logits"], files[0]["logits"])
    np.testing.assert_allclose(got, pp_runs["logits"][kind], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["text", "audio"])
def test_dropout_masks_do_not_depend_on_pp(pp_runs, kind):
    w = pp_runs["w"]
    torch.set_num_threads(1)
    one_logits, one_grads = w.dropout_step(kind, port_mesh.Mesh(), pp_runs["inputs"])
    for pp in (4, 2):
        files = [np.load(os.path.join(pp_runs["workdir"], f"dropout_{kind}_pp{pp}_r{r}.npz")) for r in range(pp)]
        for f in files:
            np.testing.assert_array_equal(f["logits"], one_logits.numpy())
        for name, want in one_grads.items():
            held = [f[f"g.{name}"] for f in files if f"g.{name}" in f.files]
            assert held, name
            np.testing.assert_allclose(held[0], want.numpy(), rtol=0, atol=1e-6, err_msg=f"pp {pp} {name}")
    # and the masks are on: the eval-mode logits differ
    model = w.pp_models(pp_runs["inputs"], dropout=True)[kind].eval()
    with torch.no_grad():
        plain = w.pp_logits(kind, model, port_mesh.Mesh(), pp_runs["inputs"], microbatches=4)
    assert (plain - one_logits).abs().max().item() > 1e-3


@pytest.mark.parametrize("remat", [False, True])
def test_fe_solver_pp2_dp2_steps_equal_one_process(pp_runs, remat):
    solver, batches = pp_runs["w"].pp_fe_setup(port_mesh.Mesh())
    assert solver.pp_logits_fn is None
    state = solver.init_state(3)
    _, loss = solver.train_epoch(state, batches, 0)
    z = np.load(os.path.join(pp_runs["workdir"], f"fe_pp2_dp2{'_remat' if remat else ''}.npz"))
    np.testing.assert_allclose(z["losses"], [loss], rtol=0, atol=TOL)
    got = {k[2:]: z[k] for k in z.files if k.startswith("p.")}
    want = {k: v.numpy() for k, v in solver.model.state_dict().items()}
    assert got.keys() == want.keys()
    for name, value in want.items():
        if not name.endswith("key.bias"):  # softmax ignores the key biases: Adam moves them by rounding noise
            np.testing.assert_allclose(got[name], value, rtol=0, atol=TOL, err_msg=f"remat={remat} {name}")


def test_errors_are_jax_messages():
    layers = torch.nn.ModuleList(torch.nn.Identity() for _ in range(6))
    x = torch.zeros(6, 2)
    cases = [(port_mesh.Mesh(pp=2), 4, x[:6], "batch 6 not divisible into 4 microbatches"),
             (port_mesh.Mesh(pp=4), 2, x[:6], "6 layers not divisible by pp=4"),
             (port_mesh.Mesh(pp=2, dp=2), 2, x[:3], "microbatch rows 6//2=3 not divisible by dp=2")]
    jmesh = {2: jax_pipeline.make_pp_mesh(2, 1, devices=jax.devices()[:2]),
             4: jax_pipeline.make_pp_mesh(4, 1, devices=jax.devices()[:4]),
             (2, 2): jax_pipeline.make_pp_mesh(2, 2, devices=jax.devices()[:4])}
    for (mesh, m, rows, message), key in zip(cases, (2, 4, (2, 2))):
        with pytest.raises(ValueError) as got:
            pipeline_apply(layers, rows, lambda layer, h: layer(h), mesh, microbatches=m)
        with pytest.raises(ValueError) as want:
            jax_pipeline.pipeline_apply({"w": jnp.zeros((6, 2))}, jnp.zeros((6, 2)), lambda p, h: h, jmesh[key],
                                        microbatches=m, batch_axis="dp" if key == (2, 2) else None)
        assert str(got.value) == str(want.value) == message
    assert list(stage_range(12, port_mesh.Mesh(pp=4, rank=2))) == [6, 7, 8]
    assert port_mesh.mesh_shape(-1, 1, 1, 8, pp=2) == (4, 1, 1)
    with pytest.raises(ValueError, match="mesh 3x1x1x4 needs 12 devices, have 8"):
        port_mesh.mesh_shape(3, 1, 1, 8, pp=4)
    for rank in range(8):
        m = port_mesh.Mesh(dp=4, pp=2, rank=rank)
        assert (m.dp_rank, m.pp_rank, m.tp_rank, m.sp_rank) == (rank // 2, rank % 2, 0, 0)
