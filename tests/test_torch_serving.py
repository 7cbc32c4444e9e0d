"""The port's serving slice end to end against the JAX package.

``python -m mer_tpu_torch.test`` on a narrow config (2 layers, d = 32) and a
checkpoint exported by the JAX package gives the same predictions and the
same batch-averaged metrics as the JAX forward over ``mer_tpu``'s batches,
with and without ``--serving-batch``. Every JAX top-2 logit margin exceeds
1e-3 (the seeded classifier output is scaled x100 to spread the random
logits), so no argmax can flip on float32 rounding. Also: the online server's
answers equal a direct forward, the port imports neither JAX nor
``mer_tpu``, and ``--device cuda`` without a card raises.
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

from mer_tpu.core import load_config as jax_load_config
from mer_tpu.data import FusionBatcher as JaxFusionBatcher
from mer_tpu.data import SyntheticFusionDataset as JaxSyntheticFusionDataset
from mer_tpu.models import M2FNet as JaxM2FNet
from mer_tpu.models.torch_export import save_reference_checkpoint as jax_save_reference_checkpoint
from mer_tpu.objectives.metrics import BatchAveragedMetrics as JaxBatchAveragedMetrics
from mer_tpu_torch import serve as serve_entry
from mer_tpu_torch import test as eval_entry
from mer_tpu_torch.core import load_config
from mer_tpu_torch.serving import BatchedPredictor, OnlineServer, recollate_batches, split_recollated
from mer_tpu_torch.serving.engine import build_model, host_predict_fn, predict_fn

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """Narrow config, a JAX-exported reference checkpoint of seeded JAX
    params, and the JAX package's predictions and metrics on the synthetic
    test split."""
    tmp = tmp_path_factory.mktemp("torch_serving")
    with open(os.path.join(REPO_ROOT, "src", "config.yaml")) as f:
        raw = yaml.safe_load(f)
    for block in ("AUDIO", "TEXT", "FAM"):
        raw["model"][block].update(embedding_size=D, n_head=4)
    raw["model"]["AUDIO"]["n_encoder_layers"] = raw["model"]["TEXT"]["n_encoder_layers"] = 2
    raw["model"]["FAM"]["n_layers"] = 2
    raw["model"]["CLASSIFIER"]["hidden_size"] = D
    raw["tpu"]["compute_dtype"] = "float32"
    config_path = str(tmp / "tiny.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(raw, f)

    jax_cfg = jax_load_config(config_path)
    model = JaxM2FNet.from_config(jax_cfg.model)
    x = jnp.zeros((1, 8, D))
    params = model.init(jax.random.PRNGKey(3), x, x, jnp.zeros((1, 8), bool))["params"]
    # spread the random logits (x100) so that top-2 margins clear 1e-3
    out = params["classifier_out"]
    params = {**params, "classifier_out": {"kernel": out["kernel"] * 100.0, "bias": out["bias"] * 100.0}}
    ckpt = str(tmp / "m2fnet.pth")
    jax_save_reference_checkpoint(ckpt, params, model)

    dataset = JaxSyntheticFusionDataset(n_dialogues=280, seed=2, d_text=D, d_audio=D)
    batches = list(JaxFusionBatcher(dataset, batch_size=32, shuffle=False, sort_by_length=False,
                                    buckets=tuple(jax_cfg.tpu.length_buckets),
                                    process_index=0, process_count=1))
    apply = jax.jit(lambda t, a, m: model.apply({"params": params}, t, a, m, deterministic=True))
    preds, metrics = [], JaxBatchAveragedMetrics()
    for b in batches:
        logits = np.asarray(apply(b["text"], b["audio"], b["padding_mask"]))
        valid = b["emotion"] != -1
        top2 = np.sort(logits[valid], axis=-1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]).min()
        assert margin > 1e-3, f"top-2 margin {margin}: an argmax could flip on rounding"
        preds.append(logits.argmax(-1))
        metrics.update(b["emotion"], preds[-1], mask=valid)
    return {"config": config_path, "ckpt": ckpt, "preds": preds, "metrics": metrics.summary(),
            "emotion": [b["emotion"] for b in batches]}


@pytest.mark.parametrize("serving_batch", [None, 512, 96])
def test_eval_entry_point_matches_jax(slice_setup, serving_batch, capsys):
    argv = ["--synthetic", "--config", slice_setup["config"], "--checkpoint", slice_setup["ckpt"],
            "--device", "cpu"]
    if serving_batch is not None:
        argv += ["--serving-batch", str(serving_batch)]
    assert eval_entry.main(argv) == slice_setup["metrics"]
    out = capsys.readouterr().out
    assert "Loaded 280 dialogues for testing" in out and "Accuracy=[" in out and "Weighted_F1=[" in out

    # the same predictions, batch by batch, through the pieces main() uses
    config = load_config(slice_setup["config"])
    batches = eval_entry.eval_batches(config, eval_entry.eval_dataset(config, synthetic=True))
    for b, emotion in zip(batches, slice_setup["emotion"]):
        np.testing.assert_array_equal(b["emotion"], emotion)
    feed = [{k: b[k] for k in ("text", "audio", "padding_mask")} for b in batches]
    predictor = BatchedPredictor(predict_fn(build_model(config, CPU, slice_setup["ckpt"])), CPU)
    if serving_batch is None:
        preds = predictor(feed)
    else:
        merged, plan = recollate_batches(feed, serving_batch)
        assert all(len(m["text"]) <= max(serving_batch, 32) for m in merged)
        preds = split_recollated(predictor(merged), plan)
    for got, want in zip(preds, slice_setup["preds"]):
        np.testing.assert_array_equal(got, want)


def test_online_server_matches_direct_forward(slice_setup):
    config = load_config(slice_setup["config"])
    model = build_model(config, CPU, slice_setup["ckpt"])
    reqs = serve_entry.request_stream(12, D)
    with OnlineServer(host_predict_fn(model, CPU), max_batch=8, max_wait_ms=50.0) as server:
        futures = [server.submit(t, a) for t, a in reqs]
        answers = [f.result(timeout=60) for f in futures]
    stats = server.stats.snapshot()
    assert stats["requests"] == 12 and stats["batches"] >= 2
    with torch.inference_mode():
        for (text, audio), got in zip(reqs, answers):
            mask = torch.zeros(1, len(text), dtype=torch.bool)
            want = model(torch.from_numpy(text)[None], torch.from_numpy(audio)[None], mask).argmax(-1)[0]
            np.testing.assert_array_equal(got, want.numpy())


def test_serve_entry_point_report(slice_setup, capsys):
    report = serve_entry.main(["--synthetic", "--config", slice_setup["config"], "--requests", "10",
                               "--max-batch", "4", "--device", "cpu"])
    assert report["requests"] == 10 and report["mode"] == "f32" and report["device"] == "cpu"
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("online serving: ")]
    assert len(line) == 1 and json.loads(line[0].split(": ", 1)[1]) == report


def test_port_imports_neither_jax_nor_mer_tpu():
    code = ("import sys, mer_tpu_torch, mer_tpu_torch.test, mer_tpu_torch.serve, mer_tpu_torch.train, "
            "mer_tpu_torch.train.pipeline, mer_tpu_torch.utils, mer_tpu_torch.objectives.classification, "
            "mer_tpu_torch.ops.logmel, mer_tpu_torch.ops.logmel_kernel, mer_tpu_torch.data.audio_io, "
            "mer_tpu_torch.data.synthetic, mer_tpu_torch.data.mel_fe, mer_tpu_torch.models.resnet, "
            "mer_tpu_torch.models.convert, mer_tpu_torch.mining.triplet, mer_tpu_torch.objectives.embedding, "
            "mer_tpu_torch.train.mel_solver, mer_tpu_torch.feature_extractors.audio_mel.train, "
            "mer_tpu_torch.feature_extractors.audio_mel.embeddings, mer_tpu_torch.core.artifacts, "
            "mer_tpu_torch.ops.w2v_conv, mer_tpu_torch.models.wav2vec2, mer_tpu_torch.data.wav2vec2_fe, "
            "mer_tpu_torch.train.fe_solver, mer_tpu_torch.feature_extractors.fe_common, "
            "mer_tpu_torch.feature_extractors.audio_wav2vec2.embeddings, "
            "mer_tpu_torch.feature_extractors.audio_wav2vec2.test, "
            "mer_tpu_torch.feature_extractors.audio_wav2vec2.train, mer_tpu_torch.models.roberta, "
            "mer_tpu_torch.data.text_fe, mer_tpu_torch.core.text, mer_tpu_torch.feature_extractors.text.train, "
            "mer_tpu_torch.feature_extractors.text.test, mer_tpu_torch.feature_extractors.text.embeddings, "
            "mer_tpu_torch.scripts.profile_w2v_conv, mer_tpu_torch.ops.mulaw, mer_tpu_torch.data.native_wavio, "
            "mer_tpu_torch.data.prefetch, mer_tpu_torch.pipelines.e2e, mer_tpu_torch.e2e_stream, "
            "mer_tpu_torch.serving.quant, mer_tpu_torch.serving.encoders, mer_tpu_torch.parallel, "
            "mer_tpu_torch.parallel.mesh, mer_tpu_torch.parallel.tensor, mer_tpu_torch.parallel.data, "
            "mer_tpu_torch.data.process_sharding, mer_tpu_torch.ops.ring_attention, "
            "mer_tpu_torch.scripts.parallel_check, mer_tpu_torch.scripts.probe_gn_designs, "
            "mer_tpu_torch.parallel.hop, mer_tpu_torch.parallel.pipeline, mer_tpu_torch.parallel.pp_forward, "
            "mer_tpu_torch.utils.remat, mer_tpu_torch.ops.augment, mer_tpu_torch.ops.resample, "
            "mer_tpu_torch.utils.profiling, mer_tpu_torch.scripts.bench_attention, mer_tpu_torch.tools, "
            "mer_tpu_torch.train.flax_msgpack, mer_tpu_torch.utils.viz, mer_tpu_torch.utils.logging, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mer_tpu', "
            "'msgpack', 'sklearn', 'matplotlib', 'plotly', 'huggingface_hub', 'wandb')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, check=True, timeout=120)


@pytest.mark.parametrize("entry", ["test", "serve"])
def test_device_cuda_without_a_card_raises(slice_setup, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--synthetic", "--config", slice_setup["config"]]
    if entry == "test":
        argv += ["--checkpoint", slice_setup["ckpt"]]
    main = eval_entry.main if entry == "test" else serve_entry.main
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
