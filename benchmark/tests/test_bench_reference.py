"""The plain references against the port, on the CPU in float32 at narrow
sizes, and their parameter layouts against the port's at the cells' own."""

import pytest
import torch

from benchmark.drivers import label
from benchmark.harness.cell import load_cell
from benchmark.harness.weights import seeded_weights
from benchmark.reference import m2fnet as ref_m2f
from benchmark.reference import roberta as ref_rob
from benchmark.reference import wav2vec2 as ref_w2v
from benchmark.tests.tiny_cells import cell, run


def port_models(cfg):
    return label.port_models(cfg, 5, "cpu", torch.float32)


@pytest.mark.parametrize("name", ["wav2vec2", "roberta", "m2fnet"])
def test_layouts_at_full_size(name):
    cfg = load_cell("mer-meld.label").config
    spec = {"wav2vec2": ref_w2v, "roberta": ref_rob, "m2fnet": ref_m2f}[name].param_spec(cfg[name])
    from mer_tpu_torch.core.config import Config
    from mer_tpu_torch.models import M2FNet
    from mer_tpu_torch.models.roberta import RobertaConfig, TextERC
    from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config

    with torch.device("meta"):
        model = {"wav2vec2": lambda: AudioERC(Wav2Vec2Config.base()), "roberta": lambda: TextERC(RobertaConfig.base()),
                 "m2fnet": lambda: M2FNet.from_config(Config(cfg["m2fnet"]))}[name]()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == dict(spec)
    n = sum(p.numel() for p in model.parameters())
    assert n == {"wav2vec2": 94_966_791, "roberta": 124_651_015, "m2fnet": 86_251_783}[name]


def test_references_match_the_port():
    c = cell("mer-meld.label")
    cfg = c.config
    text, audio, fusion = (m.eval() for m in port_models(cfg))
    split = label.Split(3, c.traffic, cfg["roberta"])
    batch = split.batches[-1]
    ids, mask = torch.from_numpy(batch["text"]), torch.from_numpy(batch["attention_mask"])
    wave = torch.from_numpy(batch["audio"]).float() / 32768.0
    lengths = torch.from_numpy(batch["lengths"])
    with torch.no_grad():
        w = label.reference_weights(cfg, "roberta", 5, "cpu")
        torch.testing.assert_close(ref_rob.cls_embedding(w, cfg["roberta"], ids, mask), text.embed(ids.long(), mask),
                                   rtol=1e-5, atol=1e-5)
        w = label.reference_weights(cfg, "wav2vec2", 5, "cpu")
        torch.testing.assert_close(ref_w2v.embed(w, cfg["wav2vec2"], wave, lengths), audio.embed(wave, lengths),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ref_w2v.logits(w, cfg["wav2vec2"], wave, lengths), audio(wave, lengths),
                                   rtol=1e-5, atol=1e-5)
        w = label.reference_weights(cfg, "m2fnet", 5, "cpu")
        g = torch.Generator().manual_seed(0)
        t, a = torch.randn(3, 5, 32, generator=g), torch.randn(3, 5, 32, generator=g)
        pad = torch.tensor([[False] * 5, [False] * 3 + [True] * 2, [False] + [True] * 4])
        got, want = fusion.float()(t, a, pad), ref_m2f.logits(w, cfg["m2fnet"], t, a, pad)
        torch.testing.assert_close(want[~pad], got[~pad], rtol=1e-5, atol=1e-5)


def test_weights_are_seeded():
    spec = [("a.weight", (4, 3)), ("a.bias", (4,)), ("n.weight", (4,))]
    x, y = seeded_weights(spec, 9, 0, "cpu"), seeded_weights(spec, 9, 0, "cpu")
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(x["a.weight"], seeded_weights(spec, 10, 0, "cpu")["a.weight"])
    assert abs(float(x["n.weight"].mean()) - 1.0) < 0.2


@pytest.mark.parametrize("name", ["wav2vec2-base.finetune", "mer-meld.label"])
def test_tiny_cell_is_correct(name):
    record = run(cell(name))
    assert record.checks and all(v <= lim for _, v, lim in record.checks), record.checks
    assert record.attempted > 0 and record.failed == 0


@pytest.mark.cuda
def test_dropout_masks_follow_the_program_on_the_card(monkeypatch):
    """On the card, in bf16, the reference draws each step's dropout masks as
    the port's ``F.dropout`` and attention kernels do: the narrow fine-tune
    cell reads far closer to the reference than with masks one step off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the masks are drawn by the card's generator and kernels")
    import time

    from benchmark.harness.cell import run_cell
    from benchmark.reference import dropout

    c = cell("wav2vec2-base.finetune", trace_seconds=1)
    c.config["fine_tune"]["compute_dtype"] = "bfloat16"
    read = lambda: dict((n, v) for n, v, _ in run_cell(c, 77, 0.5, False, "cuda", time.perf_counter()).checks)
    right = read()
    words = dropout.step_words
    monkeypatch.setattr(dropout, "step_words", lambda seed, step: words(seed, step + 1))
    wrong = read()
    assert right["loss_gap"] * 5 < wrong["loss_gap"] and right["grad_gap"] * 5 < wrong["grad_gap"], (right, wrong)
