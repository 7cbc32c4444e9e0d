"""The harness with the timed path broken underneath: each fault a cell can
have turns ``correct`` false. At the narrow CPU size of ``tiny_cells``,
with the cells' own limits; the look for a card is skipped."""

import time

import pytest
import torch

from benchmark.harness.cell import RunContext, load_cell
from benchmark.tests.tiny_cells import cell, run


def correct(record) -> bool:
    return all(v <= lim for _, v, lim in record.checks) and record.failed == 0


def test_unbroken_runs_are_correct():
    assert correct(run(cell("wav2vec2-base.finetune"))) and correct(run(cell("mer-meld.label")))


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert not correct(run(cell("wav2vec2-base.finetune")))


def test_half_of_the_batch_left_out(monkeypatch):
    from mer_tpu_torch.train.fe_solver import FESolver

    original = FESolver._labels

    def half(self, batch):
        labels = original(self, batch).clone()
        labels[len(labels) // 2:] = -1  # the mean over the rest
        return labels

    monkeypatch.setattr(FESolver, "_labels", half)
    assert not correct(run(cell("wav2vec2-base.finetune")))


def _altered_embedding(monkeypatch):
    from mer_tpu_torch.models.roberta import TextERC

    original = TextERC.embed

    def misrouted(self, ids, mask):
        out = original(self, ids, mask).clone()
        out[0] = out[1]
        return out

    monkeypatch.setattr(TextERC, "embed", misrouted)


def _altered_logits(monkeypatch):
    from mer_tpu_torch.models import M2FNet

    original = M2FNet.forward

    def misrouted(self, *args, **kwargs):
        out = original(self, *args, **kwargs).clone()
        out[0, 0] = out[0, 1]
        return out

    monkeypatch.setattr(M2FNet, "forward", misrouted)


@pytest.mark.parametrize("alter", [_altered_embedding, _altered_logits], ids=["embedding", "fusion_logits"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, alter):
    alter(monkeypatch)
    assert not correct(run(cell("mer-meld.label")))


def test_answers_that_never_come(monkeypatch):
    from mer_tpu_torch.pipelines.e2e import StreamingPipeline

    original = StreamingPipeline.predict_dialogues_from_tables
    monkeypatch.setattr(StreamingPipeline, "predict_dialogues_from_tables",
                        lambda self, t, a, dialogues: original(self, t, a, dialogues[:-1]))
    assert not correct(run(cell("mer-meld.label")))


def test_finetune_control_reads_above_the_program():
    """The float8 reference in the program's place (the control) reads
    far above the float32 program at this size, on three seeds; the faults
    fail a limit."""
    from benchmark import controls

    c = cell("wav2vec2-base.finetune")
    for seed in (1, 2, 3):
        readings = dict(controls.finetune_readings(RunContext(c, seed, 0.0, False, "cpu", time.perf_counter())))
        for name, lim in c.traffic["limits"].items():
            assert readings["program"][name] <= lim
            assert readings["control"][name] > 3 * readings["program"][name]
        for kind in ("control", "half_batch", "lr_high"):
            assert any(readings[kind][n] > lim for n, lim in c.traffic["limits"].items()), kind


@pytest.mark.cuda
def test_controls_fail_at_the_cells_size():
    """On the card, at the cells' own sizes: the controls and the planted
    faults come out not correct under the cells' limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the controls run at the cells' own size")
    from benchmark import controls

    for name, read in (("wav2vec2-base.finetune", controls.finetune_readings),
                       ("mer-meld.label", controls.label_readings)):
        c = load_cell(name)
        for kind, readings in read(RunContext(c, 7, 0.0, False, "cuda", time.perf_counter())):
            if kind != "program":
                assert any(readings[n] > lim for n, lim in c.traffic["limits"].items()), (name, kind, readings)
            else:
                assert all(readings[n] <= lim for n, lim in c.traffic["limits"].items()), (name, readings)
