"""The readers of the program's spans (``harness/spans.py`` and the six
``program_span`` metrics): a tiny traced fine-tune and label cell on the
CPU read the three ms metrics as finite numbers; a synthetic trace and
synthetic spans give the launch, idle and wait readers known answers; with
no spans every reader returns None."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spans
from benchmark.harness.cell import reader
from benchmark.tests.tiny_cells import cell, run

TRAIN = ("host_step_ms.train", "launches_per_step.train", "idle_between_steps.train")
LABEL = ("dispatch_ms.label", "launches_per_batch.label", "prefetch_wait_ms.label")
OFFSET_US = -5000.0  # trace_us = start_ns / 1000 + OFFSET_US


def event(name, start, end):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end))


def record(name, start_us, end_us, thread=1):
    """A span whose host event (if any) lies at [start_us, end_us] on the trace's clock."""
    return SimpleNamespace(name=name, thread=thread, start_ns=int((start_us - OFFSET_US) * 1000),
                           end_ns=int((end_us - OFFSET_US) * 1000), parent=None, attrs={})


def fake(monkeypatch, host_spans, other_spans, merged, launches):
    trace = SimpleNamespace(host=[event("mer." + n, s, e) for n, s, e in host_spans] + [event("aten::mm", 0, 1)],
                            _merged=merged, _launches=launches)
    records = [record(n, s, e) for n, s, e in host_spans] + [record(n, s, e, thread=2) for n, s, e in other_spans]
    monkeypatch.setattr(spans, "program_records", lambda: records)
    return {"trace": trace}


def test_train_readers_on_a_synthetic_trace(monkeypatch):
    layers = fake(monkeypatch, [("fe.step", 100, 200), ("fe.step", 300, 400), ("fe.forward", 110, 150)],
                  [("data.batch", 210, 290)],
                  merged=[(0, 120), (130, 180), (260, 300), (320, 500)],
                  launches=[(150, 1), (160, 2), (250, 3), (350, 4), (450, 5), (99, 6)])
    found = spans.of(layers)
    assert found.offset_us == pytest.approx(OFFSET_US) and len(found.pair_offsets_us) == 3
    assert reader("host_step_ms.train")(layers) == pytest.approx(0.1)
    assert reader("launches_per_step.train")(layers) == pytest.approx(3 / 2)  # 150, 160 and 350
    # gaps 120-130 (inside the first step), 180-260 (between steps), 300-320 (inside the second)
    assert reader("idle_between_steps.train")(layers) == pytest.approx(100 * 80 / 110)


def test_label_readers_on_a_synthetic_trace(monkeypatch):
    layers = fake(monkeypatch, [("stream.pass", 0, 1000), ("stream.pass", 1000, 2000), ("stream.batch", 100, 130),
                                ("stream.batch", 200, 210), ("stream.batch", 300, 360), ("stream.wait", 90, 100),
                                ("stream.wait", 180, 200)],
                  [("prefetch.h2d", 120, 180)], merged=[(0, 50)],
                  launches=[(105, 1), (129, 2), (131, 3), (205, 4), (360, 5)])
    assert reader("dispatch_ms.label")(layers) == pytest.approx(0.03)
    assert reader("launches_per_batch.label")(layers) == pytest.approx(4 / 3)
    assert reader("prefetch_wait_ms.label")(layers) == pytest.approx((0.01 + 0.02) / 2)
    # a span of another thread is placed by the same offset
    (h2d,) = spans.of(layers).intervals_us("prefetch.h2d")
    assert h2d == pytest.approx((120, 180))


@pytest.mark.parametrize("metric", TRAIN + LABEL)
def test_no_spans_no_reading(monkeypatch, metric):
    layers = fake(monkeypatch, [], [], merged=[(0, 10), (20, 30)], launches=[(5, 1)])
    assert reader(metric)(layers) is None
    assert reader(metric)({}) is None


@pytest.mark.parametrize("name, metrics", [("wav2vec2-base.finetune", TRAIN), ("mer-meld.label", LABEL)])
def test_tiny_traced_cells_read_the_ms_metrics(name, metrics):
    c = cell(name)
    record = run(c, trace=True, seconds=1.0)
    values = {m: reader(m)(record.layers) for m in metrics}
    for m in ("host_step_ms.train", "dispatch_ms.label", "prefetch_wait_ms.label"):
        if m in values:
            assert values[m] is not None and 0 <= values[m] < 1e5, (m, values)
    # the CPU launches no kernel: launch readers read 0, and the idle reader finds no device gap
    assert [values[m] for m in metrics if m.startswith("launches")] == [0.0]
    assert spans.of(record.layers).offset_us is not None
