"""The port's host spans (``mer_tpu_torch/utils/tracing.py``) on the CPU.

- Off (no ``torch.profiler`` capture): a span times its body and nothing
  else; no ``record_function`` is entered and nothing is recorded.
- Under a capture: nested spans' parents, attrs and threads; a second
  thread's spans in the list; the list cleared by the next capture and
  bounded; the main thread's spans placed on the profiler's clock within
  50 microseconds of their host events.
- ``utils.profiling.trace`` writes the prefetch thread's spans into its
  Chrome trace on that thread's ``tid``, and ``e2e_stream --trace-dir``
  writes such a trace.
- The stream's ``stages`` keep their keys and bytes, read from the spans;
  ``FESolver.train_epoch`` and ``Wav2Vec2Batcher`` record a ``fe.step``
  span per batch with its five children and a ``data.batch`` span per batch.
"""

import glob
import json
import statistics
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mer_tpu_torch.core import CONFIG_PATH, load_config
from mer_tpu_torch.core.config import Config
from mer_tpu_torch.data.prefetch import DevicePrefetcher
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, w2v_batch_to_inputs
from mer_tpu_torch.models import M2FNet, init_random_
from mer_tpu_torch.models.roberta import RobertaConfig, text_erc_from_seed
from mer_tpu_torch.models.wav2vec2 import Wav2Vec2Config, audio_erc_from_seed
from mer_tpu_torch.pipelines import E2EModels, StreamingPipeline
from mer_tpu_torch.train.fe_solver import FESolver
from mer_tpu_torch.utils import profiling, tracing
from mer_tpu_torch.utils.tracing import span

D = 32
TEXT = dict(vocab_size=300, hidden_size=D, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=80)
W2V = dict(conv_dim=(16,) * 7, hidden_size=D, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def capture():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_times_the_body_and_records_nothing(monkeypatch):
    tracing.reset()
    monkeypatch.setattr(tracing, "record_function", lambda name: pytest.fail(f"record_function({name!r}) entered"))
    with span("outer", batch=1) as outer:
        with span("inner") as inner:
            time.sleep(0.002)
        inner.note(rows=4)
    assert outer.seconds >= inner.seconds >= 0.002
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert tracing.spans() == []


def test_nested_spans_under_a_capture():
    with capture() as prof:
        with span("step", step=3) as step:
            with span("forward"):
                torch.ones(4).sum()
            with span("backward"):
                pass
            step.note(rows=16, width=32000)
        with span("step", step=4):
            pass
    records = tracing.spans()
    assert [r.name for r in records] == ["step", "forward", "backward", "step"]
    assert [r.parent for r in records] == [None, 0, 0, None]
    assert records[0].attrs == {"step": 3, "rows": 16, "width": 32000} and records[3].attrs == {"step": 4}
    assert {r.thread for r in records} == {threading.get_native_id()}
    assert {r.thread_name for r in records} == {threading.current_thread().name}
    for r in records:
        assert r.end_ns >= r.start_ns
    assert records[0].start_ns <= records[1].start_ns <= records[2].end_ns <= records[0].end_ns
    names = [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert sorted(names) == ["mer.backward", "mer.forward", "mer.step", "mer.step"]


def test_second_thread_spans_are_listed():
    seen = {}

    def worker():
        seen["tid"] = threading.get_native_id()
        with span("host", batch=0):
            with span("h2d", bytes=128):
                pass

    with capture():
        with span("main"):
            thread = threading.Thread(target=worker, name="producer")
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    records = by_name(tracing.spans())
    (main,), (host,), (h2d,) = records["main"], records["host"], records["h2d"]
    assert host.thread == h2d.thread == seen["tid"] != main.thread and host.thread_name == "producer"
    assert host.parent is None  # the main thread's open span is no parent of another thread's
    assert tracing.spans()[h2d.parent] is host and h2d.attrs == {"bytes": 128}


def test_next_capture_clears_the_list_and_the_list_is_bounded(monkeypatch):
    with capture():
        with span("first"):
            pass
    with span("between"):  # no capture: the next recorded span starts a new list
        pass
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with capture() as prof:
        with span("a"):
            with span("b"):
                for _ in range(3):
                    with span("c"):
                        pass
    assert [r.name for r in tracing.spans()] == ["a", "b", "c"] and tracing.dropped == 2
    assert [r.parent for r in tracing.spans()] == [None, 0, 1]
    # the profiler still ranges the spans that were not listed
    assert sum(e.name == "mer.c" for e in prof.events()) == 3


def test_main_thread_spans_map_onto_the_profilers_clock():
    """Paired with their host events, the median offset places each span's start within 50 us of its event's
    (at least 98 in 100 of them: a preempted thread may stamp late). The capture's first range stamps later
    than the rest (the profiler sets up its thread's buffer), so one warm-up span comes first."""
    x = torch.randn(48, 48)
    with capture() as prof:
        with span("warm"):
            pass
        for i in range(150):
            with span("work", i=i):
                for _ in range(3):
                    x = torch.tanh(x @ x)
    records = [r for r in tracing.spans() if r.name == "work"]
    events = sorted(e.time_range.start for e in prof.events() if e.name == "mer.work")
    offset, pairs = tracing.clock_offset_us(tracing.spans(), [(e.name, e.time_range.start) for e in prof.events()])
    assert len(pairs) == 151 and len(records) == len(events) == 150
    errors = sorted(abs(r.start_ns / 1000.0 + offset - t) for r, t in zip(records, events))
    assert statistics.median(errors) < 10.0 and errors[int(0.98 * len(errors)) - 1] < 50.0, errors[-10:]


def test_trace_writes_the_prefetch_threads_spans(tmp_path):
    batches = [{"a": np.full((64, 8), i, np.int16), "b": np.arange(i + 3, dtype=np.float32)} for i in range(6)]
    with profiling.trace(str(tmp_path)):
        got = []
        with span("loop"):
            prefetcher = DevicePrefetcher(iter(batches), device="cpu", buffer_size=2)
            for b in prefetcher:
                got.append(int(b["a"][0, 0]))
    assert got == list(range(6)) and prefetcher.h2d_bytes == sum(v.nbytes for b in batches for v in b.values())
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    producer = {r.thread for r in tracing.spans() if r.name.startswith("prefetch.")}
    assert len(producer) == 1 and threading.get_native_id() not in producer
    (tid,) = producer
    h2d = sorted((e for e in events if e.get("name") == "mer.prefetch.h2d"), key=lambda e: e["ts"])
    host = [e for e in events if e.get("name") == "mer.prefetch.host"]
    assert len(h2d) == 6 and len(host) == 7 and {e["tid"] for e in h2d + host} == {tid}
    assert [e["args"]["batch"] for e in h2d] == list(range(6))
    assert [e["args"]["bytes"] for e in h2d] == [sum(v.nbytes for v in b.values()) for b in batches]
    assert any(e.get("ph") == "M" and e.get("tid") == tid and e["name"] == "thread_name" for e in events)
    # placed on the trace's clock: batch i is staged before the consumer's wait for it ends
    waits = sorted((e for e in events if e.get("name") == "mer.stream.wait"), key=lambda e: e["ts"])
    (loop,) = [e for e in events if e.get("name") == "mer.loop"]
    assert len(waits) == 7 and waits[0]["tid"] != tid
    for moved, wait in zip(h2d, waits):
        assert moved["ts"] + moved["dur"] <= wait["ts"] + wait["dur"] + 50.0
        assert loop["ts"] - 50.0 <= moved["ts"] <= loop["ts"] + loop["dur"]


@pytest.fixture(scope="module")
def stream():
    """A narrow stream (seeded weights) over 3 dialogues of 4 utterances in batches of 4."""
    fusion = load_config(CONFIG_PATH).model.override(
        TEXT__embedding_size=D, AUDIO__embedding_size=D, FAM__embedding_size=D, TEXT__n_head=4, AUDIO__n_head=4,
        FAM__n_head=4, TEXT__n_encoder_layers=1, AUDIO__n_encoder_layers=1, FAM__n_layers=1,
        CLASSIFIER__hidden_size=D)
    models = E2EModels(text_erc_from_seed(0, RobertaConfig(**TEXT)), audio_erc_from_seed(0, Wav2Vec2Config(**W2V)),
                       init_random_(M2FNet.from_config(fusion), torch.Generator().manual_seed(0)))
    pipeline = StreamingPipeline(models, utterance_batch=4, dialogue_batch=2, device="cpu")
    rng = np.random.default_rng(0)
    batches = []
    for i in range(3):
        tokens = rng.integers(5, 20, size=4)
        mask = (np.arange(24)[None] < tokens[:, None]).astype(np.int32)
        samples = rng.integers(1000, 4000, size=4).astype(np.int32)
        ids = rng.integers(3, 300, (4, 24)).astype(np.int32) * mask
        audio = rng.integers(-3000, 3000, (4, 4000)).astype(np.int16)
        batches.append({"idx": np.arange(4 * i, 4 * i + 4), "text": ids, "attention_mask": mask, "audio": audio,
                        "lengths": samples, "emotion": rng.integers(0, 7, 4).astype(np.int32)})
    df = pd.DataFrame({"Dialogue_ID": np.repeat(np.arange(3), 4), "Utterance_ID": np.tile(np.arange(4), 3),
                       "Emotion": np.concatenate([b["emotion"] for b in batches])})
    return pipeline, batches, df


def test_stages_keep_their_keys_and_bytes(stream):
    pipeline, batches, df = stream
    wire = sum(b[k].nbytes for b in batches for k in ("text", "attention_mask", "audio", "lengths"))
    for resident in (True, False):
        result = pipeline.run(batches, df, device_resident=resident)
        stages = result["stages"]
        assert set(stages) == {"embed_host_prep_s", "embed_dispatch_s", "embed_fetch_s", "embed_h2d_bytes",
                               "stage1_embed_s", "group_s", "stage1_device_wait_s", "stage2_fusion_s"}
        assert stages["embed_h2d_bytes"] == wire and result["n_utterances"] == 12
        assert stages["stage1_device_wait_s"] == 0.0 and (stages["embed_fetch_s"] == 0.0) == resident
        assert 0.0 < stages["embed_dispatch_s"] <= stages["stage1_embed_s"]
        assert stages["stage1_embed_s"] + stages["group_s"] + stages["stage2_fusion_s"] <= result["seconds"]
    with capture():
        result = pipeline.run(batches, df)
    records = tracing.spans()
    named = by_name(records)
    (whole,) = named["stream.pass"]
    assert whole.attrs == {"utterances": 12}
    for name in ("stream.stage1", "stream.group", "stream.stage2"):
        assert records[named[name][0].parent] is whole, name
    assert [r.attrs for r in named["stream.batch"]] == [{"batch": i, "tokens": 24, "samples": 4000} for i in range(3)]
    assert all(records[r.parent].name == "stream.dispatch" for r in named["stream.batch"] + named["stream.wait"])
    assert sum(r.attrs["bytes"] for r in named["prefetch.h2d"]) == result["stages"]["embed_h2d_bytes"] == wire
    assert len(named["stream.wait"]) == len(named["prefetch.host"]) == 4


class _Clips:
    """The batcher's dataset interface over seeded clips."""

    sample_rate = 16000

    def __init__(self, n: int):
        rng = np.random.default_rng(1)
        self.clips = [rng.normal(scale=0.1, size=int(k)).astype(np.float32) for k in rng.integers(1500, 3900, n)]
        self.labels = rng.integers(0, 7, n)

    def __len__(self):
        return len(self.clips)

    def waveform_lengths(self):
        return np.array([len(c) for c in self.clips])

    def waveform(self, k):
        return self.clips[k]


def test_fe_step_and_batch_spans():
    model = audio_erc_from_seed(0, Wav2Vec2Config(**W2V))
    config = Config({"solver": {"loss_fn": "CE", "balance_classes": False, "num_frozen_epochs": 0,
                                "finetuning": {"lr": 1e-4, "weight_decay": 0.0, "warmup_epochs": 0},
                                "frozen": {"lr": 1e-4, "weight_decay": 0.0}, "epochs": 1,
                                "early_stopping": {"enabled": False, "patience": 3, "restore_best_weights": False}},
                     "tpu": {"compute_dtype": "float32", "seed": 0}, "wandb": {"enabled": False}})
    solver = FESolver(model, config, batch_to_inputs=w2v_batch_to_inputs, backbone_key="wav2vec2")
    batcher = Wav2Vec2Batcher(_Clips(6), 4, seconds_buckets=(0.125, 0.25))
    state = solver.init_state(len(batcher))
    with capture() as prof:
        state, loss = solver.train_epoch(state, batcher, 0)
    records = tracing.spans()
    named = by_name(records)
    assert np.isfinite(loss) and len(named["fe.step"]) == len(named["data.batch"]) == 2
    for k, step in enumerate(named["fe.step"]):
        index = records.index(step)
        children = [r.name for r in records if r.parent == index]
        assert children == ["fe.seed", "fe.inputs", "fe.forward", "fe.backward", "fe.update"]
        formed = named["data.batch"][k].attrs
        assert formed == {"batch": k, "width": formed["width"], "rows": 4} and formed["width"] in (2000, 4000)
        assert step.attrs == {"step": k, "rows": 4, "width": formed["width"]}
    # each batch is formed outside the step it feeds
    assert all(b.end_ns <= s.start_ns for b, s in zip(named["data.batch"], named["fe.step"]))
    assert sum(e.name == "mer.fe.step" for e in prof.events()) == 2


def test_e2e_stream_trace_dir(meld_like_root_with_wavs, tmp_path, monkeypatch):
    from mer_tpu_torch import e2e_stream

    root, sizes = meld_like_root_with_wavs
    monkeypatch.chdir(tmp_path)  # no checkpoints here: seeded weights
    fusion = load_config(CONFIG_PATH).model.override(
        TEXT__embedding_size=D, AUDIO__embedding_size=D, FAM__embedding_size=D, TEXT__n_head=4, AUDIO__n_head=4,
        FAM__n_head=4, TEXT__n_encoder_layers=1, AUDIO__n_encoder_layers=1, FAM__n_layers=1,
        CLASSIFIER__hidden_size=D)
    text = RobertaConfig(**{**TEXT, "vocab_size": 1000, "max_position_embeddings": 520})
    result = e2e_stream.main(["--data-root", root, "--toy-tokenizer", "--utterance-batch", "8", "--device", "cpu",
                              "--trace-dir", str(tmp_path / "traces")],
                             model_configs=(text, Wav2Vec2Config(**W2V), fusion))
    assert result["n_utterances"] == sizes["test"]
    (path,) = glob.glob(str(tmp_path / "traces" / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"mer.stream.pass", "mer.stream.batch", "mer.prefetch.host", "mer.prefetch.h2d"} <= names
    main = {e["tid"] for e in events if e.get("name") == "mer.stream.pass"}
    assert {e["tid"] for e in events if e.get("name") == "mer.prefetch.h2d"}.isdisjoint(main)


def test_probe_spans_on_the_cpu(capsys):
    """The probe's readings at a small count: a second thread's spans are listed though the capture records no
    host event of that thread (started inside the capture or before it), and the clock's pairs are found."""
    from mer_tpu_torch.scripts import probe_spans

    out = probe_spans.main(["--device", "cpu", "--repeats", "300"])
    assert out["inside_span_listed"] and out["before_span_listed"]
    assert not out["inside_range_event"] and not out["before_range_event"] and out["host_threads_in_capture"] == 1
    assert out["pairs"] == 2000 and out["q1_us"] <= 0.0 <= out["q3_us"]
    assert 0 < out["span_off_ns"] < out["span_on_ns"] and json.loads(capsys.readouterr().out.splitlines()[-1]) == out
