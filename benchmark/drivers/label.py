"""Passes of the port's emotion stream over a MELD-shaped test split:
``StreamingPipeline.run(..., device_resident=True)`` with wav2vec2,
RoBERTa and M2FNet.

Set-up makes the split from the seed (``Split``: dialogue sizes, clip
durations and words per utterance are one fixed draw, dealt to the
utterances by a fixed stream, so every seed streams batches of the same
widths; the samples, token ids and labels come from the seed),
builds the host batches in the stream's format, length-sorted as the stream
sorts them, builds the three models with weights made on the device, and
runs one warm pass. The window runs whole passes until the deadline; each
pass is the stream's own host work, transfers, the three models and its one
prediction copy. What the last pass produced (both embeddings of every
utterance, the fusion logits of every utterance) is compared with the
plain reference afterwards.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import checks, meld
from benchmark.harness.cell import RunRecord
from benchmark.harness.flops import m2fnet_forward_flops, roberta_forward_flops, wav2vec2_forward_flops
from benchmark.harness.ops import OpRecorder
from benchmark.harness.weights import seeded_weights
from benchmark.harness.window import Window, free_device, memory_peak
from benchmark.reference import m2fnet as ref_m2f
from benchmark.reference import roberta as ref_rob
from benchmark.reference import wav2vec2 as ref_w2v
from benchmark.reference.common import FP32, float32_exact

STREAMS = {"roberta": 1, "wav2vec2": 2, "m2fnet": 3}


class Split:
    """The test split of one seed: rows dialogue by dialogue, and the
    stream's host batches (``idx``, ``text``, ``attention_mask``, int16
    ``audio``, ``lengths``, ``emotion``)."""

    def __init__(self, seed: int, traffic: dict, roberta: dict):
        n_dia, n_utt = traffic["dialogues"], traffic["utterances"]
        sizes = meld.dialogue_sizes(n_dia, n_utt, traffic["max_dialogue"])
        # the sizes go to the utterances by the fixed stream, so every seed's batches have the same widths
        deal = meld.seeded_rng(meld.SIZES_SEED, 4).permutation(n_utt)
        self.samples = meld.seconds_to_samples(meld.duration_quantiles(n_utt, traffic["durations"]))[deal]
        words = meld.words_per_utterance(n_utt, *traffic["words"])[deal]
        rng = meld.seeded_rng(seed, 20)
        self.labels = rng.integers(0, meld.NUM_CLASSES, size=n_utt)
        self.dialogue = np.repeat(np.arange(n_dia), sizes)
        self.position = np.concatenate([np.arange(s) for s in sizes])
        self.starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.sizes = sizes
        pad, bos, eos = roberta["pad_token_id"], roberta["bos_token_id"], roberta["eos_token_id"]
        ids = rng.integers(3, roberta["vocab_size"], size=int(words.sum()))
        utter = np.split(ids, np.cumsum(words)[:-1])
        contexts = []
        for r in range(n_utt):  # <s> prev </s> current </s> next </s>, a missing neighbour left out
            first, last = self.position[r] == 0, self.position[r] == sizes[self.dialogue[r]] - 1
            parts = [[bos]] + ([] if first else [utter[r - 1]]) + [[eos], utter[r], [eos]]
            parts += ([] if last else [utter[r + 1]]) + [[eos]]
            contexts.append(np.concatenate(parts))
        self.tokens = np.array([len(c) for c in contexts])
        bank = meld.SignalBank(seed)
        audio_ladder = [int(s * meld.SAMPLE_RATE) for s in traffic["seconds_buckets"]]
        order = np.argsort(self.samples, kind="stable")
        b = traffic["utterance_batch"]
        self.batches = []
        for i in range(0, n_utt, b):
            idx = order[i: i + b]
            pad_rows = b - len(idx)
            full = np.concatenate([idx, idx[-1:].repeat(pad_rows)]) if pad_rows else idx
            t_width = meld.bucket(int(self.tokens[full].max()), traffic["token_buckets"])
            text = np.full((b, t_width), pad, np.int32)
            mask = np.zeros((b, t_width), np.int32)
            a_width = meld.bucket(int(self.samples[full].max()), audio_ladder)
            audio = np.zeros((b, a_width), np.int16)
            for k, r in enumerate(full):
                text[k, : self.tokens[r]] = contexts[r]
                mask[k, : self.tokens[r]] = 1
                audio[k, : self.samples[r]] = np.round(bank.clip(int(r), int(self.samples[r])) * 32768.0)
            emotion = self.labels[full].astype(np.int32)
            if pad_rows:
                emotion[len(idx):] = -1
            self.batches.append({"idx": full, "text": text, "attention_mask": mask, "audio": audio,
                                 "lengths": self.samples[full].astype(np.int32), "emotion": emotion})

    def table(self):
        import pandas as pd

        return pd.DataFrame({"Dialogue_ID": self.dialogue, "Utterance_ID": self.position, "Emotion": self.labels})

    def pass_flops(self, cfg: dict) -> float:
        """The FLOPs one pass needs at every utterance's and dialogue's own size."""
        fl = sum(wav2vec2_forward_flops(cfg["wav2vec2"], int(n)) for n in self.samples)
        fl += sum(roberta_forward_flops(cfg["roberta"], int(n)) for n in self.tokens)
        return fl + sum(m2fnet_forward_flops(cfg["m2fnet"], int(u)) for u in self.sizes)


class Capture:
    """Wraps the pipeline's three model calls and keeps one pass's outputs."""

    def __init__(self, pipeline):
        self.outputs: dict[str, list[torch.Tensor]] = {"text": [], "audio": [], "logits": []}
        for attr, key in (("_text_embed", "text"), ("_audio_model_embed", "audio"), ("_fusion_logits", "logits")):
            setattr(pipeline, attr, self._keep(getattr(pipeline, attr), key))

    def _keep(self, call, key: str):
        def wrapped(*args):
            out = call(*args)
            self.outputs[key].append(out)
            return out
        return wrapped

    def reset(self) -> None:
        for v in self.outputs.values():
            v.clear()


def port_models(cfg: dict, seed: int, device: str, compute_dtype: torch.dtype):
    from mer_tpu_torch.core.config import Config
    from mer_tpu_torch.models import M2FNet
    from mer_tpu_torch.models.roberta import RobertaConfig, TextERC
    from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config

    r, w = cfg["roberta"], cfg["wav2vec2"]
    rcfg = RobertaConfig(**{k: r[k] for k in RobertaConfig.__dataclass_fields__ if k in r},
                         hidden_dropout=r["hidden_dropout_prob"], attention_dropout=r["attention_probs_dropout_prob"])
    wcfg = Wav2Vec2Config(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in w.items()
                             if k in Wav2Vec2Config.__dataclass_fields__})
    with torch.device(device):
        text, audio = TextERC(rcfg, compute_dtype), AudioERC(wcfg, compute_dtype)
        fusion = M2FNet.from_config(Config(cfg["m2fnet"]))
    for model, name in ((text, "roberta"), (audio, "wav2vec2"), (fusion, "m2fnet")):
        model.load_state_dict(reference_weights(cfg, name, seed, device))
    return text, audio, fusion.to(getattr(torch, cfg["serve"]["fusion_weights_dtype"]))


def reference_weights(cfg: dict, name: str, seed: int, device: str) -> dict:
    """The seed's weights of one model; the fusion model's are made in the
    dtype it is served in (then held in float32, exactly)."""
    spec = {"roberta": ref_rob, "wav2vec2": ref_w2v, "m2fnet": ref_m2f}[name].param_spec(cfg[name])
    dtype = getattr(torch, cfg["serve"]["fusion_weights_dtype"]) if name == "m2fnet" else torch.float32
    return {k: v.float() for k, v in seeded_weights(spec, seed, STREAMS[name], device, dtype).items()}


def program_rows(split: Split, outputs: dict, n_utt: int) -> dict[str, torch.Tensor]:
    """The last pass's outputs as [rows, D] in row order."""
    rows = {}
    for key in ("text", "audio"):
        table = torch.zeros((n_utt, outputs[key][0].shape[-1]), device=outputs[key][0].device)
        for batch, out in zip(split.batches, outputs[key], strict=True):
            keep = torch.from_numpy(batch["emotion"] != -1)
            table[torch.from_numpy(batch["idx"])[keep]] = out.float()[keep.to(out.device)]
        rows[key] = table
    logits = torch.zeros((n_utt, outputs["logits"][0].shape[-1]), device=outputs["logits"][0].device)
    per_chunk = outputs["logits"][0].shape[0]
    for c, out in enumerate(outputs["logits"]):
        for i, d in enumerate(range(c * per_chunk, min((c + 1) * per_chunk, len(split.sizes)))):
            s, n = split.starts[d], split.sizes[d]
            logits[s: s + n] = out[i, :n].float()
    rows["logits"] = logits
    return rows


@torch.no_grad()
def reference_rows(cfg: dict, seed: int, split: Split, device: str, prec=FP32) -> dict[str, torch.Tensor]:
    """Both embeddings and the logits of every utterance, in row order, by
    the plain reference from the same batches' inputs."""
    float32_exact()
    n_utt = len(split.labels)
    out = {"text": torch.zeros((n_utt, cfg["roberta"]["hidden_size"]), device=device),
           "audio": torch.zeros((n_utt, cfg["wav2vec2"]["hidden_size"]), device=device)}
    w = reference_weights(cfg, "roberta", seed, device)
    for batch in split.batches:
        rows = torch.from_numpy(batch["idx"]).to(device)
        out["text"][rows] = ref_rob.cls_embedding(w, cfg["roberta"], torch.from_numpy(batch["text"]).to(device),
                                                  torch.from_numpy(batch["attention_mask"]).to(device), prec)
    w = reference_weights(cfg, "wav2vec2", seed, device)
    for batch in split.batches:
        rows = torch.from_numpy(batch["idx"]).to(device)
        wave = torch.from_numpy(batch["audio"]).to(device).float() / 32768.0
        out["audio"][rows] = ref_w2v.embed(w, cfg["wav2vec2"], wave, torch.from_numpy(batch["lengths"]).to(device),
                                           prec)
    del w
    out["logits"] = reference_logits(cfg, seed, split, out["text"], out["audio"], device, prec)
    return out


@torch.no_grad()
def reference_logits(cfg: dict, seed: int, split: Split, text_rows: torch.Tensor, audio_rows: torch.Tensor,
                     device: str, prec=FP32) -> torch.Tensor:
    """M2FNet's logits of every utterance, in row order, from [rows, D]
    embedding tables, dialogue by dialogue (in chunks of the serving batch,
    each padded to its longest dialogue; padded keys are ignored)."""
    float32_exact()
    w = reference_weights(cfg, "m2fnet", seed, device)
    logits = torch.zeros((len(split.labels), cfg["m2fnet"]["CLASSIFIER"]["output_size"]), device=device)
    chunk = cfg["serve"]["dialogue_batch"]
    for c in range(0, len(split.sizes), chunk):
        dias = range(c, min(c + chunk, len(split.sizes)))
        u = int(max(split.sizes[d] for d in dias))
        text = torch.zeros((len(dias), u, text_rows.shape[1]), device=device)
        audio = torch.zeros((len(dias), u, audio_rows.shape[1]), device=device)
        padding = torch.ones((len(dias), u), dtype=torch.bool, device=device)
        for i, d in enumerate(dias):
            s, n = split.starts[d], split.sizes[d]
            text[i, :n], audio[i, :n], padding[i, :n] = text_rows[s: s + n], audio_rows[s: s + n], False
        got = ref_m2f.logits(w, cfg["m2fnet"], text, audio, padding, prec)
        for i, d in enumerate(dias):
            s, n = split.starts[d], split.sizes[d]
            logits[s: s + n] = got[i, :n]
    return logits


def readings(got: dict, want: dict, missing: int) -> dict[str, float]:
    """The numbers a limit may judge: per embedding table the mean gap of the
    worst hundredth of its rows (``text_top``, ``audio_top``), the worst
    row's gap of the fusion logits (``logit_gap``), and the rows never
    answered (``missing``)."""
    out = {"missing": float(missing)}
    for key in ("text", "audio"):
        gaps = checks.row_gaps(got[key], want[key]).sort().values
        out[f"{key}_top"] = float(gaps[-max(len(gaps) // 100, 1):].mean())
    out["logit_gap"] = float(checks.row_gaps(got["logits"], want["logits"]).max())
    return out


def build(ctx, engine: str = "bf16", split: Split | None = None):
    """(split, pipeline, capture) of a run; ``split`` made from the seed
    unless given."""
    from mer_tpu_torch.pipelines import E2EModels, StreamingPipeline

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    split = split or Split(ctx.seed, traffic, cfg["roberta"])
    models = port_models(cfg, ctx.seed, ctx.device, getattr(torch, cfg["serve"]["compute_dtype"]))
    pipeline = StreamingPipeline(E2EModels(*models), utterance_batch=traffic["utterance_batch"],
                                 dialogue_batch=cfg["serve"]["dialogue_batch"],
                                 buckets=tuple(traffic["dialogue_buckets"]), engine=engine,
                                 wire=cfg["serve"]["wire"], device=ctx.device)
    return split, pipeline, Capture(pipeline)


def run(ctx) -> RunRecord:
    recorder = OpRecorder().install_port_entries() if ctx.trace else None
    split, pipeline, capture = build(ctx)
    df = split.table()
    n_utt = len(split.labels)
    pipeline.run(split.batches, df, device_resident=True)  # warm pass: every shape of the split

    with Window(ctx, recorder) as win:
        setup_s = win.t0 - ctx.t_start
        passes = answered = 0
        pass_s, stages = [], []
        while passes == 0 or time.perf_counter() < win.deadline:
            capture.reset()
            result = pipeline.run(split.batches, df, device_resident=True)
            answered = result["n_utterances"]
            passes += 1
            pass_s.append(time.perf_counter())
            stages.append(result["stages"])
    peak = memory_peak(ctx.device)
    layers = win.layers(flops=passes * split.pass_flops(ctx.cell.config),
                        peak_flops_dtype=ctx.cell.config["serve"]["compute_dtype"])
    if recorder is not None:
        recorder.uninstall()

    got = program_rows(split, capture.outputs, n_utt)
    del pipeline, capture
    free_device(ctx.device)
    want = reference_rows(ctx.cell.config, ctx.seed, split, ctx.device)
    got = readings(got, want, n_utt - answered)
    ends = [win.t0] + pass_s
    notes = [f"pass seconds: {[round(b - a, 4) for a, b in zip(ends, ends[1:])]!r}"]
    for key in ("embed_host_prep_s", "embed_dispatch_s", "stage1_embed_s", "group_s", "stage1_device_wait_s",
                "stage2_fusion_s"):
        notes.append(f"stage {key} a pass: {[round(float(s[key]), 4) for s in stages if key in s]!r}")
    return RunRecord(notes=notes, setup_s=setup_s, end_to_end={"label_utt_per_s": passes * n_utt / win.seconds},
                     attempted=passes * n_utt, failed=passes * (n_utt - answered), memory_peak_bytes=peak,
                     checks=checks.judged(got, ctx.cell.traffic["limits"]),
                     counters=win.counters, layers=layers)
