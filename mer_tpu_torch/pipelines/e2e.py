"""End-to-end streaming inference: utterance wavs and transcripts -> emotion
predictions (counterpart of ``mer_tpu/pipelines/e2e.py``).

    host:    wav decode (the native batch decoder) and tokenization, in the
             prefetch thread, which also moves each batch to the device
    device:  audio utterance embeddings: wav2vec2 (K7, K6, K1 on the card)
             or log-mel -> ResNet18 (K5 on the card)
    device:  RoBERTa [CLS] utterance embeddings (K1)
    device:  dialogue grouping -> M2FNet fusion -> predictions (K1)

No intermediate artifact touches the disk. Stage 1 runs one batch at a time
(``mer_tpu``'s ``--per-batch-stage1`` mode; the scan-grouped stage 1, its
coalesced upload and its compile-cache padding save XLA dispatches and have
no counterpart here). The embedding tables stay on the device and stage 2
gathers its dialogue batches from them; only the predictions come back, in
one copy. Throughput: utterances per second end to end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from mer_tpu_torch.data.fusion import DEFAULT_LENGTH_BUCKETS, collate_dialogues, pick_bucket
from mer_tpu_torch.data.text_fe import pad_tokens_to
from mer_tpu_torch.models.resnet import AudioMelFeatureExtractor
from mer_tpu_torch.objectives.metrics import BatchAveragedMetrics
from mer_tpu_torch.ops.mulaw import mulaw_decode, mulaw_encode_np
from mer_tpu_torch.utils.tracing import span

WIRES = ("int16", "mulaw")
DEVICE_KEYS = ("text", "attention_mask", "audio", "lengths")


@dataclass
class E2EModels:
    """The three models of the stream: a ``TextERC``, an ``AudioERC``
    (wav2vec2, 768-d) or an ``AudioMelFeatureExtractor`` (log-mel ->
    ResNet18, 300-d, with its BatchNorm statistics in its ``state_dict``),
    and the ``M2FNet`` fusion model. Each computes in its own dtype."""

    text_model: nn.Module
    audio_model: nn.Module
    fusion_model: nn.Module


def _check_choice(name: str, value: str, choices) -> None:
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


class StreamingPipeline:
    """The three models chained with device-resident intermediates.

    ``engine="bf16"`` runs the models as they are; ``engine="int8"`` serves
    all three through the int8 engines (:mod:`mer_tpu_torch.serving.quant`,
    :mod:`mer_tpu_torch.serving.encoders`), built from the models' weights;
    the wav2vec2 branch only. ``wire`` is the waveform's host -> device
    format: int16 PCM (exact) or uint8 μ-law (half the bytes, lossy); the
    batches must carry it (:func:`mixed_utterance_batches`' ``wire``).
    """

    def __init__(self, models: E2EModels, utterance_batch: int = 32, dialogue_batch: int = 32,
                 buckets=DEFAULT_LENGTH_BUCKETS, engine: str = "bf16", mel_cfg=None, wire: str = "int16",
                 device: torch.device | str = "cuda"):
        _check_choice("engine", engine, ("bf16", "int8"))
        _check_choice("wire", wire, WIRES)
        self.engine, self.wire = engine, wire
        self.device = torch.device(device)
        self.utterance_batch, self.dialogue_batch, self.buckets = utterance_batch, dialogue_batch, buckets
        self.audio_kind = "mel" if isinstance(models.audio_model, AudioMelFeatureExtractor) else "wav2vec2"
        if self.audio_kind == "mel":
            if engine == "int8":
                raise ValueError("engine='int8' supports the wav2vec2 audio branch only (the mel branch is "
                                 "convolutions, which have no int8 path)")
            if any(m.running_mean is None or m.running_var is None
                   for m in models.audio_model.modules() if isinstance(m, nn.BatchNorm2d)):
                raise ValueError("the mel audio branch needs its BatchNorm running statistics (batch_stats): "
                                 "a trained or freshly built extractor has them in its state_dict")
            from mer_tpu_torch.ops.logmel import MelConfig

            self.mel_cfg = mel_cfg if mel_cfg is not None else MelConfig()
        self.m = E2EModels(*(m.to(self.device).eval() for m in
                             (models.text_model, models.audio_model, models.fusion_model)))
        if engine == "int8":
            from mer_tpu_torch.serving import (M2FNetInt8, RobertaInt8, Wav2Vec2Int8, quantize_m2fnet,
                                               quantize_roberta, quantize_wav2vec2)

            text_q, audio_q, fusion_q = (quantize_roberta(self.m.text_model), quantize_wav2vec2(self.m.audio_model),
                                         quantize_m2fnet(self.m.fusion_model))
            text_s, audio_s, fusion_s = (RobertaInt8(self.m.text_model), Wav2Vec2Int8(self.m.audio_model),
                                         M2FNetInt8(self.m.fusion_model))
            self._text_embed = lambda ids, mask: text_s.embed(text_q, ids, mask)
            self._audio_model_embed = lambda audio, lengths: audio_s.embed(audio_q, audio, lengths)
            self._fusion_logits = lambda text, audio, mask: fusion_s.apply(fusion_q, text, audio, mask)
        else:
            self._text_embed = self.m.text_model.embed
            self._audio_model_embed = self._mel_embed if self.audio_kind == "mel" else self.m.audio_model.embed
            self._fusion_logits = self.m.fusion_model

    # -- stage 1: utterance embeddings ------------------------------------------

    def _wire_decode(self, audio: torch.Tensor) -> torch.Tensor:
        if self.wire == "mulaw":
            return mulaw_decode(audio)
        return audio.to(torch.float32) / 32768.0

    def _mel_embed(self, audio: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Waveforms padded or cut to the mel config's ``max_samples`` ->
        log-mel images (K5 on the card) -> ResNet18 -> [B, 300] float32."""
        from mer_tpu_torch.ops.logmel import log_mel_spectrogram

        cfg = self.mel_cfg
        pad = cfg.max_samples - audio.shape[1]
        if pad > 0:
            audio = torch.nn.functional.pad(audio, (0, pad))
        spec = log_mel_spectrogram(audio[:, : cfg.max_samples], lengths.clamp_max(cfg.max_samples), cfg)
        return self.m.audio_model(spec.to(next(self.m.audio_model.parameters()).dtype))

    def _audio_embed(self, audio_wire: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return self._audio_model_embed(self._wire_decode(audio_wire), lengths).float()

    def _check_wire(self, audio) -> None:
        """Raise on a batch whose audio is not this pipeline's wire format
        (μ-law decoding of int16 PCM, or the reverse, would be silent garbage)."""
        expect = np.uint8 if self.wire == "mulaw" else np.int16
        got = np.asarray(audio).dtype
        if got != expect:
            raise ValueError(f"wire={self.wire!r} expects {np.dtype(expect).name} audio batches, got {got.name}: "
                             f"pass wire={self.wire!r} to mixed_utterance_batches too")

    @torch.inference_mode()
    def embed_utterances(self, batches, stage_times: dict | None = None, fetch: bool = True):
        """Embed host batches carrying both modalities (``text``,
        ``attention_mask``, ``audio``, ``lengths``, ``idx``, ``emotion``),
        one batch at a time, the transfers in the prefetch thread.

        ``fetch=True`` returns host float32 ([N, Dt], [N, Da]) tables in row
        order. ``fetch=False`` returns ``(table_t, table_a, pos)``: flat
        device tables in batch order and ``pos[row]``, a row's position in
        them (a row met only as padding, ``emotion`` -1, raises).

        ``stage_times`` gets ``embed_host_prep_s`` (host batch production in
        the prefetch thread: it overlaps the dispatch, it is not a phase of
        its own), ``embed_dispatch_s`` (the loop that issues the batches),
        ``embed_fetch_s`` (the device -> host copies, 0 for ``fetch=False``)
        and ``embed_h2d_bytes`` (the bytes of the wire arrays sent), from the
        spans ``prefetch.host`` and ``prefetch.h2d`` (the prefetcher's
        totals), ``stream.dispatch`` and ``stream.fetch``; each batch's
        dispatch of the two encoders is a ``stream.batch`` span."""
        from mer_tpu_torch.data.prefetch import DevicePrefetcher

        host = []

        def device_batches():
            for b in batches:
                if not host:
                    self._check_wire(b["audio"])
                host.append((np.asarray(b["idx"]), np.asarray(b["emotion"])))
                yield {k: np.asarray(b[k]) for k in DEVICE_KEYS}

        pending = []
        prefetcher = DevicePrefetcher(device_batches(), device=self.device, buffer_size=4)
        with span("stream.dispatch") as dispatch:
            for i, b in enumerate(prefetcher):
                with span("stream.batch", batch=i, tokens=b["text"].shape[1], samples=b["audio"].shape[1]):
                    te = self._text_embed(b["text"].long(), b["attention_mask"]).float()
                    ae = self._audio_embed(b["audio"], b["lengths"])
                pending.append((te, ae))
        if stage_times is not None:
            stage_times["embed_host_prep_s"] = prefetcher.host_s
            stage_times["embed_dispatch_s"] = dispatch.seconds
            stage_times["embed_h2d_bytes"] = prefetcher.h2d_bytes
        if not pending:
            raise ValueError("no utterance batches")
        if not fetch:
            table_t = torch.cat([te for te, _ in pending])
            table_a = torch.cat([ae for _, ae in pending])
            pos = np.full((1 + max(int(idx.max()) for idx, _ in host),), -1, np.int64)
            offset = 0
            for (idx, emotion), (te, _) in zip(host, pending):
                valid = emotion != -1
                pos[idx[valid]] = offset + np.flatnonzero(valid)
                offset += te.shape[0]
            if not (pos >= 0).all():
                raise ValueError(f"{int((pos < 0).sum())} dataset rows never appeared in the utterance stream (or "
                                 "only as emotion == -1 padding): the device-resident handoff would read them "
                                 "as padding")
            if stage_times is not None:
                stage_times["embed_fetch_s"] = 0.0
            return table_t, table_a, pos
        text_rows, audio_rows, idx_rows = [], [], []
        with span("stream.fetch") as fetched:
            for (idx, emotion), (te, ae) in zip(host, pending):  # fetched after every batch was issued
                valid = emotion != -1
                text_rows.append(te.cpu().numpy()[valid])
                audio_rows.append(ae.cpu().numpy()[valid])
                idx_rows.append(idx[valid])
        if stage_times is not None:
            stage_times["embed_fetch_s"] = fetched.seconds
        order = np.argsort(np.concatenate(idx_rows))
        return np.concatenate(text_rows)[order], np.concatenate(audio_rows)[order]

    # -- stage 2: fusion over dialogues -------------------------------------------

    def _predict(self, text, audio, padding_mask) -> torch.Tensor:
        return self._fusion_logits(text, audio, padding_mask).argmax(-1)

    @torch.inference_mode()
    def predict_dialogues(self, dialogues: list[dict]) -> tuple[np.ndarray, np.ndarray]:
        """``dialogues``: [{"text": [U, Dt], "audio": [U, Da], "emotion": [U]}]
        on the host, collated as the fusion batcher does. Returns the flat
        (y_true, y_pred) over the real utterances."""
        y_true, y_pred = [], []
        for i in range(0, len(dialogues), self.dialogue_batch):
            batch = collate_dialogues(dialogues[i: i + self.dialogue_batch], self.dialogue_batch, self.buckets)
            preds = self._predict(*(torch.from_numpy(batch[k]).to(self.device)
                                    for k in ("text", "audio", "padding_mask"))).cpu().numpy()
            mask = batch["emotion"] != -1
            y_true.append(batch["emotion"][mask])
            y_pred.append(preds[mask])
        return np.concatenate(y_true), np.concatenate(y_pred)

    @torch.inference_mode()
    def predict_dialogues_from_tables(self, table_t: torch.Tensor, table_a: torch.Tensor,
                                      dialogues: list[dict]) -> tuple[np.ndarray, np.ndarray]:
        """Stage 2 from the device tables: each dialogue batch gathered from
        the flat [N, D] tables by per-modality index matrices (-1 gives a
        zero row), the predictions of every batch fetched in one copy.
        ``dialogues``: [{"rows": [U] table positions, "emotion": [U]}], or
        "rows_t" and "rows_a" for tables in different orders."""
        pending = []
        for i in range(0, len(dialogues), self.dialogue_batch):
            chunk = dialogues[i: i + self.dialogue_batch]
            u = pick_bucket(max(len(d.get("rows", d.get("rows_t"))) for d in chunk), self.buckets)
            idxm_t = np.full((self.dialogue_batch, u), -1, np.int64)
            idxm_a = np.full((self.dialogue_batch, u), -1, np.int64)
            emotion = np.full((self.dialogue_batch, u), -1, np.int64)
            for k, d in enumerate(chunk):
                rows_t, rows_a = d.get("rows_t", d.get("rows")), d.get("rows_a", d.get("rows"))
                n = len(rows_t)
                idxm_t[k, :n], idxm_a[k, :n], emotion[k, :n] = rows_t, rows_a, d["emotion"]
            padding_mask = emotion == -1
            padding_mask[padding_mask.all(axis=1), 0] = False  # an all-pad row keeps key 0 attendable
            text, audio = (self._gather(table, idxm) for table, idxm in ((table_t, idxm_t), (table_a, idxm_a)))
            pending.append((emotion, self._predict(text, audio, torch.from_numpy(padding_mask).to(self.device))))
        flat = torch.cat([p.reshape(-1) for _, p in pending]).cpu().numpy()  # one device -> host copy
        y_true, y_pred, off = [], [], 0
        for emotion, p in pending:
            preds = flat[off: off + p.numel()].reshape(tuple(p.shape))
            off += p.numel()
            mask = emotion != -1
            y_true.append(emotion[mask])
            y_pred.append(preds[mask])
        return np.concatenate(y_true), np.concatenate(y_pred)

    def _gather(self, table: torch.Tensor, idxm: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(idxm).to(self.device)
        return torch.where((idx >= 0)[..., None], table[idx.clamp_min(0)], 0.0)

    # -- full run -------------------------------------------------------------------

    def run(self, utterance_batches, df, timed: bool = True, device_resident: bool = True) -> dict:
        """Stream ``utterance_batches`` (host batches of both modalities) and
        label every row of ``df`` (the split's table: dialogue structure and
        labels). ``device_resident=True`` hands the embeddings to stage 2 as
        device tables; ``False`` fetches [N, D] tables, groups them on the
        host and uploads the dialogue batches again.

        ``stages``: ``embed_*`` (:meth:`embed_utterances`),
        ``stage1_embed_s`` (stage 1's loop), ``group_s`` (grouping the rows
        into dialogues on the host), ``stage1_device_wait_s`` (a device
        synchronize after the grouping: the stage-1 work still queued, so
        that it is not charged to stage 2; 0 on the host-table path, whose
        fetch waits already), ``stage2_fusion_s`` (the rest, to the last
        prediction on the host): the spans ``stream.stage1``, ``stream.group``,
        ``stream.device_wait`` and ``stream.stage2`` inside ``stream.pass``
        (``seconds``)."""
        from mer_tpu_torch.core import dialogue_index

        stages: dict = {}
        labels = df["Emotion"].to_numpy()
        wait_s = 0.0
        with span("stream.pass", utterances=len(labels)) as whole:
            with span("stream.stage1") as stage1:
                tables = self.embed_utterances(utterance_batches, stage_times=stages, fetch=not device_resident)
            with span("stream.group") as group:
                index = [np.asarray(rows) for rows in dialogue_index(df).values()]
                if device_resident:
                    dialogues = [{"rows": tables[2][rows], "emotion": labels[rows].astype(np.int64)} for rows in index]
                else:
                    dialogues = [{"text": tables[0][rows], "audio": tables[1][rows],
                                  "emotion": labels[rows].astype(np.int64)} for rows in index]
            if device_resident and self.device.type == "cuda":
                with span("stream.device_wait") as waited:
                    torch.cuda.synchronize(self.device)
                wait_s = waited.seconds
            with span("stream.stage2") as stage2:
                if device_resident:
                    y_true, y_pred = self.predict_dialogues_from_tables(tables[0], tables[1], dialogues)
                else:
                    y_true, y_pred = self.predict_dialogues(dialogues)
        dt = whole.seconds
        stages.update(stage1_embed_s=stage1.seconds, group_s=group.seconds, stage1_device_wait_s=wait_s,
                      stage2_fusion_s=stage2.seconds)

        metrics = BatchAveragedMetrics()
        metrics.update(y_true, y_pred, mask=np.ones_like(y_true, bool))
        return {
            "n_utterances": int(len(y_true)),
            "seconds": dt,
            "utterances_per_sec": len(y_true) / dt if timed else None,
            "accuracy": metrics.pooled_accuracy,
            "weighted_f1": metrics.pooled_weighted_f1,
            "stages": stages,
        }


def mixed_utterance_batches(text_ds, w2v_ds, batch_size: int = 16, seconds_buckets=(2.0, 4.0, 6.0, 8.0, 10.0),
                            token_buckets=(64, 128, 256, 512), sort_by_length: bool = True, wire: str = "int16"):
    """Host batches carrying both modalities of the same rows (``text_ds`` a
    ``TextFeatureDataset``, ``w2v_ds`` a ``Wav2Vec2FeatureDataset`` of the
    same split): ``idx``, ``text`` and ``attention_mask`` (the token ladder;
    past its last rung the tokenizer truncates), ``audio`` [B, width] on the
    wire (int16 PCM or uint8 μ-law; width from the wave ladder in seconds),
    ``lengths`` and ``emotion``; the last batch is filled by repeating its
    last row under ``emotion`` -1.

    ``sort_by_length`` (the default) orders the rows by their WAV header's
    length, so a batch pads to a rung near its own clips; ``False`` keeps
    the table's order. Every batch carries its rows in ``idx``, so the order
    does not change the predictions. One batch decode per batch
    (``waveform_batch``)."""
    _check_choice("wire", wire, WIRES)
    n = len(text_ds)
    if len(w2v_ds) != n:
        raise ValueError(f"text and audio datasets differ in length: {n} against {len(w2v_ds)}")
    sample_buckets = tuple(int(s * w2v_ds.sample_rate) for s in seconds_buckets)
    header_lengths = w2v_ds.waveform_lengths()
    order = np.arange(n)
    if sort_by_length:
        order = order[np.argsort(header_lengths, kind="stable")]
    bucket = lambda x, ladder: next((b for b in ladder if x <= b), ladder[-1])
    tokenizer = text_ds.tokenizer
    for i in range(0, n, batch_size):
        idx = order[i: i + batch_size]
        pad = batch_size - len(idx)
        full = np.concatenate([idx, idx[-1:].repeat(pad)]) if pad else idx
        texts = [text_ds.texts[j] for j in full]
        ids, mask = tokenizer(texts)
        width = bucket(ids.shape[1], token_buckets)
        if ids.shape[1] <= width:
            ids, mask = pad_tokens_to(ids, mask, width, tokenizer.pad_id)
        else:  # longer than the last rung: the tokenizer truncates
            ids, mask = tokenizer(texts, pad_to=width)
        wav, lengths = w2v_ds.waveform_batch(full, bucket(int(header_lengths[full].max()), sample_buckets))
        audio = mulaw_encode_np(wav) if wire == "mulaw" else np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
        emotion = text_ds.labels[full].astype(np.int32).copy()
        if pad:
            emotion[len(idx):] = -1
        yield {"idx": full, "text": ids, "attention_mask": mask, "audio": audio, "lengths": lengths,
               "emotion": emotion}
