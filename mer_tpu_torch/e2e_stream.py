"""End-to-end streaming inference (counterpart of ``src/e2e_stream.py``):
utterance wavs and transcripts -> wav2vec2 (or log-mel -> ResNet18) and
RoBERTa utterance embeddings on the device -> M2FNet fusion -> a prediction
per utterance, with nothing written to the disk in between.

    python -m mer_tpu_torch.e2e_stream [--mode test] [--data-root DIR] [--toy-tokenizer]
        [--utterance-batch 32] [--audio wav2vec2|mel] [--wire int16|mulaw] [--corpus-order]
        [--int8] [--device cuda|cpu] [--trace-dir DIR]

Reads the unchanged ``src/config.yaml`` (with ``--audio mel`` the fusion
model takes 300-d audio embeddings with 6 heads). Weights: the port's own
checkpoints where they exist (the text and wav2vec2 extractors'
``checkpoint.save_path``, the mel extractor's, the fusion model's
``checkpoint.load_path``, or ``<root>_mel<ext>`` beside it for the mel
variant); otherwise seeded random weights, which the run says. The text,
wav2vec2 and fusion models compute in bf16, the mel extractor in f32 (as
the port's mel export). ``--int8`` serves all three models through the int8
engines (wav2vec2 branch only). A warm pass, then the timed pass; two result
lines. ``--per-batch-stage1`` and ``--no-coalesce`` are accepted for
``mer_tpu``'s command lines: the port has one stage-1 mode, one batch at a
time with one transfer each, which is what they select there.
``--trace-dir DIR`` profiles the timed pass into ``DIR`` as one Chrome trace
(``utils.profiling.trace``): the host ops and kernels, the port's spans on
the main thread, and the prefetch thread's spans on a track of their own.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from mer_tpu_torch.core import CONFIG_PATH, get_text, load_config, map_emotions
from mer_tpu_torch.data.text_fe import TextFeatureDataset, ToyWhitespaceTokenizer, load_roberta_tokenizer
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2FeatureDataset
from mer_tpu_torch.feature_extractors.fe_common import REPO_ROOT, load_finetuned
from mer_tpu_torch.models import M2FNet, init_random_, load_reference_checkpoint, mel_extractor_from_seed
from mer_tpu_torch.models.roberta import RobertaConfig, text_erc_from_seed
from mer_tpu_torch.models.wav2vec2 import Wav2Vec2Config, audio_erc_from_seed
from mer_tpu_torch.pipelines import E2EModels, StreamingPipeline, mixed_utterance_batches
from mer_tpu_torch.serving.engine import resolve_device
from mer_tpu_torch.utils import trace
from mer_tpu_torch.models.convert import load_model_state_dict

FE_CONFIGS = {name: os.path.join(REPO_ROOT, "src", "feature_extractors", name, file)
              for name, file in (("text", "config.yaml"), ("audio_wav2vec2", "config.yaml"),
                                 ("audio_mel", "config_audio_mel.yaml"))}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.e2e_stream")
    p.add_argument("--mode", default="test")
    p.add_argument("--data-root", default=None, help="directory containing MELD.Raw (default ./data)")
    p.add_argument("--toy-tokenizer", action="store_true", help="the hash tokenizer (no tokenizer files)")
    p.add_argument("--utterance-batch", type=int, default=32)
    p.add_argument("--int8", action="store_true", help="serve all three models through the int8 engines")
    p.add_argument("--wire", choices=("int16", "mulaw"), default="int16",
                   help="waveform host -> device format: int16 PCM (exact, default) or uint8 mu-law (half "
                        "the bytes, lossy, about 35-38 dB SNR)")
    p.add_argument("--corpus-order", action="store_true",
                   help="utterances in table order instead of sorted by length (sorting packs batches into "
                        "tight wave buckets)")
    p.add_argument("--no-coalesce", action="store_true",
                   help="accepted for mer_tpu's command lines: the port sends each batch in its own transfers")
    p.add_argument("--per-batch-stage1", action="store_true",
                   help="accepted for mer_tpu's command lines: the port's stage 1 is always per batch")
    p.add_argument("--audio", default="wav2vec2", choices=("wav2vec2", "mel"),
                   help="audio embedder: wav2vec2 (768-d) or log-mel -> ResNet18 (300-d)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--trace-dir", default=None,
                   help="profile the timed pass into this directory as a Chrome trace, every thread's spans in it")
    return p.parse_args(argv)


def _checkpoint_path(name: str) -> str:
    return os.path.abspath(str(load_config(FE_CONFIGS[name]).checkpoint.save_path))


def _load_or_seeded(what: str, model, path: str, load) -> None:
    if os.path.exists(path):
        load(model, path)
    else:
        print(f"{what}: no checkpoint at {path}; seeded random weights")


def build_models(audio: str, text_cfg: RobertaConfig, w2v_cfg: Wav2Vec2Config, fusion_model_cfg, int8: bool,
                 fusion_ckpt: str) -> E2EModels:
    """The three models from their configs, on the host: checkpoints where
    they exist, else seeded random weights (seed 0). bf16 compute for the
    text and wav2vec2 extractors, f32 for the mel one; the fusion model's
    weights cast to bf16 unless ``int8`` (which quantizes f32 weights)."""
    finetuned = lambda model, path: load_finetuned(model, None, path, need_checkpoint=True)
    text_model = text_erc_from_seed(0, text_cfg, torch.bfloat16)
    _load_or_seeded("text extractor", text_model, _checkpoint_path("text"), finetuned)
    if audio == "mel":
        audio_model = mel_extractor_from_seed(0)

        def load_mel(model, path):
            model.load_state_dict(load_model_state_dict(path, "mel"), strict=True)
            print(f"Loaded {path}")

        _load_or_seeded("mel extractor", audio_model, _checkpoint_path("audio_mel"), load_mel)
    else:
        audio_model = audio_erc_from_seed(0, w2v_cfg, torch.bfloat16)
        _load_or_seeded("wav2vec2 extractor", audio_model, _checkpoint_path("audio_wav2vec2"), finetuned)
    fusion_model = init_random_(M2FNet.from_config(fusion_model_cfg), torch.Generator().manual_seed(0))

    def load_fusion(model, path):
        model.load_state_dict(load_reference_checkpoint(path, fusion_model_cfg), strict=True)
        print(f"Loaded {path}")

    _load_or_seeded("fusion model", fusion_model, fusion_ckpt, load_fusion)
    if not int8:
        fusion_model = fusion_model.to(torch.bfloat16)
    return E2EModels(text_model, audio_model, fusion_model)


def setup(args, model_configs: tuple | None = None):
    """(pipeline, batches, df) of a parsed command line: the pipeline over
    the models, ``batches()`` a fresh pass of host batches over the split,
    ``df`` the split's table. ``model_configs`` = (RobertaConfig,
    Wav2Vec2Config, the fusion ``model:`` block) replaces the full-size
    models (RoBERTa-base, wav2vec2-base, ``src/config.yaml``'s fusion model)."""
    device = resolve_device(args.device)
    fusion_cfg = load_config(CONFIG_PATH)
    text_cfg, w2v_cfg, fusion_model_cfg = model_configs or (RobertaConfig.base(), Wav2Vec2Config.base(),
                                                            fusion_cfg.model)
    fusion_cfg = fusion_cfg.override(model=fusion_model_cfg.to_dict())
    fusion_ckpt = os.path.abspath(str(fusion_cfg.checkpoint.load_path))
    if args.audio == "mel":  # 300-d mel embeddings, 6 heads of 50; a fusion checkpoint of its own
        fusion_cfg = fusion_cfg.override(model__AUDIO__embedding_size=300, model__AUDIO__n_head=6)
        root, ext = os.path.splitext(fusion_ckpt)
        fusion_ckpt = f"{root}_mel{ext}"

    tokenizer = ToyWhitespaceTokenizer() if args.toy_tokenizer else load_roberta_tokenizer()
    text_ds = TextFeatureDataset(args.mode, tokenizer, data_root=args.data_root)
    w2v_ds = Wav2Vec2FeatureDataset(args.mode, data_root=args.data_root)
    df = map_emotions(get_text(args.mode, data_root=args.data_root))
    print(f"Loaded {len(text_ds)} utterances for {args.mode}")

    models = build_models(args.audio, text_cfg, w2v_cfg, fusion_cfg.model, args.int8, fusion_ckpt)
    pipeline = StreamingPipeline(models, utterance_batch=args.utterance_batch,
                                 dialogue_batch=int(fusion_cfg.test.data_loader.batch_size),
                                 engine="int8" if args.int8 else "bf16", wire=args.wire, device=device)
    batches = lambda: mixed_utterance_batches(text_ds, w2v_ds, batch_size=args.utterance_batch,
                                              sort_by_length=not args.corpus_order, wire=args.wire)
    return pipeline, batches, df


def main(argv=None, model_configs: tuple | None = None) -> dict:
    """A warm pass, then the timed pass (profiled under ``--trace-dir``),
    whose result this returns (``model_configs``: :func:`setup`'s)."""
    args = parse_args(argv)
    pipeline, batches, df = setup(args, model_configs)
    pipeline.run(batches(), df)  # warm pass: the allocator and every bucket's first call
    with trace(args.trace_dir):
        result = pipeline.run(batches(), df)
    print(f"e2e streaming: {result['n_utterances']} utterances in {result['seconds']:.2f}s "
          f"({result['utterances_per_sec']:.1f} utt/s) Accuracy=[{result['accuracy'] * 100:.3f}%] "
          f"Weighted_F1=[{result['weighted_f1'] * 100:.3f}%]")
    print(f"e2e stages: {json.dumps(result['stages'])}")
    return result


if __name__ == "__main__":
    main()
