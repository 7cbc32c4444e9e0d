"""The wav2vec2 feature extractor's entry points and their shared set-up.

    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.train [flags]
    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.embeddings [flags]
    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.test [flags]

They read the unchanged ``src/feature_extractors/audio_wav2vec2/config.yaml``
(of its ``tpu:`` block only ``compute_dtype``, ``seed`` and, for training,
``batch_size_override``) and take ``--config``, ``--data-root``,
``--random-init``, ``--pretrained FILE``, ``--bf16`` / ``--f32``, ``--device``
(``cuda`` unless ``--device cpu``; no card raises), for training
``--epochs`` and for the export ``--int8``.
"""

from __future__ import annotations

import os

from mer_tpu_torch.core import load_config
from mer_tpu_torch.feature_extractors.fe_common import (
    REPO_ROOT,
    load_finetuned,
    load_wav2vec2_model,
    parse_args,
    set_float32_exact,
)
from mer_tpu_torch.serving.engine import resolve_device

W2V_CONFIG_PATH = os.path.join(REPO_ROOT, "src", "feature_extractors", "audio_wav2vec2", "config.yaml")


def build_model(argv, prog: str, need_checkpoint: bool):
    """(args, config, model on the device in eval mode) for an entry point:
    the fine-tuned checkpoint at ``checkpoint.save_path`` (a ``model_state_dict``
    or a bare ``state_dict``) when it exists; else, unless ``need_checkpoint``,
    the pretrained backbone under the seeded head; else an error. In float32
    TF32 is turned off, so f32 means f32 on the card."""
    args = parse_args(argv, default_config=W2V_CONFIG_PATH, prog=prog)
    device = resolve_device(args.device)
    config = load_config(args.config)
    model, pretrained = load_wav2vec2_model(args, config=config)
    set_float32_exact(model.dtype)
    load_finetuned(model, pretrained, str(config.checkpoint.save_path), need_checkpoint)
    return args, config, model.to(device).eval()
