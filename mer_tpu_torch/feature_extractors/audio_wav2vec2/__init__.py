"""The wav2vec2 feature extractor's entry points and their shared set-up.

    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.embeddings [flags]
    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.test [flags]

Both read the unchanged ``src/feature_extractors/audio_wav2vec2/config.yaml``
(of its ``tpu:`` block only ``compute_dtype`` and ``seed``) and take
``--config``, ``--data-root``, ``--random-init``, ``--pretrained FILE``,
``--bf16`` / ``--f32`` and ``--device`` (``cuda`` unless ``--device cpu``; no
card raises). Fine-tuning (``train``) is not ported yet.
"""

from __future__ import annotations

import os

import torch

from mer_tpu_torch.core import load_config
from mer_tpu_torch.feature_extractors.fe_common import REPO_ROOT, load_wav2vec2_model, parse_args
from mer_tpu_torch.serving.engine import resolve_device
from mer_tpu_torch.train.checkpoint import load_checkpoint

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
    if model.dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ckpt_path = os.path.abspath(str(config.checkpoint.save_path))
    if os.path.exists(ckpt_path):
        ckpt = load_checkpoint(ckpt_path)
        model.load_state_dict(ckpt.get("model_state_dict", ckpt), strict=True)
        print(f"Loaded fine-tuned checkpoint {ckpt_path}")
    elif need_checkpoint:
        raise FileNotFoundError(f"Checkpoint not found at {ckpt_path}")
    elif pretrained is not None:
        model.load_backbone(pretrained)
        print("Checkpoint not found; exporting with pretrained backbone")
    else:
        raise ValueError("Checkpoint not found")
    return args, config, model.to(device).eval()
