"""The text (RoBERTa) feature extractor's entry points and their shared set-up.

    python -m mer_tpu_torch.feature_extractors.text.train [flags]
    python -m mer_tpu_torch.feature_extractors.text.test [flags]
    python -m mer_tpu_torch.feature_extractors.text.embeddings [flags]

They read the unchanged ``src/feature_extractors/text/config.yaml`` (of its
``tpu:`` block only ``compute_dtype`` and ``seed``) and take ``--config``,
``--data-root``, ``--random-init``, ``--pretrained PATH``, ``--toy-tokenizer``,
``--variant``, ``--bf16`` / ``--f32``, ``--device`` (``cuda`` unless ``--device
cpu``; no card raises), for training ``--epochs`` and for the export ``--int8``.
"""

from __future__ import annotations

import os

from mer_tpu_torch.core import load_config
from mer_tpu_torch.feature_extractors.fe_common import (
    REPO_ROOT,
    load_finetuned,
    load_text_model_and_tokenizer,
    parse_args,
    set_float32_exact,
)
from mer_tpu_torch.serving.engine import resolve_device

TEXT_CONFIG_PATH = os.path.join(REPO_ROOT, "src", "feature_extractors", "text", "config.yaml")


def build_model(argv, prog: str, checkpoint_key: str, need_checkpoint: bool):
    """(args, config, model on the device in eval mode, tokenizer) for an
    entry point: the fine-tuned checkpoint at the config's ``checkpoint_key``
    when it exists; else, unless ``need_checkpoint``, the pretrained backbone
    under the seeded head; else an error."""
    args = parse_args(argv, default_config=TEXT_CONFIG_PATH, prog=prog)
    device = resolve_device(args.device)
    config = load_config(args.config)
    model, tokenizer, pretrained = load_text_model_and_tokenizer(args, config=config)
    set_float32_exact(model.dtype)
    load_finetuned(model, pretrained, str(config.get_path(checkpoint_key)), need_checkpoint)
    return args, config, model.to(device).eval(), tokenizer
