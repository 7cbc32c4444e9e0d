"""Shared wiring of the text and wav2vec2 feature-extractor entry points
(counterpart of ``src/feature_extractors/fe_common.py``).

Ported so far, for the wav2vec2 extractor's export and evaluation:
:func:`parse_args`, :func:`resolve_compute_dtype`, :func:`load_wav2vec2_model`
and :func:`export_embedding_table`. ``--int8``, ``--pp``, ``--remat`` and
``--zero1`` are parsed and refused: the serving engine, the pipeline, the
rematerialisation and the sharded optimizer they select are not ported. The
encoder has one layout here, so ``--scan-layers`` has no counterpart, and the
export always loops over batches (``mer_tpu``'s ``--per-batch-export`` shape;
its scan grouping exists to save jit dispatches).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mer_tpu_torch.models.convert import read_torch_checkpoint
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config, audio_erc_from_seed

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_UNPORTED = {"int8": "the int8 serving engine", "pp": "pipeline parallelism",
             "remat": "rematerialisation (a fine-tuning option)", "zero1": "the sharded optimizer state"}


def parse_args(argv=None, default_config: str | None = None, prog: str | None = None):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--config", default=default_config)
    p.add_argument("--data-root", default=None, help="directory containing MELD.Raw (default ./data)")
    p.add_argument("--random-init", action="store_true",
                   help="seeded random backbone weights instead of pretrained ones (smoke runs)")
    p.add_argument("--pretrained", default=None,
                   help="local file: a torch.save'd wav2vec2-base state_dict (Hugging Face key names)")
    dtype = p.add_mutually_exclusive_group()
    dtype.add_argument("--bf16", action="store_true", help="force bf16 compute over the f32 weights")
    dtype.add_argument("--f32", action="store_true", help="force float32 compute")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--int8", action="store_true", help="not ported")
    p.add_argument("--pp", type=int, default=1, help="not ported")
    p.add_argument("--remat", action="store_true", help="not ported")
    p.add_argument("--zero1", action="store_true", help="not ported")
    args = p.parse_args(argv)
    for flag, what in _UNPORTED.items():
        if args.pp != 1 if flag == "pp" else getattr(args, flag):
            raise NotImplementedError(f"--{flag}: {what} is not ported to mer_tpu_torch yet")
    return args


def resolve_compute_dtype(args, config=None) -> torch.dtype:
    """bf16 *compute* over f32 parameters, or f32: ``--bf16`` / ``--f32``
    force; otherwise the config's ``tpu.compute_dtype`` decides (the shipped
    configs say bfloat16; float32 where the key is absent)."""
    if getattr(args, "f32", False):
        return torch.float32
    if getattr(args, "bf16", False):
        return torch.bfloat16
    name = str(config.get_path("tpu.compute_dtype", "float32")) if config is not None else "float32"
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


def load_wav2vec2_model(args, variant: str = "facebook/wav2vec2-base", config=None) -> tuple[AudioERC, dict | None]:
    """(model on the host, pretrained backbone ``state_dict`` or None): the
    base-config ``AudioERC`` with seeded random weights (``tpu.seed``) in the
    resolved compute dtype. Without ``--random-init`` the pretrained backbone
    must be a local ``--pretrained`` file; nothing is downloaded."""
    dtype = resolve_compute_dtype(args, config)
    seed = int(config.get_path("tpu.seed", 0)) if config is not None else 0
    model = audio_erc_from_seed(seed, Wav2Vec2Config.base(), dtype)
    if args.random_init:
        return model, None
    if not (args.pretrained and os.path.isfile(args.pretrained)):
        raise RuntimeError(
            f"pretrained backbone '{args.pretrained or variant}' is unavailable (this package downloads nothing). "
            "Stage the weights locally and pass --pretrained <state_dict file>, or run with --random-init for a "
            "smoke run; results will NOT match the reference's fine-tuned artifacts (audio_wav2vec2/model.py:9).")
    return model, read_torch_checkpoint(args.pretrained)


def export_embedding_table(embed_batches, n_rows: int, dim: int) -> np.ndarray:
    """[N, D] float32 from (row indices, embeddings) batches: scatter
    semantics as the reference exporters' (text/embeddings.py:70,86-90)."""
    out = np.zeros((n_rows, dim), dtype=np.float32)
    for idx, emb in embed_batches:
        out[np.asarray(idx)] = np.asarray(emb)[: len(idx)]
    return out
