"""The mel feature extractor's entry points and their shared set-up.

    python -m mer_tpu_torch.feature_extractors.audio_mel.train [flags]
    python -m mer_tpu_torch.feature_extractors.audio_mel.embeddings [flags]

Both read the unchanged ``src/feature_extractors/audio_mel/config_audio_mel.yaml``
and take ``--config``, ``--data-root``, ``--epochs``, ``--bf16`` / ``--f32``
and ``--device`` (``cuda`` unless ``--device cpu``; no card raises). Under
``torchrun`` the training ranks share one model on the dp axis of the
config's ``tpu.mesh`` (every rank by default), ``tpu.zero1`` sharding the
Adam moments.
"""

from __future__ import annotations

import argparse
import os

import torch

from mer_tpu_torch.core import load_config
from mer_tpu_torch.data import MelFeatureDataset
from mer_tpu_torch.models import mel_extractor_from_seed
from mer_tpu_torch.parallel import initialize_distributed, local_device, mesh_from_config
from mer_tpu_torch.serving.engine import resolve_device
from mer_tpu_torch.train.mel_solver import MelSolver

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
MEL_CONFIG_PATH = os.path.join(REPO_ROOT, "src", "feature_extractors", "audio_mel", "config_audio_mel.yaml")


def parse_args(argv=None, prog: str | None = None):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--config", default=MEL_CONFIG_PATH)
    p.add_argument("--data-root", default=None, help="directory containing MELD.Raw (default ./data)")
    p.add_argument("--epochs", type=int, default=None, help="override solver.epochs")
    dtype = p.add_mutually_exclusive_group()
    dtype.add_argument("--bf16", action="store_true", help="bf16 autocast over f32 weights and Adam state")
    dtype.add_argument("--f32", action="store_true", help="float32 throughout (the default)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_solver(args, train_mode: str = "train"):
    """(config, solver) for ``args``: the extractor with random weights from
    ``tpu.seed`` on the device, over ``train_mode`` and the validation split.
    In float32 TF32 is turned off, so f32 means f32 on the card."""
    resolve_device(args.device)
    initialize_distributed(device=args.device)
    device = local_device(args.device)
    config = load_config(args.config)
    mesh = mesh_from_config(config)
    if args.epochs is not None:
        config = config.override(solver__epochs=args.epochs)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    data_val = MelFeatureDataset("val", config, data_root=args.data_root, device=device)
    data_train = data_val if train_mode == "val" else MelFeatureDataset(train_mode, config, data_root=args.data_root,
                                                                         device=device)
    seed = int(config.get_path("tpu.seed", 0))
    model = mel_extractor_from_seed(seed).to(device)
    return config, MelSolver(model, config, data_train, data_val, seed=seed, compute_dtype=dtype, mesh=mesh)
