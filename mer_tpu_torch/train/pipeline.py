"""M2FNet fusion training, the package's entry point (counterpart of
``src/train.py`` with ``src/pipeline.py::build``).

    python -m mer_tpu_torch.train [--synthetic] [--config PATH] [--data-root DIR]
        [--epochs N] [--device cuda|cpu]

Loads the config, builds the train and validation dialogue sets (MELD
embeddings, or ``--synthetic``: 200 train dialogues from seed 0 and 40
validation dialogues from seed 1, as ``src/pipeline.py:46-48``), keeps them
on the device (:class:`~mer_tpu_torch.data.DeviceFusionBatcher`), builds
M2FNet with f32 weights drawn from ``tpu.seed`` and trains it with
:class:`~mer_tpu_torch.train.Solver`: CE (ignore_index=-1,
label_smoothing=0.1), per-epoch validation, checkpoints, early stopping.
Of the ``tpu:`` block it reads ``length_buckets``, ``compute_dtype``,
``seed``, ``mesh`` and ``zero1`` (and checks ``dropout_prng``, which has no
meaning on CUDA).

Under ``torchrun`` each rank takes ``cuda:LOCAL_RANK`` and a place in the
(dp, tp) mesh of ``tpu.mesh`` (dp = -1: every rank left); every rank builds
the same batches (one host's ranks share one batch list, nodes take
round-robin slices of it) and the same seeded weights, then keeps its tp part:

    torchrun --nproc-per-node 2 -m mer_tpu_torch.train --synthetic [--config <tpu.mesh: {dp: 1, tp: 2}>]
"""

from __future__ import annotations

import argparse

import torch

from mer_tpu_torch.core import CONFIG_PATH, length_buckets, load_config
from mer_tpu_torch.data import DeviceFusionBatcher, FusionDataset, SyntheticFusionDataset
from mer_tpu_torch.models import M2FNet, init_random_
from mer_tpu_torch.objectives import balanced_class_weights
from mer_tpu_torch.parallel import initialize_distributed, local_device, mesh_from_config, tensor_parallel_
from mer_tpu_torch.serving.engine import resolve_device
from mer_tpu_torch.train.solver import Solver

SYNTHETIC_SPLITS = {"train": (200, 0), "val": (40, 1)}  # (dialogues, seed), src/pipeline.py:46-48


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.train")
    p.add_argument("--config", default=CONFIG_PATH)
    p.add_argument("--synthetic", action="store_true", help="run on MELD-shaped synthetic data")
    p.add_argument("--data-root", default=None, help="directory containing MELD.Raw (default ./data)")
    p.add_argument("--epochs", type=int, default=None, help="override solver.epochs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args) -> tuple:
    """(config, batchers, solver) for ``args``."""
    resolve_device(args.device)
    initialize_distributed(device=args.device)
    device = local_device(args.device)
    config = load_config(args.config)
    mesh = mesh_from_config(config)
    if args.epochs is not None:
        config = config.override(solver__epochs=args.epochs)
    seed = int(config.get_path("tpu.seed", 0))

    datasets = {}
    for mode in ("train", "val"):
        if args.synthetic:
            n, data_seed = SYNTHETIC_SPLITS[mode]
            datasets[mode] = SyntheticFusionDataset(n_dialogues=n, seed=data_seed,
                                                    d_text=int(config.model.TEXT.embedding_size),
                                                    d_audio=int(config.model.AUDIO.embedding_size))
        else:
            datasets[mode] = FusionDataset(mode, config, data_root=args.data_root)
        print(f"Loaded {len(datasets[mode])} dialogues for {mode}ing")

    batchers = {}
    for mode, dataset in datasets.items():
        loader = config[mode].data_loader
        # length-sorting cuts padding when shuffling; evaluation keeps the
        # dataset's order, so its batch-averaged metrics partition as the reference's
        batchers[mode] = DeviceFusionBatcher(dataset, batch_size=int(loader.batch_size),
                                             shuffle=bool(loader.shuffle), seed=seed,
                                             buckets=length_buckets(config), sort_by_length=bool(loader.shuffle),
                                             device=device)

    model = init_random_(M2FNet.from_config(config.model), torch.Generator().manual_seed(seed))
    model = tensor_parallel_(model, mesh).to(device)
    class_weights = None
    if bool(config.solver.balance_classes):
        class_weights = balanced_class_weights(datasets["train"].get_labels())
    return config, batchers, Solver(model, config, class_weights=class_weights, mesh=mesh)


def main(argv=None):
    config, batchers, solver = build(parse_args(argv))
    print("Training...")
    state, history = solver.fit(batchers["train"], batchers["val"])
    print("Training complete")
    return state, history
