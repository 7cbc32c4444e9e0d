"""Mel embedding export (counterpart of
``src/feature_extractors/audio_mel/embeddings.py``): load the trained
extractor from ``checkpoint.save_path`` and write
``<save_dir>/{train,val,test}.pkl``, float32 [N, 300] tables in the
reference pickle layout.

    python -m mer_tpu_torch.feature_extractors.audio_mel.embeddings [--config PATH]
        [--data-root DIR] [--bf16 | --f32] [--device cuda|cpu]

The checkpoint is one the port's trainer wrote, a reference ``.pth`` (a
``model_state_dict`` or a bare ``state_dict``, torchvision names) or a
``mer_tpu`` msgpack file or shard directory (its BatchNorm statistics
included). Each split is embedded from its wavs, 32 clips
(``test.data_loader.batch_size``) a batch, one K5 launch per batch. Under
``DEBUG.visualize`` (on in the shipped config, ``visualization_type`` 3D)
the validation split's table is plotted as ``mer_tpu`` does
(``src/feature_extractors/audio_mel/embeddings.py:74-80``): its silhouette is
printed, and the PCA -> t-SNE scatter is written to
``<save_dir>/visualization/{png,html}/visualization_0.{png,html}``, all on
the solver's device (``utils/viz.py``).
"""

from __future__ import annotations

import os

from mer_tpu_torch.core import save_embeddings
from mer_tpu_torch.data import MelFeatureDataset
from mer_tpu_torch.feature_extractors.audio_mel import build_solver, parse_args
from mer_tpu_torch.models.convert import load_model_state_dict
from mer_tpu_torch.utils.viz import visualize_embeddings

MODES = ("train", "val", "test")


def main(argv=None, save_dir: str = "embeddings/audio_mel") -> dict:
    """Returns ``{mode: [N, D] table}``."""
    args = parse_args(argv, prog="python -m mer_tpu_torch.feature_extractors.audio_mel.embeddings")
    config, solver = build_solver(args, train_mode="val")
    ckpt_path = os.path.abspath(str(config.checkpoint.save_path))
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"Checkpoint not found at {ckpt_path}: train first")
    solver.model.load_state_dict(load_model_state_dict(ckpt_path, "mel"), strict=True)
    print(f"Loaded {ckpt_path}")

    tables = {}
    for mode in MODES:
        ds = MelFeatureDataset(mode, config, data_root=args.data_root, device=solver.device)
        print(f"Saving {mode} embeddings...")
        tables[mode] = solver.export_embeddings(ds, batch_size=int(config.test.data_loader.batch_size))
        out = os.path.join(os.path.abspath(save_dir), f"{mode}.pkl")
        save_embeddings(out, tables[mode])
        print(f"Saved {mode} embeddings to {out}")
        if mode == "val" and bool(config.get_path("DEBUG.visualize", False)):
            diag = visualize_embeddings(tables[mode], ds.get_labels(), os.path.join(save_dir, "visualization"),
                                        kind=str(config.get_path("DEBUG.visualization_type", "2D")),
                                        logger=solver.logger, device=solver.device)
            print(f"silhouette score (val): {diag['silhouette']:.4f}")
    return tables


if __name__ == "__main__":
    main()
