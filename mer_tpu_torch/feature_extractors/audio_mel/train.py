"""Mel feature-extractor training (counterpart of
``src/feature_extractors/audio_mel/train.py``): ResNet18 metric learning with
per-step hard triplet mining and the composite adaptive-triplet + covariance
+ variance loss.

    python -m mer_tpu_torch.feature_extractors.audio_mel.train [--config PATH]
        [--data-root DIR] [--epochs N] [--bf16 | --f32] [--device cuda|cpu]
"""

from __future__ import annotations

from mer_tpu_torch.feature_extractors.audio_mel import build_solver, parse_args


def main(argv=None):
    """Returns ``(state, history)``, or ``(None, None)`` when ``DEBUG.train`` is off."""
    config, solver = build_solver(parse_args(argv, prog="python -m mer_tpu_torch.feature_extractors.audio_mel.train"))
    print(f"Loaded {len(solver.data_train)} utterances for training")
    print(f"Loaded {len(solver.data_val)} utterances for valing")
    if not bool(config.get_path("DEBUG.train", True)):
        return None, None
    print("Training...")
    state, history = solver.fit()
    print("Training complete")
    return state, history


if __name__ == "__main__":
    main()
