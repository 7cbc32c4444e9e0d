"""wav2vec2 feature-extractor evaluation (counterpart of
``src/feature_extractors/audio_wav2vec2/test.py``): load the checkpoint at
``checkpoint.save_path``, classify the test split at
``test.data_loader.batch_size`` and print loss, accuracy and weighted F1.

    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.test --data-root DIR
        [--config PATH] [--random-init | --pretrained FILE] [--bf16 | --f32] [--device cuda|cpu]
"""

from __future__ import annotations

from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import build_model
from mer_tpu_torch.train.fe_solver import FESolver


def main(argv=None) -> dict:
    """Returns ``{"loss", "accuracy", "weighted_f1", ...}``."""
    args, config, model = build_model(argv, "python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.test",
                                      need_checkpoint=True)
    data_test = Wav2Vec2FeatureDataset("test", data_root=args.data_root)
    print(f"Loaded {len(data_test)} utterances for testing")
    dl_test = Wav2Vec2Batcher(data_test, int(config.test.data_loader.batch_size))
    return FESolver(model, config, batch_to_inputs=w2v_batch_to_inputs).test(dl_test)


if __name__ == "__main__":
    main()
