"""Text feature-extractor evaluation (counterpart of
``src/feature_extractors/text/test.py``): load the tuned checkpoint at the
config's ``test.model_path`` (not ``checkpoint.save_path``), classify the test
split at ``test.data_loader.batch_size`` and print loss, accuracy and weighted
F1.

    python -m mer_tpu_torch.feature_extractors.text.test --data-root DIR
        [--config PATH] [--random-init | --pretrained PATH] [--toy-tokenizer] [--variant NAME]
        [--bf16 | --f32] [--device cuda|cpu]
"""

from __future__ import annotations

from mer_tpu_torch.data.text_fe import TextBatcher, TextFeatureDataset, text_batch_to_inputs
from mer_tpu_torch.feature_extractors.text import build_model
from mer_tpu_torch.train.fe_solver import FESolver


def main(argv=None) -> dict:
    """Returns ``{"loss", "accuracy", "weighted_f1", ...}``."""
    args, config, model, tokenizer = build_model(argv, "python -m mer_tpu_torch.feature_extractors.text.test",
                                                 "test.model_path", need_checkpoint=True)
    data_test = TextFeatureDataset("test", tokenizer, data_root=args.data_root)
    print(f"Loaded {len(data_test)} utterances for testing")
    dl_test = TextBatcher(data_test, int(config.test.data_loader.batch_size))
    return FESolver(model, config, batch_to_inputs=text_batch_to_inputs).test(dl_test)


if __name__ == "__main__":
    main()
