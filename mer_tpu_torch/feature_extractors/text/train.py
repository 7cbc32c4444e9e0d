"""Text feature-extractor training (counterpart of
``src/feature_extractors/text/train.py``): fine-tune RoBERTa on MELD's
context-window utterances with the two-phase freeze / fine-tune scheme of
:class:`~mer_tpu_torch.train.fe_solver.FESolver`, writing
``checkpoint.save_path`` every epoch.

    python -m mer_tpu_torch.feature_extractors.text.train --data-root DIR [--epochs N]
        [--config PATH] [--random-init | --pretrained PATH] [--toy-tokenizer] [--variant NAME]
        [--bf16 | --f32] [--device cuda|cpu] [--zero1] [--pp P [--pp-microbatches M]]
        [--remat [--remat-policy full|dots|dots_no_batch]]

Under ``torchrun --nproc-per-node N`` the ranks train one model on a
(dp, tp) mesh from the config's ``tpu.mesh`` (every rank on dp by default),
or with ``--pp P`` on P pipeline stages of RoBERTa's layers and N / P dp
ranks.
"""

from __future__ import annotations

from mer_tpu_torch.core import load_config
from mer_tpu_torch.data.text_fe import TextBatcher, TextFeatureDataset, text_batch_to_inputs
from mer_tpu_torch.feature_extractors.fe_common import (
    build_pp,
    load_text_model_and_tokenizer,
    parallel_setup,
    parse_args,
    set_float32_exact,
    with_pretrained_backbone,
)
from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH
from mer_tpu_torch.objectives import balanced_class_weights
from mer_tpu_torch.parallel import tensor_parallel_
from mer_tpu_torch.train.fe_solver import FESolver


def main(argv=None):
    """Returns ``(state, history)``."""
    args = parse_args(argv, default_config=TEXT_CONFIG_PATH,
                      prog="python -m mer_tpu_torch.feature_extractors.text.train")
    config, mesh, device = parallel_setup(args, load_config(args.config))
    if args.epochs is not None:
        config = config.override(solver__epochs=args.epochs)

    model, tokenizer, pretrained = load_text_model_and_tokenizer(args, config=config)
    set_float32_exact(model.dtype)
    model = with_pretrained_backbone(model, pretrained)
    pp_logits_fn = build_pp(args, model, mesh, config)
    model = tensor_parallel_(model, mesh).to(device)

    data_train = TextFeatureDataset("train", tokenizer, data_root=args.data_root)
    data_val = TextFeatureDataset("val", tokenizer, data_root=args.data_root)
    print(f"Loaded {len(data_train)} utterances for training")
    print(f"Loaded {len(data_val)} utterances for valing")
    dl_train = TextBatcher(data_train, int(config.train.data_loader.batch_size),
                           shuffle=bool(config.train.data_loader.shuffle))
    dl_val = TextBatcher(data_val, int(config.val.data_loader.batch_size))

    class_weights = balanced_class_weights(data_train.get_labels()) if bool(config.solver.balance_classes) else None
    solver = FESolver(model, config, backbone_key="roberta", batch_to_inputs=text_batch_to_inputs,
                      class_weights=class_weights, mesh=mesh, pp_logits_fn=pp_logits_fn)
    print("Training...")
    state, history = solver.fit(dl_train, dl_val)
    print("Training complete")
    return state, history


if __name__ == "__main__":
    main()
