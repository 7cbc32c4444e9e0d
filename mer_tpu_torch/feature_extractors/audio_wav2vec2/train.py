"""wav2vec2 feature-extractor training (counterpart of
``src/feature_extractors/audio_wav2vec2/train.py``): fine-tune wav2vec2 on
MELD's utterance waveforms with the two-phase freeze / fine-tune scheme of
:class:`~mer_tpu_torch.train.fe_solver.FESolver` (a learning rate and a weight
decay per phase), writing ``checkpoint.save_path`` every epoch. The batch size
is ``tpu.batch_size_override`` when the config sets it (the reference's 2 is a
device-memory choice), else the loader's.

    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.train --data-root DIR [--epochs N]
        [--config PATH] [--random-init | --pretrained FILE] [--bf16 | --f32] [--device cuda|cpu] [--zero1]
        [--pp P [--pp-microbatches M]] [--remat [--remat-policy full|dots|dots_no_batch]]

Under ``torchrun --nproc-per-node N`` the ranks train one model on a
(dp, tp) mesh from the config's ``tpu.mesh`` (every rank on dp by default),
or with ``--pp P`` on P pipeline stages of the encoder's layers and N / P dp
ranks.
On the card the frozen epochs and every validation batch run the conv frontend
through K7 and K6 and the encoder through K1; the fine-tune epochs run the
stock differentiable convolutions and K1 + K2.
"""

from __future__ import annotations

from mer_tpu_torch.core import load_config
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
from mer_tpu_torch.feature_extractors.fe_common import (
    build_pp,
    load_wav2vec2_model,
    parallel_setup,
    parse_args,
    set_float32_exact,
    with_pretrained_backbone,
)
from mer_tpu_torch.objectives import balanced_class_weights
from mer_tpu_torch.parallel import tensor_parallel_
from mer_tpu_torch.train.fe_solver import FESolver


def main(argv=None):
    """Returns ``(state, history)``."""
    args = parse_args(argv, default_config=W2V_CONFIG_PATH,
                      prog="python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.train")
    config, mesh, device = parallel_setup(args, load_config(args.config))
    if args.epochs is not None:
        config = config.override(solver__epochs=args.epochs)

    model, pretrained = load_wav2vec2_model(args, config=config)
    set_float32_exact(model.dtype)
    model = with_pretrained_backbone(model, pretrained)
    pp_logits_fn = build_pp(args, model, mesh, config)
    model = tensor_parallel_(model, mesh).to(device)

    data_train = Wav2Vec2FeatureDataset("train", data_root=args.data_root)
    data_val = Wav2Vec2FeatureDataset("val", data_root=args.data_root)
    print(f"Loaded {len(data_train)} utterances for training")
    print(f"Loaded {len(data_val)} utterances for valing")
    batch_size = int(config.get_path("tpu.batch_size_override") or config.train.data_loader.batch_size)
    dl_train = Wav2Vec2Batcher(data_train, batch_size, shuffle=bool(config.train.data_loader.shuffle))
    dl_val = Wav2Vec2Batcher(data_val, batch_size)

    class_weights = balanced_class_weights(data_train.get_labels()) if bool(config.solver.balance_classes) else None
    solver = FESolver(model, config, backbone_key="wav2vec2", batch_to_inputs=w2v_batch_to_inputs,
                      class_weights=class_weights, mesh=mesh, pp_logits_fn=pp_logits_fn)
    print("Training...")
    state, history = solver.fit(dl_train, dl_val)
    print("Training complete")
    return state, history


if __name__ == "__main__":
    main()
