"""wav2vec2 embedding export (counterpart of
``src/feature_extractors/audio_wav2vec2/embeddings.py``): load the fine-tuned
checkpoint at ``checkpoint.save_path``, run the bare encoder with masked mean
pooling over the valid frames, and write
``<save_dir>/{train,val,test}.pkl``, float32 [N, 768] tables in the reference
pickle layout: the audio tables the fusion stage loads.

    python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.embeddings --data-root DIR
        [--config PATH] [--random-init | --pretrained FILE] [--bf16 | --f32] [--int8] [--device cuda|cpu]

``--int8`` embeds through the int8 serving engine
(:class:`~mer_tpu_torch.serving.encoders.Wav2Vec2Int8`: K7 and K6 in f32, K1
in bf16 on the card) over the model's f32 weights. Each split goes through in batches of 32 clips (the reference's export batch),
padded to the 2 / 4 / 6 / 8 / 10 s ladder; on the card every batch launches K7
once, K6 once and K1 once per encoder layer. The embeddings stay on the device
until the split ends and are fetched once.
"""

from __future__ import annotations

import os

import torch

from mer_tpu_torch.core import save_embeddings
from mer_tpu_torch.data.wav2vec2_fe import SECONDS_BUCKETS, Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
from mer_tpu_torch.feature_extractors.audio_wav2vec2 import build_model
from mer_tpu_torch.feature_extractors.fe_common import export_embedding_table, int8_embed
from mer_tpu_torch.serving import Wav2Vec2Int8, quantize_wav2vec2

MODES = ("train", "val", "test")
EXPORT_BATCH = 32


@torch.no_grad()
def export_split(model, dataset, batch_size: int = EXPORT_BATCH, seconds_buckets=SECONDS_BUCKETS, embed=None):
    """[N, H] float32 table of ``dataset`` in table order, batches padded to
    the ``seconds_buckets`` ladder; ``embed`` (waveforms, lengths) -> [B, H]
    replaces ``model.embed`` (the int8 engine)."""
    device = next(model.parameters()).device
    embed = embed or model.embed
    rows, embeddings = [], []
    for batch in Wav2Vec2Batcher(dataset, batch_size, seconds_buckets=seconds_buckets):
        embeddings.append(embed(*w2v_batch_to_inputs(batch, device)))
        rows.append(batch["idx"][batch["emotion"] != -1])
    if not rows:
        return export_embedding_table([], 0, model.cfg.hidden_size)
    fetched = torch.stack(embeddings).cpu().numpy()  # one transfer for the split
    return export_embedding_table(zip(rows, fetched), len(dataset), model.cfg.hidden_size)


def main(argv=None, save_dir: str = "embeddings/audio_wav2vec2") -> dict:
    """Returns ``{mode: [N, 768] table}``."""
    args, _, model = build_model(argv, "python -m mer_tpu_torch.feature_extractors.audio_wav2vec2.embeddings",
                                 need_checkpoint=False)
    embed = int8_embed(model, quantize_wav2vec2, Wav2Vec2Int8) if args.int8 else None
    tables = {}
    for mode in MODES:
        ds = Wav2Vec2FeatureDataset(mode, data_root=args.data_root)
        print(f"Saving {mode} embeddings...")
        tables[mode] = export_split(model, ds, embed=embed)
        out = os.path.join(os.path.abspath(save_dir), f"{mode}.pkl")
        save_embeddings(out, tables[mode])
        print(f"Saved {mode} embeddings to {out}")
    return tables


if __name__ == "__main__":
    main()
