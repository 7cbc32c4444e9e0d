"""Text embedding export (counterpart of
``src/feature_extractors/text/embeddings.py``): load the fine-tuned checkpoint
at ``checkpoint.save_path`` (or, without one, the pretrained backbone), run the
bare encoder and write the [CLS] rows as ``<save_dir>/{train,val,test}.pkl``,
float32 [N, 768] tables in the reference pickle layout, row-indexed by table
order: the text tables the fusion stage loads.

    python -m mer_tpu_torch.feature_extractors.text.embeddings --data-root DIR
        [--config PATH] [--random-init | --pretrained PATH] [--toy-tokenizer] [--variant NAME]
        [--bf16 | --f32] [--int8] [--device cuda|cpu]

``--int8`` embeds through the int8 serving engine
(:class:`~mer_tpu_torch.serving.encoders.RobertaInt8`) over the model's f32
weights. Each split goes through in batches of 32 utterances (the reference's export
batch), padded to the 64 / 128 / 256 / 512 token ladder; on the card every
batch launches K1 once per encoder layer. The embeddings stay on the device
until the split ends and are fetched once.
"""

from __future__ import annotations

import os

import torch

from mer_tpu_torch.core import save_embeddings
from mer_tpu_torch.data.text_fe import TextBatcher, TextFeatureDataset, text_batch_to_inputs
from mer_tpu_torch.feature_extractors.fe_common import export_embedding_table, int8_embed
from mer_tpu_torch.feature_extractors.text import build_model
from mer_tpu_torch.serving import RobertaInt8, quantize_roberta

MODES = ("train", "val", "test")
EXPORT_BATCH = 32


@torch.no_grad()
def export_split(model, dataset, batch_size: int = EXPORT_BATCH, embed=None):
    """[N, H] float32 table of ``dataset`` in table order; ``embed`` (ids,
    mask) -> [B, H] replaces ``model.embed`` (the int8 engine)."""
    device = next(model.parameters()).device
    embed = embed or model.embed
    rows, embeddings = [], []
    for batch in TextBatcher(dataset, batch_size):
        embeddings.append(embed(*text_batch_to_inputs(batch, device)).float())
        rows.append(batch["idx"][batch["emotion"] != -1])
    if not rows:
        return export_embedding_table([], 0, model.cfg.hidden_size)
    fetched = torch.stack(embeddings).cpu().numpy()  # one transfer for the split
    return export_embedding_table(zip(rows, fetched), len(dataset), model.cfg.hidden_size)


def main(argv=None, save_dir: str = "embeddings/text") -> dict:
    """Returns ``{mode: [N, 768] table}``."""
    args, _, model, tokenizer = build_model(argv, "python -m mer_tpu_torch.feature_extractors.text.embeddings",
                                            "checkpoint.save_path", need_checkpoint=False)
    embed = int8_embed(model, quantize_roberta, RobertaInt8) if args.int8 else None
    tables = {}
    for mode in MODES:
        ds = TextFeatureDataset(mode, tokenizer, data_root=args.data_root)
        print(f"Saving {mode} embeddings...")
        tables[mode] = export_split(model, ds, embed=embed)
        out = os.path.join(os.path.abspath(save_dir), f"{mode}.pkl")
        save_embeddings(out, tables[mode])
        print(f"Saved {mode} embeddings to {out}")
    return tables


if __name__ == "__main__":
    main()
