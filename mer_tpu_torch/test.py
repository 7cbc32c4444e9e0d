"""M2FNet fusion evaluation of the test split (counterpart of ``src/test.py``).

Loads a reference-layout checkpoint (``torch.save({'epoch',
'model_state_dict'})``), predicts every test batch with
:class:`~mer_tpu_torch.serving.offline.BatchedPredictor` and prints the
batch-averaged metrics in ``src/test.py``'s format.

    python -m mer_tpu_torch.test [--synthetic] [--config PATH] [--data-root DIR]
        [--checkpoint PATH] [--serving-batch N] [--int8] [--device cuda|cpu]

``--serving-batch N`` merges same-shape batches into batches of up to N
dialogues; metrics are still computed per original batch, so the
batch-averaged numbers are those of the unmerged loop. ``--int8`` predicts
through the int8 engine (``serving/quant.py``) over the checkpoint's f32
weights.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mer_tpu_torch.core import CONFIG_PATH, compute_dtype, length_buckets, load_config
from mer_tpu_torch.data import FusionBatcher, FusionDataset, SyntheticFusionDataset
from mer_tpu_torch.objectives import BatchAveragedMetrics
from mer_tpu_torch.serving import BatchedPredictor, recollate_batches, split_recollated
from mer_tpu_torch.serving.engine import DTYPE_LABEL, build_model, predict_fn, resolve_device

SYNTHETIC_TEST_DIALOGUES, SYNTHETIC_TEST_SEED = 280, 2  # MELD test size; src/pipeline.py's seed


def eval_dataset(config, synthetic: bool, data_root: str | None = None):
    """The test split: MELD embeddings, or MELD-test-shaped synthetic
    dialogues sized by the config's embedding widths."""
    if synthetic:
        return SyntheticFusionDataset(
            n_dialogues=SYNTHETIC_TEST_DIALOGUES, seed=SYNTHETIC_TEST_SEED,
            d_text=int(config.model.TEXT.embedding_size),
            d_audio=int(config.model.AUDIO.embedding_size))
    return FusionDataset("test", config, data_root=data_root)


def eval_batches(config, dataset) -> list[dict]:
    """The test split's batches in dataset order (no shuffle, no sort)."""
    loader = config.test.data_loader
    return list(FusionBatcher(
        dataset, batch_size=int(loader.batch_size), shuffle=bool(loader.shuffle),
        seed=int(config.get_path("tpu.seed", 0)), buckets=length_buckets(config),
        sort_by_length=bool(loader.shuffle)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.test")
    p.add_argument("--config", default=CONFIG_PATH)
    p.add_argument("--synthetic", action="store_true", help="MELD-test-shaped synthetic data")
    p.add_argument("--data-root", default=None, help="directory containing MELD.Raw (default ./data)")
    p.add_argument("--checkpoint", default=None,
                   help="reference-layout .pth (default: config checkpoint.load_path)")
    p.add_argument("--serving-batch", type=int, default=None,
                   help="merge same-shape batches into serving batches of up to N dialogues")
    p.add_argument("--int8", action="store_true", help="predict through the int8 serving engine")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config)

    dataset = eval_dataset(config, args.synthetic, args.data_root)
    print(f"Loaded {len(dataset)} dialogues for testing")

    ckpt_path = os.path.abspath(args.checkpoint or str(config.checkpoint.load_path))
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"Checkpoint not found at {ckpt_path}")
    model = build_model(config, device, checkpoint=ckpt_path, dtype=torch.float32 if args.int8 else None)
    predictor = BatchedPredictor(predict_fn(model, int8=args.int8), device)

    batches = eval_batches(config, dataset)
    feed = [{k: b[k] for k in ("text", "audio", "padding_mask")} for b in batches]
    if args.serving_batch is not None:
        merged, plan = recollate_batches(feed, args.serving_batch)
        preds = split_recollated(predictor(merged), plan)
    else:
        preds = predictor(feed)

    metrics = BatchAveragedMetrics()
    for b, pr in zip(batches, preds):
        emotion = np.asarray(b["emotion"])
        metrics.update(emotion, pr, mask=emotion != -1)
    mode = f"{'int8' if args.int8 else DTYPE_LABEL[compute_dtype(config)]}, {device.type}"
    if args.serving_batch is not None:
        mode += f", serving_batch={args.serving_batch}"
    print(f"Accuracy=[{metrics.batch_averaged_accuracy * 100:.3f}%] "
          f"Weighted_F1=[{metrics.batch_averaged_weighted_f1 * 100:.3f}%] ({mode})")
    return metrics.summary()


if __name__ == "__main__":
    main()
