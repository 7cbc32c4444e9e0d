"""Online serving entry point (counterpart of ``src/serve.py``): load the
config's fusion checkpoint (``checkpoint.load_path``, reference layout), or
seeded random weights with ``--synthetic``, and run the
dynamic micro-batching server against a stream of single-dialogue requests.

    python -m mer_tpu_torch.serve --synthetic --requests N [--max-batch 64]
        [--max-wait-ms 5] [--int8] [--device cuda|cpu]

The request stream is ``src/serve.py``'s: ``np.random.default_rng(1234)``,
dialogue lengths Poisson(9.3) clipped to 1..33. The first ``--max-batch``
requests warm a throwaway server before the timed run. ``--int8`` serves
the int8 engine (``serving/quant.py``) over the f32 weights. Prints one
``online serving: {json}`` report line and returns the report.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mer_tpu_torch.core import CONFIG_PATH, compute_dtype, length_buckets, load_config
from mer_tpu_torch.serving import OnlineServer
from mer_tpu_torch.serving.engine import DTYPE_LABEL, build_model, host_predict_fn, resolve_device


def request_stream(n: int, d: int, seed: int = 1234) -> list[tuple[np.ndarray, np.ndarray]]:
    """MELD-test-shaped single-dialogue requests of [u, d] text and audio rows."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        u = max(1, min(33, int(rng.poisson(9.3))))
        reqs.append((rng.normal(size=(u, d)).astype(np.float32),
                     rng.normal(size=(u, d)).astype(np.float32)))
    return reqs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mer_tpu_torch.serve")
    ap.add_argument("--config", default=CONFIG_PATH)
    ap.add_argument("--synthetic", action="store_true",
                    help="seeded random weights instead of a checkpoint")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--requests", type=int, default=280, help="request count (MELD test = 280 dialogues)")
    ap.add_argument("--int8", action="store_true", help="serve the int8 engine")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    config = load_config(args.config)
    checkpoint = None
    if not args.synthetic:
        checkpoint = os.path.abspath(str(config.checkpoint.load_path))
        if not os.path.exists(checkpoint):
            raise FileNotFoundError(f"Checkpoint not found at {checkpoint}")
    model = build_model(config, device, checkpoint=checkpoint, dtype=torch.float32 if args.int8 else None)
    predict = host_predict_fn(model, device, int8=args.int8)
    reqs = request_stream(args.requests, int(config.model.TEXT.embedding_size))
    server_args = dict(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                       length_buckets=length_buckets(config))

    with OnlineServer(predict, **server_args) as warm:
        for f in [warm.submit(t, a) for t, a in reqs[: args.max_batch]]:
            f.result(timeout=1200)

    with OnlineServer(predict, **server_args) as server:
        t0 = time.perf_counter()
        futures = [server.submit(t, a) for t, a in reqs]
        n_utt = sum(len(f.result(timeout=1200)) for f in futures)
        dt = time.perf_counter() - t0
        stats = server.stats.snapshot()

    report = {
        "mode": "int8" if args.int8 else DTYPE_LABEL[compute_dtype(config)],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dialogues_per_s": len(reqs) / dt,
        "utterances_per_s": n_utt / dt,
        **stats,
    }
    print("online serving:", json.dumps(report))
    return report


if __name__ == "__main__":
    main()
