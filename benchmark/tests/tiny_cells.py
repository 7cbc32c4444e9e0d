"""The two cells at a size the CPU runs in seconds: narrow models, short
clips and few utterances, with the cells' own drivers, references and
checks. ``cell(name, **traffic)`` gives the cell with traffic overrides."""

from __future__ import annotations

import copy
import time

from benchmark.harness.cell import Cell, load_cell, run_cell

W2V = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
       "conv_dim": [16, 16, 16, 16, 16, 16, 16], "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4}
ROBERTA = {"vocab_size": 300, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 64}
M2FNET = {"dim_feedforward": 2048, "AUDIO": {"embedding_size": 32, "n_head": 2, "n_encoder_layers": 2},
          "TEXT": {"embedding_size": 32, "n_head": 2, "n_encoder_layers": 2},
          "FAM": {"embedding_size": 32, "n_head": 2, "n_layers": 2}, "CLASSIFIER": {"hidden_size": 32}}
SHORT = {"log_mean": -2.3, "log_sigma": 0.5, "clip": [0.05, 0.25]}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(name: str, **traffic) -> Cell:
    c = load_cell(name)
    if name == "wav2vec2-base.finetune":
        c.config = _merge(c.config, {**W2V, "fine_tune": {"batch_size": 4, "lr": 1e-3, "compute_dtype": "float32"}})
        c.traffic = _merge(c.traffic, {"pool_clips": 30, "durations": SHORT, "seconds_buckets": [0.1, 0.2, 0.25],
                                       "trace_seconds": 1})
    else:
        c.config = _merge(c.config, {"wav2vec2": W2V, "roberta": ROBERTA, "m2fnet": M2FNET,
                                     "serve": {"compute_dtype": "float32", "fusion_weights_dtype": "float32"}})
        c.traffic = _merge(c.traffic, {"dialogues": 6, "utterances": 30, "max_dialogue": 12, "words": [2, 20],
                                       "durations": SHORT, "seconds_buckets": [0.1, 0.2, 0.25],
                                       "token_buckets": [16, 32, 64], "utterance_batch": 8,
                                       "trace_seconds": 1})
    c.traffic = _merge(c.traffic, traffic)
    return c


def run(c: Cell, seed: int = 12345678901, seconds: float = 0.5, trace: bool = False):
    return run_cell(c, seed, seconds, trace, "cpu", time.perf_counter())
