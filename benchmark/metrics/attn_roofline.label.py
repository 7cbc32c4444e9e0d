"""The attention's share of its roofline: the least time of every call of
``ops.attention.dot_product_attention`` in the traced window (and of its
backward where it trained) over the device time of all the kernels those
calls and their backward nodes launched."""

import importlib


def read(layers: dict):
    roof = importlib.import_module("benchmark.harness.roofline")
    calls = layers.get("calls", {}).get("attention")
    if not calls:
        return None
    return roof.share_pct(layers, "attention", roof.attention_bound_s(calls))
