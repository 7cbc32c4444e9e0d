"""The window's model FLOPs (every matrix product and convolution that the
inputs need at their own lengths, not the padded ones; a training step's
backward at twice its forward) over the traced window's seconds, as a
percentage of the card's dense bf16 peak (989 TFLOP/s at 700 W; the run's
power limit is in the result's device entry)."""

from benchmark.harness.flops import PEAK


def read(layers: dict):
    if not layers.get("window_s") or not layers.get("flops"):
        return None
    return 100.0 * layers["flops"] / layers["window_s"] / PEAK[layers["peak_flops_dtype"]]
