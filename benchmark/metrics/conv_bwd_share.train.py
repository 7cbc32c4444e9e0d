"""The share of the card's busy time in the backward of the convolutions
(autograd's ``ConvolutionBackward`` nodes: the conv frontend's seven layers
and the positional convolution)."""


def read(layers: dict):
    trace = layers.get("trace")
    if trace is None or not layers.get("busy_s"):
        return None
    conv = trace.range_device_s(lambda name: name.startswith("autograd::engine::evaluate_function: Convolution"))
    return 100.0 * conv / layers["busy_s"] if conv > 0 else None
