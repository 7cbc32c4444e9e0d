"""The share of the traced window in which no operation ran on the card:
100 x (1 - busy / window), busy the union of the device's kernel, copy and
fill intervals."""


def read(layers: dict):
    if not layers.get("window_s"):
        return None
    return 100.0 * (1.0 - layers["busy_s"] / layers["window_s"])
