"""Host ranges around the port's op entries, opened from the benchmark's own
files, and the port's launch counters.

:class:`OpRecorder` replaces an entry point (``mer_tpu_torch.ops.attention.
dot_product_attention``, ``mer_tpu_torch.ops.w2v_conv.layer0_gn`` and
``conv_stack_fused``) wherever the port's modules hold it, by a wrapper
that runs the entry inside ``record_function("bench.op.<entry>")`` and
notes the call's shapes; for a differentiable call it notes the autograd
node's name, whose ``evaluate_function`` range holds the backward's
kernels. Only traced runs install it.
"""

from __future__ import annotations

import sys
from collections import defaultdict


def _port_modules():
    return [m for name, m in list(sys.modules.items()) if m is not None and name.split(".")[0] == "mer_tpu_torch"]


class OpRecorder:
    RANGE = "bench.op."

    def __init__(self):
        self.calls: dict[str, list[dict]] = defaultdict(list)
        self.backward_nodes: dict[str, set[str]] = defaultdict(set)
        self.recording = False
        self._undo: list[tuple[object, str, object]] = []

    def wrap(self, module_name: str, attr: str, entry: str, describe) -> None:
        """Wrap ``module_name.attr`` wherever the port holds it; ``describe``
        maps the call's arguments to the dict noted for it."""
        import importlib

        import torch

        original = getattr(importlib.import_module(module_name), attr)
        recorder = self

        def wrapped(*args, **kwargs):
            if not recorder.recording:
                return original(*args, **kwargs)
            with torch.profiler.record_function(OpRecorder.RANGE + entry):
                out = original(*args, **kwargs)
            note = describe(*args, **kwargs)
            note["grad"] = bool(getattr(out, "requires_grad", False))
            recorder.calls[entry].append(note)
            if getattr(out, "grad_fn", None) is not None:
                recorder.backward_nodes[entry].add(out.grad_fn.name())
            return out

        wrapped.__dict__ = original.__dict__  # the entry's own counters (``.launches``) stay one
        for module in _port_modules():
            for name, value in list(vars(module).items()):
                if value is original:
                    setattr(module, name, wrapped)
                    self._undo.append((module, name, original))

    def install_port_entries(self) -> "OpRecorder":
        dtype = lambda t: str(t.dtype).removeprefix("torch.")
        self.wrap("mer_tpu_torch.ops.attention", "dot_product_attention", "attention",
                  lambda q, k, v, **kw: {"b": q.shape[0], "h": q.shape[1], "sq": q.shape[2], "sk": k.shape[2],
                                         "dh": q.shape[3], "dtype": dtype(q)})
        self.wrap("mer_tpu_torch.ops.w2v_conv", "layer0_gn", "w2v_layer0",
                  lambda wave, *a, dtype=None, **kw: {"b": wave.shape[0], "n": wave.shape[1],
                                                      "dtype": str(dtype).removeprefix("torch.")})
        self.wrap("mer_tpu_torch.ops.w2v_conv", "conv_stack_fused", "w2v_tail",
                  lambda x, *a, **kw: {"b": x.shape[0], "t0": x.shape[1], "dtype": dtype(x)})
        return self

    def uninstall(self) -> None:
        for module, name, original in reversed(self._undo):
            setattr(module, name, original)
        self._undo.clear()


def launch_counters() -> dict:
    """``{"<module>.<function>": {"launches": n, "routes": {...}}}`` of every
    function of the port's op modules that counts its kernel's launches."""
    out = {}
    for module in _port_modules():
        if not module.__name__.startswith("mer_tpu_torch.ops."):
            continue
        for name, value in list(vars(module).items()):
            launches = getattr(value, "launches", None)
            if callable(value) and isinstance(launches, int):
                entry = {"launches": launches}
                routes = getattr(value, "routes", None)
                if isinstance(routes, dict):
                    entry["routes"] = dict(routes)
                out[f"{module.__name__.removeprefix('mer_tpu_torch.ops.')}.{name}"] = entry
    return out


def counter_delta(before: dict, after: dict) -> dict:
    out = {}
    for key, now in after.items():
        was = before.get(key, {"launches": 0, "routes": {}})
        entry = {"launches": now["launches"] - was["launches"]}
        if "routes" in now:
            entry["routes"] = {r: n - was.get("routes", {}).get(r, 0) for r, n in now["routes"].items()}
        if entry["launches"]:
            out[key] = entry
    return out
