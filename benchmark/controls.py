"""Readings that set a cell's limits: its control and its faults, on the
card at the cell's own size. The benchmark's own runs never run this.

    python3 benchmark/controls.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed and reading: ``{"cell", "seed", "kind",
"readings"}``, each reading the cell's compared numbers against the plain
float32 reference.

- ``wav2vec2-base.finetune``: ``program`` is the port's checked steps as a
  run makes them; ``control`` is the reference itself in float8 e4m3 (the
  step below the bf16 the configuration states) in the program's place,
  over the same checked steps and dropout masks; ``half_batch`` is the
  reference with half of every batch left out and the loss's mean taken
  over the rest; ``lr_high`` the reference at 1.25 times the rate. (A step
  that returns its state unchanged reads 1 on ``step_gap`` by its own
  definition: no run.)
- ``mer-meld.label``: ``program`` is the bf16 stream as the cell runs it,
  one pass; ``control`` the stream on the port's own int8 engines (its own
  path below bf16); ``control_fp8`` the plain reference itself in float8
  e4m3 in the program's place, all three models (the int8 engines keep
  LayerNorm, residuals and softmax in bf16 and read the text embeddings
  and the fusion logits within three times the program's gaps);
  ``altered`` the bf16 stream with one utterance's fusion logits replaced by
  its neighbour's where they are produced. ``--kinds`` reads only some.

Besides the judged numbers each line carries a few that no limit judges
(``diag_*``), to show where a control or fault lands.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

from benchmark.harness.cell import RunContext, load_cell, set_cache_dirs  # noqa: E402


def finetune_readings(ctx) -> list[tuple[str, dict]]:
    import copy
    import statistics

    import numpy as np

    from benchmark.drivers import finetune as ft
    from benchmark.harness import checks
    from benchmark.harness.window import free_device
    from benchmark.reference.common import FP8

    cfg = ctx.cell.config
    run_ = ft.start(ctx)
    prog, pool, checked = run_.prog, run_.pool, run_.checked
    del run_
    free_device(ctx.device)
    ref = ft.reference_steps(cfg, ctx.seed, pool, checked, ctx.device)

    median = statistics.median(ref["grad_norms"].values())
    moved = {k for k, g in ref["grad_norms"].items() if g >= 1e-3 * median}

    def read(got: dict) -> dict:
        out = ft.readings(got, ref)
        out.update(diag_grad_med=statistics.median(checks.leaf_gaps(got["grad_norms"], ref["grad_norms"]).values()),
                   diag_step_med=statistics.median(
                       checks.leaf_gaps(got["change_norms"], ref["change_norms"], keep=moved).values()),
                   diag_loss1_gap=checks.scalar_gap(got["losses"][:1], ref["losses"][:1]))
        return out

    halved = []
    for b in checked:
        emotion = np.array(b["emotion"])
        emotion[len(emotion) // 2:] = -1
        halved.append({**b, "emotion": emotion})
    high = copy.deepcopy(cfg)
    high["fine_tune"]["lr"] *= 1.25
    return [("program", read(prog)),
            ("control", read(ft.reference_steps(cfg, ctx.seed, pool, checked, ctx.device, FP8))),
            ("half_batch", read(ft.reference_steps(cfg, ctx.seed, pool, halved, ctx.device))),
            ("lr_high", read(ft.reference_steps(high, ctx.seed, pool, checked, ctx.device)))]


def label_readings(ctx, kinds=("program", "control", "altered", "control_fp8")) -> list[tuple[str, dict]]:
    from benchmark.drivers import label as lb
    from benchmark.harness import checks
    from benchmark.harness.window import free_device
    from benchmark.reference.common import FP8

    got, split = {}, lb.Split(ctx.seed, ctx.cell.traffic, ctx.cell.config["roberta"])
    for kind, engine in (("program", "bf16"), ("control", "int8"), ("altered", "bf16")):
        if kind not in kinds:
            continue
        split, pipeline, capture = lb.build(ctx, engine, split)
        if kind == "altered":  # where the logits are produced, so the stream carries the altered answer on
            def misrouted(module, args, logits):
                logits = logits.clone()
                logits[0, 0] = logits[0, 1]
                return logits

            pipeline.m.fusion_model.register_forward_hook(misrouted)
        answered = pipeline.run(split.batches, split.table(), device_resident=True)["n_utterances"]
        got[kind] = (lb.program_rows(split, capture.outputs, len(split.labels)), len(split.labels) - answered)
        del pipeline, capture
        free_device(ctx.device)
    want = lb.reference_rows(ctx.cell.config, ctx.seed, split, ctx.device)
    if "control_fp8" in kinds:
        got["control_fp8"] = (lb.reference_rows(ctx.cell.config, ctx.seed, split, ctx.device, FP8), 0)

    out = []
    for kind, (rows, missing) in got.items():
        readings = lb.readings(rows, want, missing)
        for key in ("text", "audio", "logits"):
            gaps = checks.row_gaps(rows[key], want[key]).sort().values
            readings[f"diag_{key}_gap"] = float(gaps[-1])
            readings[f"diag_{key}_med"] = float(gaps.median())
        readings["diag_logits_top"] = float(gaps[-max(len(gaps) // 100, 1):].mean())
        out.append((kind, readings))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/controls.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", help="mer-meld.label: read only these kinds")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("controls run on the card", file=sys.stderr)
        return 2
    read = {"finetune": finetune_readings, "label": label_readings}[cell.traffic["driver"]]
    extra = {"kinds": tuple(args.kinds)} if args.kinds and cell.traffic["driver"] == "label" else {}
    for seed in args.seeds:
        for kind, readings in read(RunContext(cell, seed, 0.0, False, "cuda", _T_START), **extra):
            print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
