"""Fine-tuning steps of the wav2vec2 extractor, a closed loop through the
port's own solver and batcher.

Set-up builds one ``FESolver`` over an ``AudioERC`` whose weights the
benchmark made on the device from the seed, and the port's
``Wav2Vec2Batcher`` over a pool of MELD-shaped clips (``ClipPool``). It
drives that solver through ``train_epoch`` one batch at a time until every
width of the ladder has run once (the warm-up); the first
``checked_steps`` of these are the steps the reference follows. The window
hands the same solver a feed that stops at the deadline, inside one
``train_epoch`` call, whose loss fetch ends it.

The pool's batches are those the shuffled batcher forms (clips sorted by
length, batches of ``batch_size``), but in a fixed order that spreads the
widths evenly, so every seed gives the window the same widths in the same
order; the seed picks which clips fill a batch, their samples and labels.
"""

from __future__ import annotations

import collections
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.harness import checks, meld
from benchmark.harness.cell import RunRecord
from benchmark.harness.flops import wav2vec2_train_flops
from benchmark.harness.ops import OpRecorder
from benchmark.harness.weights import seeded_weights
from benchmark.harness.window import Window, free_device, memory_peak, synchronize
from benchmark.reference import train as ref_train
from benchmark.reference import wav2vec2 as ref_w2v
from benchmark.reference.common import FP32, float32_exact
from benchmark.reference.dropout import StepMasks

WEIGHT_STREAM = 0


class ClipPool:
    """The port's dataset interface (``sample_rate``, ``len``, ``labels``,
    ``waveform_lengths``, ``waveform``) over seeded clips in batch order."""

    sample_rate = meld.SAMPLE_RATE

    def __init__(self, seed: int, n_clips: int, batch_size: int, ladder: list[int], durations: dict):
        rng = meld.seeded_rng(seed, 10)
        by_length = rng.permutation(n_clips)  # the clip of the i-th shortest duration
        lengths = np.empty(n_clips, np.int64)
        lengths[by_length] = meld.seconds_to_samples(meld.duration_quantiles(n_clips, durations))
        labels = rng.integers(0, meld.NUM_CLASSES, size=n_clips)
        groups = [by_length[i: i + batch_size] for i in range(0, n_clips, batch_size)]
        full = [g for g in groups if len(g) == batch_size]
        widths = [meld.bucket(int(lengths[g].max()), ladder) for g in full]
        ordered = [full[i] for i in meld.interleave_by_class(widths)] + [g for g in groups if len(g) < batch_size]
        self.clip_ids = np.concatenate(ordered)
        self.lengths = lengths[self.clip_ids]
        self.labels = labels[self.clip_ids]
        self.widths = sorted({meld.bucket(int(lengths[g].max()), ladder) for g in groups})
        self.bank = meld.SignalBank(seed)

    def __len__(self) -> int:
        return len(self.clip_ids)

    def waveform_lengths(self) -> np.ndarray:
        return self.lengths

    def waveform(self, k: int) -> np.ndarray:
        return self.bank.clip(int(self.clip_ids[k]), int(self.lengths[k]))


class Feed:
    """The batcher's batches, epoch after epoch; ``until(deadline)`` yields
    them while the host clock is before ``deadline`` and notes each."""

    def __init__(self, batcher):
        self.batcher, self.it, self.taken = batcher, iter(batcher), []

    def next(self) -> dict:
        batch = next(self.it, None)
        if batch is None:
            self.it = iter(self.batcher)
            batch = next(self.it)
        self.taken.append(batch)
        return batch

    def until(self, deadline: float):
        self.handed = []
        while time.perf_counter() < deadline:
            self.handed.append(time.perf_counter())
            yield self.next()


def tpu_seed(seed: int) -> int:
    """The solver's ``tpu.seed``, from which it seeds each step's dropout."""
    return int(seed) & 0xFFFFFFFF


def solver_config(cfg: dict, seed: int):
    from mer_tpu_torch.core.config import Config

    t = cfg["fine_tune"]
    return Config({
        "solver": {"loss_fn": "CE", "balance_classes": False, "num_frozen_epochs": t["num_frozen_epochs"],
                   "finetuning": {"lr": t["lr"], "weight_decay": t["weight_decay"],
                                  "warmup_epochs": t["warmup_epochs"]},
                   "frozen": {"lr": t["frozen_lr"], "weight_decay": t["frozen_weight_decay"]},
                   "epochs": 1, "early_stopping": {"enabled": False, "patience": 3, "restore_best_weights": False}},
        "tpu": {"compute_dtype": t["compute_dtype"], "seed": tpu_seed(seed)},
        "wandb": {"enabled": False},
    })


def model_config(cfg: dict):
    from mer_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    fields = Wav2Vec2Config.__dataclass_fields__
    return Wav2Vec2Config(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in fields})


def reference_batch(pool: ClipPool, batch: dict, device: str) -> tuple[torch.Tensor, ...]:
    """The batch's inputs rebuilt from the pool (clip ids and the ladder),
    not from the program's arrays: waves [B, width], lengths, labels."""
    idx, width = np.asarray(batch["idx"]), batch["audio"].shape[1]
    wave = np.zeros((len(idx), width), np.float32)
    for r, k in enumerate(idx):
        w = pool.waveform(int(k))[:width]
        wave[r, : len(w)] = w
    labels = pool.labels[idx].astype(np.int64)
    real = len(idx) - int((np.asarray(batch["emotion"]) == -1).sum())
    labels[real:] = -1
    return (torch.from_numpy(wave).to(device), torch.from_numpy(np.minimum(pool.lengths[idx], width)).to(device),
            torch.from_numpy(labels).to(device))


def reference_steps(cfg: dict, seed: int, pool: ClipPool, batches: list[dict], device: str, prec=FP32) -> dict:
    """The reference's losses, first gradients' leaf norms and the leaf
    norms of the change after len(batches) AdamW steps from the seed's
    weights (the warm-up counted in the pool's batches an epoch), step n
    under the dropout masks of step n of the run's seed."""
    float32_exact()
    t = cfg["fine_tune"]
    compute_dtype = getattr(torch, t["compute_dtype"])
    spec = ref_w2v.param_spec(cfg)
    params = {k: v.clone().requires_grad_(True) for k, v in seeded_weights(spec, seed, WEIGHT_STREAM, device).items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = ref_train.AdamW(params, weight_decay=t["weight_decay"], betas=tuple(t["betas"]), eps=t["eps"])
    warmup = t["warmup_epochs"] * -(-len(pool) // t["batch_size"])
    losses, grad_norms = [], None
    for step, batch in enumerate(batches):
        wave, lengths, labels = reference_batch(pool, batch, device)
        masks = StepMasks(tpu_seed(seed), step, cfg["hidden_dropout"], cfg["attention_dropout"], compute_dtype, device)
        loss = ref_train.cross_entropy(ref_w2v.logits(params, cfg, wave, lengths, prec, masks), labels)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = checks.leaf_norms(grads)
        opt.step(grads, ref_train.constant_with_warmup(t["lr"], warmup, opt.t))
        del grads, loss
    change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def readings(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers a limit judges: ``loss_gap``, the worst relative gap of
    the checked steps' losses; ``grad_gap``, the worst leaf's gap of the
    first gradient's norm; ``step_gap``, the worst leaf's gap of the
    change's norm after the checked steps. Leaves whose reference gradient
    is under a thousandth of the median leaf's (a key's bias under softmax)
    move by round-off alone and are left out of the change."""
    median = statistics.median(ref["grad_norms"].values())
    moved = {k for k, g in ref["grad_norms"].items() if g >= 1e-3 * median}
    return {"loss_gap": checks.scalar_gap(prog["losses"], ref["losses"]),
            "grad_gap": max(checks.leaf_gaps(prog["grad_norms"], ref["grad_norms"]).values()),
            "step_gap": max(checks.leaf_gaps(prog["change_norms"], ref["change_norms"], keep=moved).values())}


@dataclass
class Started:
    """A run after its set-up: the solver and its state, the feed, the
    program's readings of the checked steps and those steps' batches."""

    solver: object
    state: object
    epoch: int
    pool: ClipPool
    feed: Feed
    prog: dict
    checked: list
    check_s: float


def start(ctx) -> Started:
    """Set-up: one ``FESolver`` over the seed's weights and its batcher, then
    the warm-up through ``train_epoch``, a batch at a time, until every width
    has run; the first ``checked_steps`` steps are read for the check (the
    losses, the first gradient from AdamW's first moment, the change)."""
    from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, w2v_batch_to_inputs
    from mer_tpu_torch.models.wav2vec2 import AudioERC
    from mer_tpu_torch.train.fe_solver import FESolver

    cfg, traffic, device, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    t = cfg["fine_tune"]
    ladder = [int(s * meld.SAMPLE_RATE) for s in traffic["seconds_buckets"]]
    pool = ClipPool(seed, traffic["pool_clips"], t["batch_size"], ladder, traffic["durations"])

    with torch.device(device):
        model = AudioERC(model_config(cfg), getattr(torch, t["compute_dtype"]))
    spec = ref_w2v.param_spec(cfg)
    model.load_state_dict(seeded_weights(spec, seed, WEIGHT_STREAM, device))
    solver = FESolver(model, solver_config(cfg, seed), batch_to_inputs=w2v_batch_to_inputs, backbone_key="wav2vec2")
    batcher = Wav2Vec2Batcher(pool, t["batch_size"], shuffle=False, seconds_buckets=tuple(traffic["seconds_buckets"]))
    state = solver.init_state(len(batcher))
    epoch = int(t["num_frozen_epochs"])  # the first fine-tune epoch
    params = dict(model.named_parameters())

    feed, seen, prog = Feed(batcher), set(), {"losses": []}
    check_s = 0.0
    n_checked = int(traffic["checked_steps"])
    while seen != set(pool.widths) or len(feed.taken) < n_checked:
        batch = feed.next()
        seen.add(batch["audio"].shape[1])
        state, loss = solver.train_epoch(state, [batch], epoch)
        t_check = time.perf_counter()
        if len(feed.taken) <= n_checked:
            prog["losses"].append(loss)
        if len(feed.taken) == 1:
            opt = state.finetune.optimizer
            moments = {n: opt.state.get(p, {}).get("exp_avg") for n, p in params.items()}  # none if no step ran
            prog["grad_norms"] = {n: 0.0 if m is None else float(m.norm()) / (1.0 - t["betas"][0])
                                  for n, m in moments.items()}
            del moments, opt
        if len(feed.taken) == n_checked:
            start_weights = seeded_weights(spec, seed, WEIGHT_STREAM, device)
            prog["change_norms"] = {n: float((p.detach() - start_weights[n]).norm()) for n, p in params.items()}
            del start_weights
        check_s += time.perf_counter() - t_check
    synchronize(device)
    return Started(solver, state, epoch, pool, feed, prog, feed.taken[:n_checked], check_s)


def run(ctx) -> RunRecord:
    cfg, traffic, device, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    recorder = OpRecorder().install_port_entries() if ctx.trace else None
    run_ = start(ctx)
    solver, state, feed = run_.solver, run_.state, run_.feed

    feed.taken = []
    with Window(ctx, recorder) as win:
        setup_s = win.t0 - ctx.t_start - run_.check_s
        state, _ = solver.train_epoch(state, feed.until(win.deadline), run_.epoch)
    widths = [b["audio"].shape[1] for b in feed.taken]
    real = [np.asarray(b["emotion"]) != -1 for b in feed.taken]
    clips = int(sum(r.sum() for r in real))
    flops = sum(wav2vec2_train_flops(cfg, int(n)) for b, r in zip(feed.taken, real)
                for n in np.minimum(np.asarray(b["lengths"])[r], b["audio"].shape[1]))
    peak = memory_peak(device)
    layers = win.layers(flops=flops, peak_flops_dtype=cfg["fine_tune"]["compute_dtype"])
    if recorder is not None:
        recorder.uninstall()

    prog, pool, checked = run_.prog, run_.pool, run_.checked
    del solver, state, run_
    free_device(device)
    ref = reference_steps(cfg, seed, pool, checked, device)
    judged = checks.judged(readings(prog, ref), traffic["limits"])
    notes = [f"losses: {prog['losses']!r} against {ref['losses']!r}",
             f"window: {len(widths)} steps, widths {dict(sorted(collections.Counter(widths).items()))!r}"]
    gaps = np.diff(feed.handed)
    notes.append(f"host seconds between batches: mean {gaps.mean():.4f}, p10 {np.quantile(gaps, 0.1):.4f}, "
                 f"p90 {np.quantile(gaps, 0.9):.4f}")
    return RunRecord(setup_s=setup_s, end_to_end={"train_utt_per_s": clips / win.seconds}, attempted=clips, failed=0,
                     memory_peak_bytes=peak, checks=judged, counters=win.counters, layers=layers, notes=notes)
