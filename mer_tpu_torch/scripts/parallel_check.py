"""The port's parallelism across cards, held against one process.

    torchrun --nproc-per-node 4 -m mer_tpu_torch.scripts.parallel_check [--config PATH] [--device cuda|cpu]

Each rank joins the process group (NCCL on ``cuda:LOCAL_RANK``, gloo on the
CPU) and runs, on a world of 4:

1. three fusion steps (the config's width, dropout 0, f32) on a dp 2 x tp 2
   mesh and on dp 4 with ZeRO-1, against the same three steps that rank 0
   ran alone first on its card: the losses within ``F32_TOL``, the weights
   by :func:`weight_check` (within ``F32_TOL`` but for a share of strays
   where Adam turned a near-zero gradient's step around), ZeRO-1's
   optimizer bytes a rank a quarter of one process's (up to 10% more: the
   tensors no axis of which divides by 4, and the step counters, stay
   whole);
2. ring attention over an sp group of 4 (``batch_isend_irecv`` hops) at
   wav2vec2-base width, [2, 12, 4500, 64] with padding that fills a shard,
   f32 and bf16, forward and backward, against the plain full attention on
   rank 0 (:func:`ring_errors`, the limits of ``chip_smoke.py``'s phase 6m);
3. three RoBERTa-base text fine-tune steps (batches of 16 at the 256
   bucket, f32) pipelined at pp 2 x dp 2 (dropout 0: the dp ranks would draw
   masks of their own) and at pp 4 (dropout on), 4 microbatches, against
   the same steps in one process with the same per-(layer, microbatch)
   seeds (:func:`fe_pp_steps`): the losses within ``F32_TOL``, the weights
   by :func:`weight_check`; each step's time on rank 0 is printed.

Rank 0 prints one JSON line a check and the card's name and power limit;
any check that fails raises on every rank (the results are broadcast).

``chip_smoke.py``'s phase 6m runs the same steps (:func:`fusion_steps`),
weight rule and ring comparison on one card, two ranks over gloo and a
local ring, and its phase 6n :func:`fe_pp_steps` at pp 2 (text and
wav2vec2, bf16); the CPU tests hold the weight rule against planted faults.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from mer_tpu_torch.core import CONFIG_PATH, length_buckets, load_config
from mer_tpu_torch.data import DeviceFusionBatcher, SyntheticFusionDataset
from mer_tpu_torch.models import M2FNet, init_random_
from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.ops.ring_attention import ring_attention
from mer_tpu_torch.parallel import full_state_dict, initialize_distributed, local_device, make_mesh, tensor_parallel_
from mer_tpu_torch.parallel.mesh import Mesh
from mer_tpu_torch.train import Solver

STEPS = 3
RING_SHAPE = (2, 12, 4500, 64)
F32_TOL = 1e-5  # two ranks against one process in f32, losses and weights: reduction order alone
# weights beyond F32_TOL that a correct run may have, a share of those held, by compute dtype. Adam moves a weight
# whose gradient is near 0 at some step by up to the learning rate either way, so a change of rounding (tp's
# row-parallel sums; bf16) turns a few steps around. chip_smoke.py's phase 6m on an H100 (two ranks, the config's
# width, lr 5e-5): f32 dp 2 0 of 86.2 M weights, tp 2 3,765 (4.4e-5); bf16 dp 2 1.5e-3, tp 2 3.1e-3. A rank that
# skips a step or a wrong gradient moves most weights by more than F32_TOL (the CPU tests plant both)
STRAY_SHARE = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
RING_F32_REL = 1e-4  # ring against the plain full attention in f32, of the plain version's largest |value|
# bf16 out: each block's out is K1's (within (2^-8 + n 2^-23) T_t + ulp / 2 of exact), rounded once more after the
# merge; the block outs' half ulps weigh at most 2^-8 T, so against the plain version (within (2^-8 + S 2^-23) T +
# ulp / 2) the ring stays within sum_bound(sides=RING_BF16_SIDES) + one ulp of the larger value
RING_BF16_SIDES = 3
RING_BF16_REL = 2e-2  # bf16 gradients, of the plain version's largest |value| (chip_smoke's ATTENTION_BF16_REL)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """bf16's spacing at |x|: 2^(e - 7) for |x| in [2^e, 2^(e + 1))."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def sum_bound(plain_fn, q, k, v, mask, seed=None, rate: float = 0.0, sides: int = 2) -> torch.Tensor:
    """The sums' part of a bf16 attention forward's rounding bound
    (``chip_smoke.py``'s ``FWD_BF16_ELEMENTWISE`` note): ``sides`` x (2^-8 +
    Sk 2^-23) T, f32, with T = sum_j |P_ij D_ij v_jd| from the plain version
    on |v| in f32 (P unrounded)."""
    terms = plain_fn(q.float(), k.float(), v.float().abs(), mask, seed, rate)[0]
    return sides * (2.0 ** -8 + k.shape[2] * 2.0 ** -23) * terms


def bf16_out_excess(got, want, sums: torch.Tensor) -> float:
    """Largest excess of a bf16 attention forward's ``got`` over its limit
    against ``want`` (<= 0 passes): the sums' part ``sums`` (:func:`sum_bound`)
    plus one ulp of the larger of the two values, element by element."""
    a, b = got.float(), want.float()
    return ((a - b).abs() - sums - bf16_ulp(torch.maximum(a.abs(), b.abs()))).max().item()


def fusion_steps(config, mesh: Mesh, device, count=contextlib.nullcontext):
    """STEPS fusion steps on the synthetic train split's first global batches
    from the seeded weights, this rank's part of ``mesh``: (losses, whole
    weights on the host, optimizer bytes a rank, what ``count()`` yielded
    around the steps)."""
    seed = int(config.get_path("tpu.seed", 0))
    data = SyntheticFusionDataset(n_dialogues=200, seed=0, d_text=int(config.model.TEXT.embedding_size),
                                  d_audio=int(config.model.AUDIO.embedding_size))
    batches = list(DeviceFusionBatcher(data, batch_size=int(config.train.data_loader.batch_size), shuffle=True,
                                       seed=seed, buckets=length_buckets(config), sort_by_length=True,
                                       device=device))[:STEPS]
    model = init_random_(M2FNet.from_config(config.model), torch.Generator().manual_seed(seed))
    solver = Solver(tensor_parallel_(model, mesh).to(device), config, mesh=mesh)
    state = solver.init_state(STEPS)
    with count() as counted:
        losses = [solver.train_epoch(state, [b])[1] for b in batches]
    opt = state.optimizer
    nbytes = opt.moment_bytes() if hasattr(opt, "moment_bytes") else \
        sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values() if torch.is_tensor(v))
    weights = full_state_dict(model, mesh) if mesh.size > 1 else model.state_dict()
    return losses, {k: v.float().cpu() for k, v in weights.items()}, nbytes, counted


# phase 6n and the four-card pp rows: steps, batch, microbatches of the text and wav2vec2 fine-tune runs
PP_RUNS = {"text": (3, 16, 4), "wav2vec2": (2, 4, 2)}
PP_TEXT_WIDTH, PP_W2V_SAMPLES = 256, 48000  # the 256 token bucket; 3 s clips


def fe_pp_batches(kind: str) -> list[dict]:
    """The seeded batches of :func:`fe_pp_steps`: text [16, 256] token ids
    (64-256 real tokens a row, the hash tokenizer's id range), wav2vec2 [4,
    48000] int16 waveforms of 1.5-3 s; labels 0-6."""
    steps, batch, _ = PP_RUNS[kind]
    rng = np.random.default_rng(11)
    out = []
    for i in range(steps):
        label = rng.integers(0, 7, batch).astype(np.int32)
        if kind == "text":
            real = rng.integers(64, PP_TEXT_WIDTH + 1, (batch, 1))
            mask = (np.arange(PP_TEXT_WIDTH)[None, :] < real).astype(np.int32)
            ids = (rng.integers(3, 50265, (batch, PP_TEXT_WIDTH)) * mask + (1 - mask)).astype(np.int32)
            ids[:, 0] = 0
            out.append({"idx": np.arange(batch), "text": ids, "attention_mask": mask, "emotion": label})
        else:
            lengths = rng.integers(PP_W2V_SAMPLES // 2, PP_W2V_SAMPLES + 1, batch).astype(np.int32)
            audio = (rng.normal(size=(batch, PP_W2V_SAMPLES)) * 3000).clip(-32768, 32767).astype(np.int16)
            audio[np.arange(PP_W2V_SAMPLES)[None, :] >= lengths[:, None]] = 0
            out.append({"idx": np.arange(batch), "audio": audio, "lengths": lengths, "emotion": label})
    return out


def fe_pp_steps(kind: str, mesh: Mesh, device, dtype: torch.dtype, *, dropout: bool = True,
                remat: bool | str = False, count=contextlib.nullcontext):
    """``PP_RUNS[kind]`` fine-tune steps of the base-width TextERC or AudioERC
    (seeded weights, ``FESolver`` from the fine-tune phase on) with the
    encoder pipelined over ``mesh`` (in one process at pp 1: the same
    microbatches and per-(layer, microbatch) dropout seeds): (losses, whole
    weights on the host, each step's seconds, what ``count()`` yielded
    around the steps)."""
    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.data.text_fe import text_batch_to_inputs
    from mer_tpu_torch.data.wav2vec2_fe import w2v_batch_to_inputs
    from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
    from mer_tpu_torch.feature_extractors.fe_common import build_pp, pipelined_logits
    from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH
    from mer_tpu_torch.models.roberta import RobertaConfig, text_erc_from_seed
    from mer_tpu_torch.models.wav2vec2 import Wav2Vec2Config, audio_erc_from_seed
    from mer_tpu_torch.train.fe_solver import FESolver

    _, _, microbatches = PP_RUNS[kind]
    rates = {} if dropout else {"hidden_dropout": 0.0, "attention_dropout": 0.0}
    if kind == "text":
        model = text_erc_from_seed(0, RobertaConfig(**rates), dtype)
        path, backbone, to_inputs = TEXT_CONFIG_PATH, "roberta", text_batch_to_inputs
    else:
        model = audio_erc_from_seed(0, Wav2Vec2Config(**rates), dtype)
        path, backbone, to_inputs = W2V_CONFIG_PATH, "wav2vec2", w2v_batch_to_inputs
    config = load_config(path)
    warmup = {"solver__finetuning__warmup_epochs": 0} if "frozen" in config.solver else {"solver__warmup_epochs": 0}
    config = config.override(solver__num_frozen_epochs=0, checkpoint__save_checkpoint=False, **warmup)
    args = types.SimpleNamespace(pp_microbatches=microbatches, remat=bool(remat),
                                 remat_policy=remat if isinstance(remat, str) else None)
    fn = build_pp(args, model, mesh, config) if mesh.pp > 1 else pipelined_logits(model, mesh, microbatches, remat)
    solver = FESolver(model.to(device), config, batch_to_inputs=to_inputs, backbone_key=backbone, mesh=mesh,
                      pp_logits_fn=fn)
    batches = fe_pp_batches(kind)
    state = solver.init_state(len(batches))
    losses, seconds = [], []
    with count() as counted:
        for b in batches:
            torch.cuda.synchronize(device) if device.type == "cuda" else None
            t0 = time.perf_counter()
            losses.append(solver.train_epoch(state, [b], 0)[1])  # ends in a device-to-host fetch
            seconds.append(time.perf_counter() - t0)
    weights = solver._whole_state_dict()
    return losses, {k: v.float().cpu() for k, v in weights.items()}, seconds, counted


def softmax_blind(name: str) -> bool:
    """``nn.MultiheadAttention``'s packed q, k, v bias: its middle third, the
    key bias, moves every score of a query by the same amount, which softmax
    takes out, so its gradient is zero to rounding."""
    return name.endswith("in_proj_bias")


def weight_check(got: dict, want: dict, stray_share: float, tol: float = F32_TOL) -> dict:
    """Weights after the steps (``got``) against the one-process run's
    (``want``): every weight but the key biases (:func:`softmax_blind`)
    within ``tol``, but for at most ``stray_share`` of them (see
    ``STRAY_SHARE``). Returns ``excess`` (the weights beyond ``tol`` less
    those allowed: <= 0 passes), their count and the number held, the
    largest difference and the three leaves with the most weights beyond."""
    beyond, held, max_diff = {}, 0, 0.0
    for name, w in want.items():
        d = (got[name].float() - w.float()).abs()
        if softmax_blind(name):
            third = d.shape[0] // 3
            d = torch.cat([d[:third], d[2 * third:]])
        beyond[name], held, max_diff = int((d > tol).sum()), held + d.numel(), max(max_diff, d.max().item())
    strays = sum(beyond.values())
    worst = sorted((n for n in beyond if beyond[n]), key=lambda n: -beyond[n])[:3]
    return {"excess": strays - stray_share * held, "beyond_tol": strays, "held": held, "max_diff": max_diff,
            "worst_leaves": {n: beyond[n] for n in worst}}


def ring_errors(got, q, k, v, g, mask) -> dict:
    """Excess over the limit (<= 0 passes) of the ring's out, dq, dk and dv
    (``got``, whole sequences) against the plain full attention on the same
    q, k, v, output gradient g and key padding mask: f32 within
    ``RING_F32_REL`` of the plain version's largest |value|; bf16 out within
    ``RING_BF16_SIDES`` x the sums' rounding bound + one ulp of the larger
    value, the gradients within ``RING_BF16_REL`` of the largest |value|."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    plain = fa.flash_attention_reference(*leaves, mask)[0]
    plain.backward(g)
    want = [plain.detach(), *(t.grad for t in leaves)]
    errs = {}
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        a32, w32 = a.float(), w.float()
        if q.dtype == torch.float32:
            errs[name] = ((a32 - w32).abs().max() - RING_F32_REL * w32.abs().max()).item()
        elif name == "out":
            sums = sum_bound(fa.flash_attention_reference, q, k, v, mask, sides=RING_BF16_SIDES)
            errs[name] = ((a32 - w32).abs() - sums - bf16_ulp(torch.maximum(a32.abs(), w32.abs()))).max().item()
        else:
            errs[name] = ((a32 - w32).abs().max() - RING_BF16_REL * w32.abs().max()).item()
    return errs


def ring_case(dtype: torch.dtype, device: torch.device, mesh: Mesh) -> dict:
    """The ring over ``mesh``'s sp group against the plain full attention
    (on the whole sequence, every rank): :func:`ring_errors`."""
    b, h, s, dh = RING_SHAPE
    gen = torch.Generator().manual_seed(7)
    q, k, v, g = ((torch.randn(b, h, s, dh, generator=gen) / 3 ** 0.5).to(device, dtype) for _ in range(4))
    mask = torch.zeros(b, s, dtype=torch.bool)
    mask[1, 3 * s // 4:] = True  # a whole shard of padding
    mask = mask.to(device)
    n, r = mesh.sp, mesh.sp_rank
    part = lambda t, axis: t.chunk(n, axis)[r].contiguous()
    leaves = [part(t, 2).requires_grad_() for t in (q, k, v)]
    out = ring_attention(*leaves, key_padding_mask=part(mask, 1), group=mesh.sp_group)
    out.backward(part(g, 2))
    got = []
    for t in (out.detach(), *(x.grad for x in leaves)):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=mesh.sp_group)
        got.append(torch.cat(parts, 2))
    return ring_errors(got, q, k, v, g, mask)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.scripts.parallel_check")
    p.add_argument("--config", default=CONFIG_PATH)
    p.add_argument("--device", default="cuda", help="cuda (default: NCCL) or cpu (gloo)")
    args = p.parse_args(argv)
    if not initialize_distributed(device=args.device) or dist.get_world_size() != 4:
        raise SystemExit("parallel_check runs on 4 ranks: torchrun --nproc-per-node 4 -m mer_tpu_torch.scripts."
                         "parallel_check")
    device = local_device(args.device)
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = "cpu" if device.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(device.index)],
        capture_output=True, text=True, check=True).stdout.strip()
    base = load_config(args.config).override(model__dropout=0.0, tpu__compute_dtype="float32")
    single = fusion_steps(base, Mesh(), device) if rank == 0 else None
    failed = []
    for name, (dp, tp, zero1) in {"dp2_tp2": (2, 2, False), "dp4_zero1": (4, 1, True)}.items():
        losses, weights, nbytes, _ = fusion_steps(base.override(tpu__zero1=zero1), make_mesh(dp=dp, tp=tp), device)
        if rank == 0:
            want_losses, want_weights, one_bytes, _ = single
            loss_diff = max(abs(a - b) for a, b in zip(losses, want_losses))
            weights_held = weight_check(weights, want_weights, STRAY_SHARE[torch.float32])
            share = nbytes / one_bytes
            ok = loss_diff <= F32_TOL and weights_held["excess"] <= 0 and (not zero1 or 1 / dp <= share <= 1.1 / dp)
            print(json.dumps({"check": f"fusion {name}", "ok": ok, "losses": losses, "one_process": want_losses,
                              "loss_diff": loss_diff, "weights": weights_held,
                              "optimizer_bytes_share": share, "card": card}), flush=True)
            if not ok:
                failed.append(name)
    mesh = make_mesh(dp=1, tp=1, sp=4)
    for dtype in (torch.float32, torch.bfloat16):
        excess = ring_case(dtype, device, mesh)
        if rank == 0:
            ok = max(excess.values()) <= 0
            print(json.dumps({"check": f"ring sp 4 {dtype}", "ok": ok, "excess": excess, "shape": RING_SHAPE,
                              "card": card}), flush=True)
            if not ok:
                failed.append(f"ring {dtype}")
    for name, pp, dropout in (("text pp2_dp2", 2, False), ("text pp4", 4, True)):
        single = fe_pp_steps("text", Mesh(), device, torch.float32, dropout=dropout) if rank == 0 else None
        losses, weights, seconds, _ = fe_pp_steps("text", make_mesh(dp=4 // pp, pp=pp), device, torch.float32,
                                                  dropout=dropout)
        if rank == 0:
            want_losses, want_weights, one_seconds, _ = single
            loss_diff = max(abs(a - b) for a, b in zip(losses, want_losses))
            held = weight_check(weights, want_weights, STRAY_SHARE[torch.float32])
            ok = loss_diff <= F32_TOL and held["excess"] <= 0
            print(json.dumps({"check": name, "ok": ok, "dropout": dropout, "losses": losses,
                              "one_process": want_losses, "loss_diff": loss_diff, "weights": held,
                              "step_seconds": seconds, "one_process_step_seconds": one_seconds,
                              "microbatches": PP_RUNS["text"][2], "card": card}), flush=True)
            if not ok:
                failed.append(name)
    verdict = [failed]
    dist.broadcast_object_list(verdict, src=0)
    dist.destroy_process_group()
    if verdict[0]:
        raise SystemExit(f"parallel_check failed: {verdict[0]}")


if __name__ == "__main__":
    sys.exit(main())
