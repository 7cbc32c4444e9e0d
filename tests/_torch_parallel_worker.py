"""One gloo rank of the port's parallel tests (not a test module itself).

    python tests/_torch_parallel_worker.py JOB RANK WORLD PORT WORKDIR

``fusion`` (2 ranks): fusion training steps from ``WORKDIR/fusion_inputs.npz``
(the weights, three global batches, class weights) and
``WORKDIR/fusion.yaml`` on a dp = 2 mesh, a tp = 2 mesh, dp = 2 with ZeRO-1
(also a checkpoint after two steps) and dp = 2 with DDP's per-rank mean (a
planted fault), and the prefetcher's shards of a 7-row batch at dp = 2
(``prefetch_<rank>.npz``); rank 0 writes ``fusion_<case>.npz``: the global loss of
each step, the first step's summed gradients and the weights after three
steps, whole, and each rank the bytes of its optimizer state.

Then, in the same ranks, three fine-tune steps of a narrow text extractor
(``FESolver``; its classifier's ``out_proj`` is row-parallel with a replicated
input) at tp = 2 and at dp = 2 with ZeRO-1, and two steps of the mel
extractor (``MelSolver``: the triplet loss over the whole batch's
embeddings) at dp = 2 with ZeRO-1, each from :func:`fe_setup` /
:func:`mel_setup`, which the tests also run in one process; rank 0 writes
``<case>.npz``: the losses and the weights.

``ring`` (4 ranks): ring attention over gloo at sp = 2 (two rings of two
ranks) and sp = 4 on ``WORKDIR/ring_inputs.npz``; the first ring's rank 0
writes ``ring_sp<n>.npz``: the output and the gradients of q, k and v,
gathered whole.

``pipeline`` (4 ranks): from ``WORKDIR/pipe_inputs.npz``, ``pipeline_apply``
over a stack of four dense layers at pp 4 and at pp 2 x dp 2, M = pp and 2 pp,
with and without a mask (each rank writes ``pipe_<case>_r<rank>.npz``: its
dp rows' output, its layers' gradients and, on stage 0, its input's); the
narrow text and wav2vec2 classifiers' pipelined logits at pp 2 x dp 2
(``logits_<kind>_r<rank>.npz``); their train-mode logits and gradients with
dropout on at pp 4 and pp 2 (``dropout_<kind>_pp<n>.npz``); and three
``FESolver`` text steps at pp 2 x dp 2, with and without ``--remat dots``
(:func:`pp_fe_setup`; rank 0 writes ``fe_pp2_dp2<_remat>.npz``).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mer_tpu_torch.core import load_config  # noqa: E402
from mer_tpu_torch.data.text_fe import text_batch_to_inputs  # noqa: E402
from mer_tpu_torch.feature_extractors.audio_mel import MEL_CONFIG_PATH  # noqa: E402
from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH  # noqa: E402
from mer_tpu_torch.models import mel_extractor_from_seed  # noqa: E402
from mer_tpu_torch.models.roberta import RobertaConfig, text_erc_from_seed  # noqa: E402
from mer_tpu_torch.train.fe_solver import FESolver  # noqa: E402
from mer_tpu_torch.train.mel_solver import MelSolver  # noqa: E402
from mer_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: E402
from mer_tpu_torch.models import M2FNet  # noqa: E402
from mer_tpu_torch.ops.ring_attention import ring_attention  # noqa: E402
from mer_tpu_torch.parallel import full_state_dict, initialize_distributed, make_mesh, tensor_parallel_  # noqa: E402
from mer_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from mer_tpu_torch.parallel.tensor import gather_tp  # noqa: E402
from mer_tpu_torch.train import solver as solver_module  # noqa: E402
from mer_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402

FUSION_CASES = {"dp2": (2, 1, False), "tp2": (1, 2, False), "dp2_zero1": (2, 1, True), "dp2_mean": (2, 1, False)}


def ddp_mean(numerator, denominator, mesh):
    """The planted fault: each rank's own mean, the summed gradients divided
    by dp (DDP's average of per-rank means)."""
    loss = numerator / denominator.clamp_min(1e-12) / mesh.dp
    logged = loss.detach().clone()
    dist.all_reduce(logged, group=mesh.dp_group)
    return loss, logged


def fusion(rank, workdir):
    inputs = np.load(os.path.join(workdir, "fusion_inputs.npz"))
    weights = {k[2:]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith("w.")}
    batches = [{key: inputs[f"b{i}.{key}"] for key in ("text", "audio", "padding_mask", "emotion")} for i in range(3)]
    dp = make_mesh(dp=2)
    seven = {k: v[:7] for k, v in batches[0].items()}
    for shard in DevicePrefetcher([seven], device="cpu", sharding=(dp.dp_group, dp.dp_rank)):
        np.savez(os.path.join(workdir, f"prefetch_{rank}.npz"), **{k: t.numpy() for k, t in shard.items()})
    for case, (dp, tp, zero1) in FUSION_CASES.items():
        mesh = make_mesh(dp=dp, tp=tp)
        config = load_config(os.path.join(workdir, "fusion.yaml")).override(tpu__zero1=zero1)
        model = M2FNet.from_config(config.model)
        model.load_state_dict(weights, strict=True)
        tensor_parallel_(model, mesh)
        solver = solver_module.Solver(model, config, class_weights=inputs["class_weights"], mesh=mesh)
        state = solver.init_state(steps_per_epoch=3)
        inner = getattr(state.optimizer, "inner", state.optimizer)
        names = [n for n, _ in model.named_parameters()]
        grads = {}

        def record(optimizer, args, kwargs):
            if not grads and not zero1:  # the first step's gradients, summed over dp
                grads.update({n: p.grad.detach().clone() for n, p in zip(names, model.parameters())})

        inner.register_step_pre_hook(record)
        losses = []
        patch = ddp_mean if case == "dp2_mean" else solver_module.global_ratio
        original, solver_module.global_ratio = solver_module.global_ratio, patch
        try:
            for i, batch in enumerate(batches):
                state, loss = solver.train_epoch(state, [batch])
                losses.append(loss)
                if zero1 and i == 1:
                    save_checkpoint(os.path.join(workdir, "zero1_step2.pth"), epoch=0, model=model,
                                    optimizer=state.optimizer, extra={"step": state.step}, mesh=mesh)
        finally:
            solver_module.global_ratio = original
        params = full_state_dict(model, mesh)
        full_grads = {n: gather_tp(n, g, mesh) for n, g in grads.items()}
        moment_bytes = torch.tensor([float(state.optimizer.moment_bytes() if hasattr(state.optimizer, "moment_bytes")
                                           else sum(v.numel() * v.element_size() for st in inner.state.values()
                                                    for v in st.values() if torch.is_tensor(v)))])
        every = [torch.zeros(1) for _ in range(dist.get_world_size())]
        dist.all_gather(every, moment_bytes)
        if rank == 0:
            np.savez(os.path.join(workdir, f"fusion_{case}.npz"), losses=np.array(losses),
                     moment_bytes=np.array([float(t) for t in every]),
                     **{f"p.{n}": t.numpy() for n, t in params.items()},
                     **{f"g.{n}": t.numpy() for n, t in full_grads.items()})
        dist.barrier()


TEXT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40, hidden_dropout=0.0, attention_dropout=0.0)  # ranks draw masks of their own
FE_CASES = {"fe_tp2": (1, 2, False), "fe_dp2_zero1": (2, 1, True)}


def fe_setup(mesh):
    """(solver, batches) of the narrow text extractor: fine-tune from the
    first step (no frozen epoch, no warmup: the first update at lr 0, then
    two at the fine-tune lr), three batches of 4 utterances."""
    config = load_config(TEXT_CONFIG_PATH).override(solver__num_frozen_epochs=0, solver__warmup_epochs=0,
                                                    solver__finetuning_lr=1e-4, tpu__zero1=mesh.dp > 1)
    model = tensor_parallel_(text_erc_from_seed(0, RobertaConfig(**TEXT)), mesh)
    solver = FESolver(model, config, batch_to_inputs=text_batch_to_inputs, backbone_key="roberta", mesh=mesh,
                      class_weights=np.array([0.5, 1.0, 2.0, 1.5, 3.0, 0.7, 1.2], np.float32))
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        mask = (np.arange(16)[None, :] < rng.integers(4, 17, (4, 1))).astype(np.int32)
        batches.append({"idx": np.arange(4), "text": (rng.integers(3, 100, (4, 16)) * mask + (1 - mask)).astype(np.int32),
                        "attention_mask": mask, "emotion": np.array([rng.integers(0, 7), rng.integers(0, 7), -1, 2],
                                                                    np.int32)})
    return solver, batches


class _Cached:
    """What ``MelSolver.init_state`` reads of a dataset whose cache is built."""

    device_cache = ()

    def __len__(self):
        return 64


def mel_setup(mesh):
    """(solver, triplet batches [12, 3, 64, 32]) of the mel extractor."""
    config = load_config(MEL_CONFIG_PATH).override(tpu__zero1=mesh.dp > 1)
    solver = MelSolver(mel_extractor_from_seed(0), config, _Cached(), _Cached(), mesh=mesh)
    gen = torch.Generator().manual_seed(4)
    return solver, [torch.randn(12, 3, 64, 32, generator=gen) for _ in range(2)]


def fe_and_mel(rank, workdir):
    for case, (dp, tp, zero1) in FE_CASES.items():
        mesh = make_mesh(dp=dp, tp=tp)
        solver, batches = fe_setup(mesh)
        state = solver.init_state(3)
        _, loss = solver.train_epoch(state, batches, 0)
        params = full_state_dict(solver.model, mesh)
        if rank == 0:
            np.savez(os.path.join(workdir, f"{case}.npz"), losses=np.array([loss]),
                     **{f"p.{n}": t.numpy() for n, t in params.items()})
        dist.barrier()
    mesh = make_mesh(dp=2)
    solver, batches = mel_setup(mesh)
    state = solver.init_state()
    losses = [solver.train_step(state, b).item() for b in batches]
    if rank == 0:
        np.savez(os.path.join(workdir, "mel_dp2_zero1.npz"), losses=np.array(losses),
                 **{f"p.{n}": t.detach().numpy() for n, t in solver.model.state_dict().items()})
    dist.barrier()


def ring(rank, workdir):
    inputs = np.load(os.path.join(workdir, "ring_inputs.npz"))
    for sp, dp in ((2, 2), (4, 1)):
        mesh = make_mesh(dp=dp, tp=1, sp=sp)
        shard = lambda a, axis: torch.from_numpy(np.ascontiguousarray(np.split(a, sp, axis)[mesh.sp_rank]))
        q, k, v = (shard(inputs[n], 2).requires_grad_() for n in ("q", "k", "v"))
        mask, g = shard(inputs["mask"], 1), shard(inputs["g"], 2)
        out = ring_attention(q, k, v, key_padding_mask=mask, group=mesh.sp_group)
        out.backward(g)
        whole = {}
        for name, t in (("out", out.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            parts = [torch.empty_like(t) for _ in range(sp)]
            dist.all_gather(parts, t.contiguous(), group=mesh.sp_group)
            whole[name] = torch.cat(parts, 2).numpy()
        if rank == 0:
            np.savez(os.path.join(workdir, f"ring_sp{sp}.npz"), **whole)
        dist.barrier()


class Dense(torch.nn.Module):
    """``tanh(x @ w + b)``, rows where ``mask`` is True passed through."""

    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = torch.nn.Parameter(torch.as_tensor(w)), torch.nn.Parameter(torch.as_tensor(b))

    def forward(self, x, mask=None):
        y = torch.tanh(x @ self.w + self.b)
        return y if mask is None else torch.where(mask[..., None], x, y)


def dense_stack(inputs) -> torch.nn.ModuleList:
    return torch.nn.ModuleList(Dense(w, b) for w, b in zip(inputs["w"], inputs["b"]))


PIPE_CASES = [(pp, dp, m, masked) for pp, dp in ((4, 1), (2, 2)) for m in (pp, 2 * pp) for masked in (False, True)]
PP_TEXT = dict(TEXT, num_hidden_layers=4, hidden_dropout=0.1, attention_dropout=0.1)
PP_W2V = dict(conv_dim=(32,) * 7, hidden_size=32, num_hidden_layers=4, num_attention_heads=4, intermediate_size=64,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def pp_models(inputs, dropout: bool = False):
    """The narrow TextERC and AudioERC on the weights in ``inputs``."""
    from mer_tpu_torch.models.roberta import TextERC
    from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config

    rates = {} if dropout else {"hidden_dropout": 0.0, "attention_dropout": 0.0}
    text = TextERC(RobertaConfig(**{**PP_TEXT, **rates}))
    text.load_state_dict({k[5:]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith("text.")})
    audio = AudioERC(Wav2Vec2Config(**{**PP_W2V, **rates}))
    audio.load_state_dict({k[6:]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith("audio.")})
    return {"text": text, "audio": audio}


def pp_logits(kind, model, mesh, inputs, rows=slice(None), **kwargs):
    from mer_tpu_torch.parallel.pp_forward import audio_erc_logits_pp, text_erc_logits_pp

    if kind == "text":
        args = torch.from_numpy(inputs["ids"][rows]).long(), torch.from_numpy(inputs["mask"][rows])
        return text_erc_logits_pp(model, mesh, *args, **kwargs)
    args = torch.from_numpy(inputs["waves"][rows]), torch.from_numpy(inputs["lengths"][rows])
    return audio_erc_logits_pp(model, mesh, *args, **kwargs)


def dropout_step(kind, mesh, inputs):
    """Train-mode pipelined logits and synced gradients, dropout on, the
    step's seed words (0, 7); the whole batch on every rank, M = 4."""
    from mer_tpu_torch.models import set_attention_generator
    from mer_tpu_torch.parallel.pipeline import keep_stage_layers_, sync_replicated_grads
    from mer_tpu_torch.parallel.pp_forward import replicated_owner, stack_of
    from mer_tpu_torch.utils import seed_dropout

    model = pp_models(inputs, dropout=True)[kind].train()
    set_attention_generator(model, seed_dropout(0))
    keep_stage_layers_(stack_of(model)[0], mesh)
    logits = pp_logits(kind, model, mesh, inputs, seed=(0, 7), microbatches=4)
    (logits.float() * torch.from_numpy(inputs["logit_g"])).sum().backward()
    sync_replicated_grads(model, mesh, replicated_owner(model))
    return logits.detach(), {n: p.grad for n, p in model.named_parameters()}


def pp_fe_setup(mesh, remat: str | None = None):
    """(solver, batches): the text extractor's three steps of :func:`fe_setup`
    (dropout 0) on 4 layers, pipelined over ``mesh`` (M = 2) when its pp is
    above 1."""
    import types

    from mer_tpu_torch.feature_extractors.fe_common import build_pp

    config = load_config(TEXT_CONFIG_PATH).override(solver__num_frozen_epochs=0, solver__warmup_epochs=0,
                                                    solver__finetuning_lr=1e-4, tpu__zero1=mesh.dp > 1)
    model = text_erc_from_seed(0, RobertaConfig(**{**PP_TEXT, "hidden_dropout": 0.0, "attention_dropout": 0.0}))
    args = types.SimpleNamespace(pp_microbatches=2, remat=remat is not None, remat_policy=remat)
    solver = FESolver(model, config, batch_to_inputs=text_batch_to_inputs, backbone_key="roberta", mesh=mesh,
                      class_weights=np.array([0.5, 1.0, 2.0, 1.5, 3.0, 0.7, 1.2], np.float32),
                      pp_logits_fn=build_pp(args, model, mesh, config))
    return solver, fe_setup(Mesh())[1]


def pipeline(rank, workdir):
    from mer_tpu_torch.parallel.pipeline import keep_stage_layers_, make_pp_mesh, pipeline_apply
    from mer_tpu_torch.parallel.pp_forward import stack_of

    inputs = np.load(os.path.join(workdir, "pipe_inputs.npz"))
    for pp, dp, m, masked in PIPE_CASES:
        mesh = make_pp_mesh(pp, dp)
        rows = slice(mesh.dp_rank * 8 // dp, (mesh.dp_rank + 1) * 8 // dp)
        layers = keep_stage_layers_(dense_stack(inputs), mesh)
        x = torch.from_numpy(inputs["x"][rows]).requires_grad_()
        extra = torch.from_numpy(inputs["xmask"][rows]) if masked else None
        out = pipeline_apply(layers, x, lambda layer, h, *e: layer(h, *e), mesh, microbatches=m, extra=extra)
        (out * torch.from_numpy(inputs["g"][rows])).sum().backward()
        own = {f"{name}{i}": getattr(layers[i], name).grad.numpy() for i in range(4)
               if isinstance(layers[i], Dense) for name in ("w", "b")}
        np.savez(os.path.join(workdir, f"pipe_pp{pp}_m{m}_{masked}_r{rank}.npz"), out=out.detach().numpy(),
                 dx=x.grad.numpy() if mesh.pp_rank == 0 else np.zeros(0), **own)
        dist.barrier()
    mesh = make_pp_mesh(2, 2)
    rows = slice(mesh.dp_rank * 4, (mesh.dp_rank + 1) * 4)
    for kind, model in pp_models(inputs).items():
        keep_stage_layers_(stack_of(model)[0], mesh)
        with torch.no_grad():
            logits = pp_logits(kind, model.eval(), mesh, inputs, rows, microbatches=2)
        np.savez(os.path.join(workdir, f"logits_{kind}_r{rank}.npz"), logits=logits.numpy())
    for pp in (4, 2):
        mesh = make_pp_mesh(pp, 4 // pp)
        for kind in ("text", "audio"):
            logits, grads = dropout_step(kind, mesh, inputs)
            layers_prefix = stack_of(pp_models(inputs)[kind])[1]
            if mesh.dp_rank == 0:
                np.savez(os.path.join(workdir, f"dropout_{kind}_pp{pp}_r{rank}.npz"), logits=logits.numpy(),
                         **{f"g.{n}": g.numpy() for n, g in grads.items()
                            if mesh.pp_rank == 0 or n.startswith(layers_prefix)})
            dist.barrier()
    for remat in (None, "dots"):
        mesh = make_pp_mesh(2, 2)
        solver, batches = pp_fe_setup(mesh, remat)
        state = solver.init_state(3)
        _, loss = solver.train_epoch(state, batches, 0)
        params = solver._whole_state_dict()
        if rank == 0:
            np.savez(os.path.join(workdir, f"fe_pp2_dp2{'_remat' if remat else ''}.npz"), losses=np.array([loss]),
                     **{f"p.{n}": t.numpy() for n, t in params.items()})
        dist.barrier()


def main():
    job, rank, world, port, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    initialize_distributed(init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, device="cpu")
    try:
        for part in {"fusion": (fusion, fe_and_mel), "ring": (ring,), "pipeline": (pipeline,)}[job]:
            part(rank, workdir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
