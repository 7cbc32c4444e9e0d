"""Metric-learning solver of the mel feature extractor, stage 1c
(counterpart of ``mer_tpu/train/mel_solver.py``).

The reference loop (audio_mel/train.py:117-280): each step hard-mines a
triplet batch with the current model, embeds anchor, positive and negative,
and takes an Adam step on 20 triplet + 5 covariance + 1 variance; each epoch
ends with a hard-mined validation loss that drives early stopping (patience
10), and a resumed run restores ``min_loss_val`` and ``patience_counter``.

As in ``mer_tpu``:

- :meth:`MelSolver.init_state` first builds both splits' uint8 spectrogram
  caches on the device (kernel K5, one launch per 64 clips); every mining
  pool and triplet batch after that is a gather from them;
- with hard mining the chosen rows stay on the device
  (``mine_hard_rows_device``), and anchor, positive and negative go through
  one forward of [3B, 3, frames, mels];
- the loss and the mining distances are f32 even under bf16 autocast;
- the epoch's loss is fetched from the device once, at its end.

On a mesh (``tpu.mesh``, dp = -1 by default: every rank) every rank mines
the same triplets with its replica of the model (the miners' samplers are
seeded), takes its dp rows of the [3B] batch (3B must divide dp), and the
loss, whose triplet, variance and covariance terms span the batch, sees the
whole batch's embeddings (``parallel/data.py::gather_rows``); the Adam step
sums the gradients over dp and, under ``tpu.zero1``, keeps each rank's slice
of the moments. The ResNet has no tp splits, so tp ranks are replicas. A
BatchNorm in train mode (``bn_mode: train``) would see the rank's rows alone
and is refused on a dp mesh. Rank 0 writes the checkpoints.

``solver.async_mining`` (``mer_tpu``'s, off by default): a worker thread mines
and fetches batch k + 1 while step k runs, with the weights from before step
k's update, one step staler than the synchronous path. The optimizer writes
the model's weights in place, so the worker embeds with a snapshot, a second
extractor in eval mode whose weights are copied before each submit; on the
card it runs on a stream of its own, and the step waits on an event of that
stream before it reads the batch. As in ``mer_tpu``'s async path the miner
returns host indices and the batch is gathered from them, and the miners'
samplers are the synchronous path's, so both draw the same anchors.

With ``AUDIO.augmentation_factor > 1`` the training split keeps no device
cache: each triplet batch is decoded and augmented from the wavs
(``MelFeatureDataset.spectrogram_batch`` with a generator seeded from
(``seed``, epoch, step)). The per-epoch visualisation is not ported.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mer_tpu_torch.mining import TripletMiner
from mer_tpu_torch.objectives import make_embedding_loss
from mer_tpu_torch.parallel.data import barrier, data_parallel, gather_rows
from mer_tpu_torch.parallel.mesh import Mesh
from mer_tpu_torch.train.checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from mer_tpu_torch.train.solver import (TrainState, accumulate_and_step, grad_accum_steps, optimizer_from_config,
                                       schedule_from_config)
from mer_tpu_torch.utils import RunLogger


class MelSolver:
    """Args:
        model: the ResNet18 extractor (f32 weights) on the training device.
        config: the mel pipeline config (config_audio_mel.yaml schema).
        data_train, data_val: :class:`~mer_tpu_torch.data.MelFeatureDataset`.
        seed: seeds the miners' samplers (train ``seed``, validation ``seed + 1``).
        compute_dtype: float32, or bfloat16 for autocast over the f32 weights.
        mesh: this rank's place in a dp mesh; None for one process.
    """

    def __init__(self, model: torch.nn.Module, config, data_train, data_val, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32, mesh: Mesh | None = None):
        self.mesh = mesh or Mesh()
        if self.mesh.dp > 1 and getattr(model, "bn_mode", "eval") == "train":
            raise NotImplementedError("bn_mode 'train' on a dp mesh: BatchNorm would see a rank's rows alone")
        self.zero1 = bool(config.get_path("tpu.zero1", False)) and self.mesh.dp > 1
        self.model = model
        self.config = config
        self.data_train = data_train
        self.data_val = data_val
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.device = next(model.parameters()).device
        self.logger = RunLogger()
        self.loss_fn = make_embedding_loss(config)
        self.mining_type = str(config.get_path("solver.mining_type", "hard"))
        self.batch_size = int(config.train.data_loader.batch_size)
        self.val_batch_size = int(config.val.data_loader.batch_size)
        self.accum = grad_accum_steps(config.solver)
        self.async_mining = bool(config.get_path("solver.async_mining", False))
        self._miners: dict[int, TripletMiner] = {}  # one per dataset; their samplers advance across epochs
        self._snapshot: torch.nn.Module | None = None  # async mining's copy of the weights
        self._mining_model: torch.nn.Module | None = None  # the snapshot, while an async epoch runs
        self._schedule = None
        self._epoch = 0  # seeds the epoch's augmentation draws

    def _autocast(self):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    @torch.no_grad()
    def embed(self, spectrograms: torch.Tensor, model: torch.nn.Module | None = None) -> torch.Tensor:
        """[n, 3, frames, mels] -> [n, D] f32 embeddings, eval mode (by
        ``model``, the solver's by default)."""
        model = model or self.model
        model.eval()
        with self._autocast():
            return model(spectrograms)

    # -- setup -------------------------------------------------------------------

    def init_state(self) -> TrainState:
        """Build the spectrogram caches, then the optimizer at step 0."""
        for ds in (self.data_train, self.data_val):
            if ds.device_cache is None:
                ds.build_device_cache()
        steps_per_epoch = len(self.data_train) // self.batch_size
        self._schedule = schedule_from_config(self.config.solver, steps_per_epoch)
        make = lambda groups: optimizer_from_config(self.config.solver, groups, steps_per_epoch)[0]
        optimizer = data_parallel(make, [{"params": list(self.model.parameters())}], self.mesh, self.zero1,
                                  self.model)
        return TrainState(self.model, optimizer)

    def _miner(self, dataset) -> TripletMiner:
        miner = self._miners.get(id(dataset))
        if miner is None:
            miner = TripletMiner(dataset.get_labels(),
                                 lambda idx: self.embed(dataset.spectrogram_batch(idx), self._mining_model),
                                 len_triplet_picking=int(self.config.solver.len_triplet_picking),
                                 seed=self.seed + len(self._miners))
            self._miners[id(dataset)] = miner
        return miner

    def _augment_generator(self, step: int) -> torch.Generator:
        """The augmentation draws of training step ``step`` of the epoch: a
        function of (seed, epoch, step), as ``mer_tpu`` folds its key."""
        words = np.random.SeedSequence([self.seed + 1, self._epoch, step]).generate_state(1, np.uint64)
        return torch.Generator().manual_seed(int(words[0]))

    def _triplet_batch(self, dataset, batch_size: int, step: int | None = None) -> torch.Tensor:
        """[3B, 3, frames, mels]: anchors, positives, negatives; training
        step ``step`` of the epoch augments where the dataset does."""
        miner = self._miner(dataset)
        if self.mining_type == "hard" and dataset.device_cache is not None:
            return dataset.spectrogram_batch(miner.mine_hard_rows_device(batch_size))
        a, p, n = miner.mine(batch_size, self.mining_type)
        generator = None if step is None else self._augment_generator(step)
        return dataset.spectrogram_batch(np.concatenate([a, p, n]), generator=generator)

    def _loss(self, spectrograms: torch.Tensor) -> torch.Tensor:
        """The loss of [3B, ...]; on a dp mesh each rank embeds its rows and
        the loss sees every rank's."""
        if self.mesh.dp > 1:
            if spectrograms.shape[0] % self.mesh.dp:
                raise ValueError(f"{spectrograms.shape[0]} triplet rows do not divide dp={self.mesh.dp}")
            spectrograms = spectrograms.chunk(self.mesh.dp)[self.mesh.dp_rank]
        with self._autocast():
            emb = self.model(spectrograms)  # f32 out
        return self.loss_fn(*gather_rows(emb.float(), self.mesh).chunk(3))  # f32, outside autocast

    # -- epochs ------------------------------------------------------------------

    def train_step(self, state: TrainState, spectrograms: torch.Tensor) -> torch.Tensor:
        """One forward of [3B, ...], backward and (every ``accum`` steps) an
        Adam update; returns the loss on the device."""
        state.model.train()
        loss = self._loss(spectrograms)
        loss.backward()
        accumulate_and_step(state, self.accum, self._schedule)
        return loss.detach()

    def train_epoch(self, state: TrainState) -> tuple[TrainState, float]:
        n_steps = len(self.data_train) // self.batch_size
        total = torch.zeros((), device=self.device)
        if self.async_mining:
            for loss in self._train_steps_async(state, n_steps):
                total += loss
        else:
            for step in range(n_steps):
                total += self.train_step(state, self._triplet_batch(self.data_train, self.batch_size, step))
        return state, total.item() / max(n_steps, 1)

    def _train_steps_async(self, state: TrainState, n_steps: int):
        """The epoch's steps with batch k + 1 mined and fetched by a worker
        thread, with the snapshot of the weights from before step k's update,
        while step k runs; yields each step's loss."""
        if self._snapshot is None:
            self._snapshot = copy.deepcopy(self.model).eval()
        snapshot = self._mining_model = self._snapshot
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def produce(step: int, copied):
            with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
                if side is not None:
                    side.wait_event(copied)
                miner = self._miner(self.data_train)
                a, p, n = miner.mine(self.batch_size, self.mining_type)
                batch = self.data_train.spectrogram_batch(np.concatenate([a, p, n]),
                                                          generator=self._augment_generator(step))
                ready = torch.cuda.Event() if side is not None else None
                if ready is not None:
                    ready.record(side)
                return batch, ready

        def submit(pool, step: int):
            with torch.no_grad():  # the weights before this step's update, on the main stream
                for mine, theirs in zip(snapshot.state_dict().values(), self.model.state_dict().values()):
                    mine.copy_(theirs)
            copied = None
            if side is not None:
                copied = torch.cuda.Event()
                copied.record()
            return pool.submit(produce, step, copied)

        with ThreadPoolExecutor(max_workers=1) as pool:
            future = submit(pool, 0)
            for step in range(n_steps):
                batch, ready = future.result()
                if ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                    batch.record_stream(torch.cuda.current_stream(self.device))
                if step + 1 < n_steps:
                    future = submit(pool, step + 1)
                yield self.train_step(state, batch)
        self._mining_model = None

    @torch.no_grad()
    def validate(self) -> float:
        self.model.eval()
        n_steps = max(len(self.data_val) // self.val_batch_size, 1)
        total = torch.zeros((), device=self.device)
        for _ in range(n_steps):
            total += self._loss(self._triplet_batch(self.data_val, self.val_batch_size))
        return total.item() / n_steps

    # -- full loop ---------------------------------------------------------------

    def fit(self, state: TrainState | None = None) -> tuple[TrainState, dict]:
        cfg = self.config
        epochs = int(cfg.solver.epochs)
        early = bool(cfg.solver.early_stopping.enabled)
        patience = int(cfg.solver.early_stopping.patience)
        restore_best = bool(cfg.solver.early_stopping.restore_best_weights)
        save_path = os.path.abspath(str(cfg.checkpoint.save_path))
        best_path = os.path.join(os.path.dirname(save_path), "best_weights.ckpt")
        save_ckpt = bool(cfg.checkpoint.save_checkpoint)
        if state is None:
            state = self.init_state()

        start_epoch, min_loss_val, patience_counter = 0, float("inf"), 0
        load_path = os.path.abspath(str(cfg.checkpoint.get("load_path", save_path)))
        if bool(cfg.checkpoint.get("load_checkpoint", False)) and os.path.exists(load_path):
            restored = load_checkpoint(load_path)
            state.model.load_state_dict(restored["model_state_dict"], strict=True)
            state.optimizer.load_state_dict(restored["optimizer_state_dict"])
            extra = restored["extra"]
            state.step = int(extra.get("step", 0))
            start_epoch = int(restored["epoch"]) + 1
            # early-stop state resume (audio_mel/train.py:143-154)
            min_loss_val = float(extra.get("min_loss_val", float("inf")))
            patience_counter = int(extra.get("patience_counter", 0))
            self.logger.print(f"Resumed from {load_path} at epoch {start_epoch}")

        history: dict[str, list] = {"loss_values": [], "val_loss_values": []}
        writer = AsyncCheckpointer()

        def snapshot(epoch: int) -> dict:
            return dict(epoch=epoch, model=state.model, optimizer=state.optimizer, mesh=self.mesh,
                        extra={"step": state.step, "min_loss_val": min_loss_val, "patience_counter": patience_counter})

        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            self._epoch = epoch
            state, loss_train = self.train_epoch(state)
            loss_val = self.validate()
            dt = time.perf_counter() - t0
            history["loss_values"].append(loss_train)
            history["val_loss_values"].append(loss_val)
            extra_epoch = snapshot(epoch)
            if save_ckpt:
                writer.save(save_path, **extra_epoch)
            lr = self._schedule((state.step - 1) // self.accum)
            self.logger.print(f"Epoch: {epoch}  Lr: {lr:.8f}  Loss: Train = [{loss_train:.3E}] - "
                              f"Val = [{loss_val:.3E}] ({dt:.1f}s)")
            if not early:
                continue
            if loss_val < min_loss_val:
                min_loss_val, patience_counter = loss_val, 0
                if restore_best:
                    writer.save(best_path, **snapshot(epoch))
                continue
            patience_counter += 1
            if patience_counter >= patience:
                self.logger.print(f"Early stopping: patience {patience} reached")
                writer.wait()
                barrier(self.mesh)  # rank 0 wrote best_path
                if restore_best and os.path.exists(best_path):
                    best = load_checkpoint(best_path)
                    state.model.load_state_dict(best["model_state_dict"], strict=True)
                    if save_ckpt:  # promote the best weights to the checkpoint
                        save_checkpoint(save_path, **{**extra_epoch, "epoch": best["epoch"]})
                    self.logger.print(f"Best model at epoch {best['epoch']} restored")
                break

        writer.wait()
        return state, history

    # -- export ------------------------------------------------------------------

    def export_embeddings(self, dataset, batch_size: int = 32) -> np.ndarray:
        """[N, D] float32 embeddings in table order (reference
        audio_mel/embeddings.py:61-80). The last batch is padded with its
        last row to ``batch_size``, so every forward has one shape; the table
        is fetched from the device once."""
        n = len(dataset)
        out = []
        for i in range(0, n, batch_size):
            idx = np.arange(i, min(i + batch_size, n))
            padded = np.concatenate([idx, idx[-1:].repeat(batch_size - len(idx))])
            out.append(self.embed(dataset.spectrogram_batch(padded))[: len(idx)])
        if not out:
            return np.zeros((0, self.model.embedding_size), np.float32)
        return torch.cat(out).cpu().numpy()
