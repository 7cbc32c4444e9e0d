#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's fusion serving and training paths at the full width of
the default config (``src/config.yaml``: 768-wide, 8 heads, 6 + 6 encoder
layers, 5 FAM layers; seeded random weights), the mel feature extractor's
training and export at its only shape (ResNet18 over [3, 1001, 128] log-mel
images of 10 s clips, 300-wide embeddings; seeded random weights) and the
wav2vec2 feature extractor's export, evaluation and fine-tuning at the full
width and depth of ``Wav2Vec2Config.base()`` (7 convs of 512 channels, 12
layers of 768, 12 heads; seeded random weights), on clips up to 10 s and on
clips of 45-90 s (up to 4,499 frames: the long-sequence attention kernels K3
and K4), its conv frontend's profile entry point, the attention bench and the
lowering probes P, and the text feature extractor's fine-tuning, evaluation
and export at the full width and depth of RoBERTa-base (12 layers of 768, 12
heads of 64, vocabulary 50,265; seeded random weights, the hash tokenizer),
the end-to-end stream over both audio branches, both wires and the int8
engines, the int8 legs of offline evaluation and online serving, and data
and tensor parallelism, ZeRO-1 and ring attention (two ranks on the card),
and fails on any fault. The script runs itself under ``PYTHONHASHSEED=0``, so
that two runs see the same tokens:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build every CUDA kernel from ``mer_tpu_torch/csrc``, one nvcc per source,
   all started together (the design probe ``probe_gn_grid_sync`` too, so that
   ``preflight`` finds every source built);
3. hold each kernel against its plain PyTorch version on the card at the
   dialogue buckets (B=32), f32 and bf16, dropout off and on (K1 the
   forward, K2 the backward: at head dims 96 and 50 their one-pass stacked
   designs, each K1 and K2 check holding the design its C entry took, the
   same bits from two calls, the template on the same inputs held to the
   same limits and timed beside K1 and beside K2 at head dim 50), K1 bf16
   and its plain version
   each against an f64 witness over 16 seeds a shape (``rounding_witness``),
   the bf16 limit shown to fail K1 on rolled key slices,
   and read the kernels' dropout masks off exactly (K1's and K2's also at Dh
   96 and 50, their stacked designs in bf16 and f32); K5 at [32, 64, 47 and 3 clips,
   1001 or 37 frames, 400 taps], on the ``unfold`` view of reflect-padded
   clips and on materialised frames; time kernel, plain version and library call (K5's: the
   torch.stft -> abs -> baddbmm -> log chain); K7 and K6 at [32, 16 and 2
   clips, every wave bucket 32,000 .. 160,000 samples] and at a ragged [2,
   40,005] (library: the F.conv1d + F.group_norm + F.gelu chain, and six
   F.conv1d + F.gelu), each also the same bits from two calls; K6's bf16
   limit shown to fail its output against the plain version of its input
   shifted by one frame; K8 on the stock layer-0 conv output at [32, 31999,
   512], [2, 12799, 512] and [3, 301, 512] with 7 valid rows (library:
   F.group_norm + F.gelu); K1 at the wav2vec2 encoder's shapes [32 or 2, 12, S, S, 64],
   S = 99 .. 499, and at RoBERTa's batches of 32 on every rung of the token
   ladder (S = 64 .. 512), with padded keys (clip masks: each row keeps
   L >= S / 2 keys);
3b. K3 at Sk = 4,097, 8,192, 16,384 and K4 at 2,049, 4,499, 8,192 ([2, 1, S,
   S, 64] and [2, 1, S, S, 50]), f32 and bf16, with a key mask, with a fully
   masked batch element and with dropout 0.1, against their plain versions
   (K4 at Dh 64 is its Hopper design, in bf16 and in 3xTF32 in f32, at Dh 50
   the older one: every K4 check also holds the design its C entry took),
   every other batch element attending to most of its keys; the seams K1 |
   K3 and K2 | K4 at the dispatch's thresholds (``STREAM_THRESHOLD``,
   ``BWD_FUSED_MAX`` keys) on the same inputs ([2, 2, S, S, 64]); the bf16
   limits shown to fail a K1, K2, K3 and K4 that read the wrong key tiles;
   K3's and K4's dropout masks read off exactly in f32 and bf16 (K4's at Dh
   64, over three 64-row windows of g; K3's and K1's also at Dh 64, over two
   64-key windows of v: K3's Hopper design in bf16, the 3xTF32 forward of
   both in f32); K3 also the same bits from two calls at every case; the
   kernels SDPA's f32 forward runs at [32, 12, 499, 499, 64] (the
   profiler's names: the f32 yardstick of K1 and K3); K4's f32 launch split
   into its prep, dq and dk/dv kernels' device time (late in the run a CUDA
   profile has recorded no device activity on the H100, so both run here);
4. offline evaluation: ``mer_tpu_torch.test.main`` on the synthetic MELD test
   split (280 dialogues, batch 32), with and without ``--serving-batch 512``;
   17 attention launches per forward; f32 logits through the kernel against
   the plain attention over both batchings; bf16-vs-f32 agreement, utterances
   per second, and one forward's kernel count and device-time breakdown;
5. online serving: ``mer_tpu_torch.serve.main(--synthetic --requests N)``,
   N = 64 (one micro-batch) and N = 280 (a burst of the test split's
   dialogue count, several micro-batches);
6. training: ``mer_tpu_torch.train.main(--synthetic --epochs 2)`` with the
   checkpoints in a temporary directory: 17 K1 (dropout 0.4) and 17 K2
   launches per step, every K2 launch through its stacked design (as on
   every counted path: ``main_path_run`` checks each launch's design), 17 K1
   launches per validation batch, finite losses,
   the last epoch's train loss below the first, and a checkpoint that
   ``mer_tpu_torch.test --checkpoint`` reads; an f32, dropout-0 parity leg
   (3 steps through the kernels against 3 through the plain attention);
   training utterances per second and one step's eager vs device time with
   its kernel breakdown; the tools on that checkpoint (``python -m
   mer_tpu_torch.tools``): ``inspect`` (epoch, step, parameter count),
   ``export-torch`` to a ``.pth`` that ``mer_tpu_torch.test --checkpoint``
   reads with the checkpoint's own logits (bit for bit) and metrics, and
   ``preflight`` (the card, ``nvcc`` and every kernel source of ``csrc/``
   built ``[ok]``; exit 1, the card's machine having no MELD);
6p. the mel variant of the fusion model (300-d audio embeddings in 6 heads
   of 50, ``src/config.yaml`` overridden in a temporary file):
   ``mer_tpu_torch.train.main(--synthetic --epochs 1)`` and one offline
   evaluation of its checkpoint, counted: per step 6 K1 and 6 K2 launches at
   head dim 50 and 11 of each at 96, each through its stacked design;
6b. mel training: a synthetic MELD root from ``mer_tpu_torch.data.synthetic``
   (100 train and 20 dev dialogues; the test split MELD-shaped, 2,608
   clips), ``mer_tpu_torch.feature_extractors.audio_mel.train`` for 2 epochs
   at batch 32 (hard mining from pools of 96, one [96, 3, 1001, 128] f32
   forward a step): one K5 launch per cache chunk of 64 and none in a step,
   finite losses, a checkpoint; triplet clips per second and one step's
   eager vs device time; an f32 parity leg (caches through K5 and through
   the plain version differ by at most one uint8 step; 3 free steps on the
   same rows from the K5 cache and from one built by a float64 rfft chain,
   losses within 1e-4; 3 steps from the K5 and the plain caches, each from the
   same weights and Adam state, losses within 1e-4);
6c. mel export: ``...audio_mel.embeddings`` from that checkpoint: K5
   launches = one per batch of 32 of each split; [N, 300] finite unit-norm tables (1e-5) that ``load_embeddings``
   reads back; clips per second on the test split and one batch's eager vs
   device time; the shipped ``DEBUG.visualize`` (3D) plots the val split on
   the card: the printed silhouette and the card's ``utils/viz.py::silhouette``
   of the table against a float64 numpy recomputation on the host (1e-6; the
   printed value to its 4 places), the PNG decoded through its chunks and
   ``zlib`` to 800 x 800 RGB with every class's disc colour present, the
   HTML holding every point; the visualisation's seconds, and
   ``project_embeddings`` of 1,109 seeded clustered embeddings of width 300
   (MELD's dev split) in 3D timed;
6d. wav2vec2 export: a seeded ``AudioERC`` checkpoint, then
   ``mer_tpu_torch.feature_extractors.audio_wav2vec2.embeddings`` over the
   three splits of that root in batches of 32 (per batch: K7 once, K6 once,
   K1 12 times; no other kernel), [N, 768] finite tables that
   ``load_embeddings`` reads back; clips per second on the test split in
   bf16 and in f32 (the f32 export a counted path: K6's, K7's and K1's f32
   launches) and one batch's eager vs device time with the shares of K6, K7
   and K1, in bf16 and in f32; an f32 leg
   that embeds the same batches through the kernels and through the plain
   versions;
6e. wav2vec2 evaluation: ``...audio_wav2vec2.test`` on the 2,608-clip test
   split at the config's batch of 2 (1,304 forwards), finite loss and metrics;
6f. the conv frontend's profile entry point,
   ``mer_tpu_torch.scripts.profile_w2v_conv 32 10 --fused --l0fused --gnfused``
   in bf16: each variant's numerics against the stock stack (5e-2 of its
   largest value: two bf16 pipelines rounded after every layer) and its ms per
   batch; per call K7 + K6 (fused), K7 (l0fused), K8 (gnfused);
6g. text: ``...text.train --epochs 3`` (2 frozen + 1 fine-tune) on the same
   root, whose utterances are 2-100 words long (token buckets 64, 128, 256),
   at the config's batch of 16 in bf16: K1 12 times per forward, the backward
   (K4: every bucket lies above ``BWD_FUSED_MAX``) never in a frozen epoch and
   12 times per fine-tune step; the frozen epochs change the
   head alone, the first fine-tune update (lr 0) changes nothing, the second
   changes every tensor whose step exceeds its rounding; then ``...text.test``
   and ``...text.embeddings`` (three finite [N, 768] tables, every row written);
   utterances per second, the bucket histogram, one profiled training step;
6h. wav2vec2 fine-tuning: ``...audio_wav2vec2.train --epochs 3`` at the
   config's ``tpu.batch_size_override`` of 16, on a second synthetic root
   whose train and dev clips are 0.5-10 s long (all five wave buckets, so K1
   and K4 at S = 99 .. 499): K7 and K6 once per frozen step
   and per validation batch and never in a fine-tune step (the stock
   differentiable convolutions run there), K1 12 per forward, K4 12 per
   fine-tune step; an f32 leg of 2 frozen + 2 fine-tune steps through the
   kernels against the plain versions (losses within 1e-4); clips per second,
   one profiled fine-tune step, peak device memory;
6i. wav2vec2 on long clips: a root of one 45-90 s clip a dialogue (8 train,
   4 dev, 4 test), the dataset at ``max_seconds=90`` and the batcher at
   ``seconds_buckets=(60, 90)`` (2,999 and 4,499 frames). The export of the
   test clips in batches of 2 (per batch K7 1, K6 1 and 12 attention forwards:
   K3 at 90 s, K1 at 60 s), in bf16 and in f32 (``--f32``: the 4 test clips
   fill two 90 s batches, so 24 K3 f32 launches at 4,499 keys; clips per
   second); 4 fine-tune steps at batch 2, bf16, attention
   dropout 0.1 (per step 12 forwards and 12 K4; no K2, K7, K6); clips per
   second, one profiled step (eager, device, idle share), peak memory; one
   f32 step's loss and gradients through K3 and K4 against the plain versions;
6j. the attention bench entry (``mer_tpu_torch.scripts.bench_attention``,
   every shape, f32 and bf16, then ``--crossover``: K1 | K3 and K2 | K4 on
   the same inputs at the fusion buckets and up to each threshold, bf16,
   dropout 0 and 0.1); 6k. the probes P
   (``mer_tpu_torch.scripts.probe_strided``), each exact, counted on their own
   (``--crossover`` also times K1's and K2's templates against their stacked
   designs on the same inputs at the counted fusion shapes: ``k1 designs``
   and ``k2 designs`` rows);
6l. the e2e stream, ``python -m mer_tpu_torch.e2e_stream --toy-tokenizer``
   over the MELD-shaped test split (2,608 utterances in 82 batches of 32,
   280 dialogues) at full width: RoBERTa-base, wav2vec2-base or the mel
   extractor, the config's M2FNet; wav2vec2 with the int16 wire (the entry
   point: a warm pass and a timed one), with the mu-law wire (one timed
   pass), mel (the entry point) and the int8 engines (one timed pass). Each
   run's launches exactly (per wav2vec2 batch K7 1, K6 1, K1 12; per text
   batch K1 12; per mel batch K5 1; per fusion forward K1 17), utterances/s,
   stages, H2D bytes, and the device's idle share of the timed pass (kernel
   time from one more pass under the profiler); the first two batches of each
   branch in f32 through the kernels against the plain versions (1e-3); the
   mu-law audio table within 0.05 of the int16 one (relative norm,
   tests/test_mulaw.py:153) and the int8 tables within 0.25 of the bf16 ones
   (of the largest value), over the first 16 batches; the native wav decoder
   against the stdlib reader in ms a batch, equal bits on every batch; then
   ``mer_tpu_torch.test --synthetic --int8`` (17 K1 a forward; its logits
   within 0.15 of the bf16 model's largest logit; utterances/s) and
   ``.serve --synthetic --int8 --requests 280`` (p50, p99);
6m. parallelism: ``torchrun --nproc-per-node 1 -m mer_tpu_torch.train
   --synthetic --epochs 1`` with ``tpu.zero1`` (one process: no group) against
   the same epoch in this process, weights within 1e-6; two ranks of this
   script (``--parallel-rank``) on the one card over gloo (NCCL takes one
   rank a card), 3 fusion steps at the config's width, dropout 0, at dp 2
   and tp 2 in f32 and bf16 and dp 2 with ZeRO-1 in f32, against the same
   steps in one process (``mer_tpu_torch.scripts.parallel_check``'s steps
   and rules): f32 losses within 1e-5, bf16 within 2e-2 of the loss, every
   weight but the key biases within 1e-5 save at most 1e-3 (f32) or 1e-2
   (bf16) of them (``parallel_check.weight_check``: Adam turns a
   near-zero gradient's step around under a change of rounding),
   exactly 17 K1 and 17 K2 launches a step on each rank (counted: their
   tallies join this process's), ZeRO-1's optimizer bytes a rank half of
   dp's; the ring (``mer_tpu_torch.ops.ring_attention``) as a local ring at
   wav2vec2-base width, [2, 12, 4500, 64] at sp 2 and 4 and [1, 12, 9000,
   64] at sp 2, the long clips' padding (a whole shard at sp 4), f32 and
   bf16, forward and backward, against the plain full attention
   (``parallel_check.ring_errors``: f32 1e-4 of the largest value; bf16 out
   within 3 x the sums' rounding bound + an ulp, gradients 2e-2 of the
   largest value), sp K1 or K3 and sp K4 launches a ring step, its
   forward's ms beside one call on the whole sequence;
6n. parallelism part 2: two ranks of this script (``--parallel-rank ...
   pp``) on the card over gloo run GPipe at pp 2 (``--pp``,
   ``parallel_check.fe_pp_steps``): 3 RoBERTa-base text fine-tune steps
   (batches of 16 at the 256 bucket, 4 microbatches) and 2 wav2vec2-base
   steps under ``--remat full`` (batches of 4 of 1.5-3 s, 2 microbatches),
   bf16, dropout on, against the same steps in this process with the same
   per-(layer, microbatch) seeds: losses within 2e-2 of the loss, weights by
   ``parallel_check.weight_check``, and a rank's launches a step exactly
   L / pp x M K1 and K4 (twice the K1 under remat); one f32 text step with
   dropout on under ``--remat full`` and ``dots`` against none, the
   gradients to the bit (a tensor whose plain gradient does not repeat
   between two plain steps, atomic sums, within 4 x that spread), K1 twice
   a layer; one mel epoch with
   ``solver.async_mining`` against the same epoch mined synchronously with
   the weights one step stale (the same indices, losses within 1e-5 of the
   loss); one mel training epoch (the entry point) at
   ``AUDIO.augmentation_factor`` 2: the native batch decode, ``random_augment``
   on the card, two K5 launches a step and one a validation cache chunk;
7. hold each kernel against its plain version again at every shape that
   phases 4-6i gave it (recorded at each launch), in float32 and bfloat16
   (K5: float32, in both layouts), and K5 on pure tones and a silent clip:
   within 1e-5 of each frame's largest band in the linear domain, exactly
   log(eps) (rounded once from float64) on silence, the same bits from two
   calls;
8. K6 in f32 against cuDNN's f32 chain, K3 against SDPA, K1's stacked
   forward (bf16, f32) against its template on the same inputs and SDPA, K2
   (its stacked design, in bf16 and f32; beside its template at head dim 50)
   against SDPA's backward,
   and K1, K3 and K4 in f32 at head dim 64 against SDPA's f32 at every
   phase-3 shape; per main-path shape of each kernel its launches, time,
   bound, plain and library time, then one ``{"kernels": [...]}`` line, whose
   times and bound are per launch, averaged over the main paths' launches at
   their own shapes (K6, K1, K2, K3 and K4 an entry per dtype,
   ``w2v_conv_tail``, ``flash_attention_fwd``, ``flash_attention_bwd``,
   ``flash_attention_stream`` and ``flash_attention_tiled_bwd`` bf16 and the
   same names with ``_f32``, whose bounds count three TF32 products per f32
   product at the TF32 peak (``utils/profiling.py``'s ``PEAK_TF32X3``): K6
   and, at head dim 64, K1, K3 and K4; K1's stacked forward the entries
   ``flash_attention_fwd_stacked`` and ``_stacked_f32`` (with the template's
   time at the same launches); K1's and K2's template routes an entry
   ``_template`` where a counted path launched them (the templates against
   the stacked designs at the same shapes: phase 6j's ``k1 designs`` and
   ``k2 designs`` rows);
   K5's bound from the function's least work, a
   real FFT and the mel product over the filterbank's nonzeros; P's averaged
   over its six probes, each probe's row beside it); then the device line
   last.

Tolerances (kernel against plain version, same inputs, |err| <= atol +
rtol |want|; every plain attention version runs on the inputs' own dtype and
rounds P, and the backwards dS, to it as the kernels do, over other tiles): K1
and K3 out f32 (2e-5, 0), in bf16 within the a priori bound (2^-7 + Sk
2^-22) T + one ulp of the larger value, T = sum_j |P_ij D_ij v_jd| (both
sides round P o D and the output to bf16: ``FWD_BF16_ELEMENTWISE``'s note); lse 2e-5 in f32,
1e-3 in bf16.
K2 and K4 f32 (1e-4, 1e-5), bf16 (2e-2, 2**-7). In bf16 every one of out, dq,
dk, dv also within ``ATTENTION_BF16_REL`` of the plain version's largest
|value| of that tensor, the tighter limit from 64 keys on (values of
0.005-0.5, under TOL's bf16 atol); the seams K1 | K3 and K2 | K4 within the
same. K5 f32 (1e-4, 1e-4) on the log
values (tests/test_logmel_pallas.py:29's) but at the spectral notches (a
band at or below ``MEL_NOTCH`` = 1e-2 of its frame's largest band, where the
dense f32 plain version is off float64 beyond TOL), and every band within
``MEL_F64_SHARE`` = 1e-6 of its frame's largest band of a float64 rfft chain
in the linear domain (both in ``ops/logmel_kernel.py``; the plain version
reads up to 1.5e-6 there); on pure tones 1e-5 of each frame's largest band
of the plain version in the linear domain (no noise floor: the far bands'
logs are f32 rounding in the plain version). K7 f32 (1e-4, 1e-4: its variance is the
one-pass E[y^2] - mean^2, tests/test_w2v_conv_pallas.py:71), K6 f32 (2e-5,
2e-5, :35), both in bf16 within 2e-2 of the plain version's largest value
(:44). K8 f32 (1e-4, 1e-4), bf16 as K7. wav2vec2 embeddings in f32, kernels against plain versions: 1e-3.
Dropout masks: exact. Model logits in
f32, kernel against plain attention: 1e-3. Parity leg after 3 steps: losses
within 1e-4; every parameter within 2 x lr x 3 (Adam moves a parameter whose
gradient is rounding noise by up to lr per step, in either direction).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import ctypes
import functools
import io
import itertools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from unittest import mock

import numpy as np
import torch

START = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the card's data-sheet peaks (dense bf16 tensor, f32 CUDA-core, HBM). K6 in f32, and K1, K3 and K4 in f32 at head
# dim 64, run three TF32 products per f32 product on the tensor cores (3xTF32): their bounds count the f32 FLOPs at
# PEAK_TF32X3, a third of TF32's rate (the f32 attention templates' other head dims keep PEAK_FLOPS' CUDA-core rate)
from mer_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_TF32X3  # noqa: E402
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPE_NAMES = {0: "float32", 1: "bfloat16"}  # the kernels' dtype codes
DTYPE_LABELS = {torch.bfloat16: "bf16", torch.float32: "f32"}
# (atol, rtol) per kernel output and dtype
TOL = {
    ("fwd", "float32"): (2e-5, 0.0),
    ("lse", "float32"): (2e-5, 0.0), ("lse", "bfloat16"): (1e-3, 0.0),
    ("bwd", "float32"): (1e-4, 1e-5), ("bwd", "bfloat16"): (2e-2, 2.0 ** -7),
    ("logmel", "float32"): (1e-4, 1e-4),
    ("w2v_layer0_gn", "float32"): (1e-4, 1e-4), ("w2v_conv_tail", "float32"): (2e-5, 2e-5),
    ("w2v_gn_gelu", "float32"): (1e-4, 1e-4),
}
# K1 and K3 out in bf16: an a priori rounding bound in place of TOL. Each rounds P o D to bf16 before P V (relative
# error <= 2^-8 a term; K1 and K3 P against the running max, the plain versions the normalised P), adds Sk terms
# in f32 (<= Sk 2^-23 of their sum, the tensor cores truncating) and rounds its output to bf16 (half an ulp), so
# against the exact result |err| <= (2^-8 + Sk 2^-23) T + ulp / 2, T = sum_j |P_ij D_ij v_jd|, and two such
# results part by at most twice the first term plus one ulp of the larger. rounding_witness holds K1 and its plain
# version to the first against an f64 witness, and counts the cases where they broke the elementwise limit this
# replaced (FWD_BF16_ELEMENTWISE, TOL's form), which two correct roundings can break
FWD_BF16_ELEMENTWISE = (1e-2, 2.0 ** -8)
W2V_BF16_REL = 2e-2  # K6, K7 and K8 in bf16: |err| <= this x the plain version's largest value
# K1-K4 in bf16 (out, dq, dk, dv; the seams too): within TOL (out: the rounding bound) and also |err| <= this x the
# plain version's largest |value| of that tensor, the tighter limit from 64 keys on (values of 0.005-0.5 there). Both
# sides round to bf16 last, so one or two ulps of the largest entry (2^-8 to 2^-7 of it) is the expected worst case
# (measured 1.3e-3 to 6.8e-3); a kernel reading the wrong key tiles is off by 0.5-1.4 of it (phase 3b shows both)
ATTENTION_BF16_REL = 2e-2
PROFILE_BF16_REL = 5e-2  # a profile variant against the stock bf16 stack, of its largest value
DROPOUT = 0.4  # the config's model.dropout
FWD, BWD = "flash_attention_fwd", "flash_attention_bwd"  # sources mer_tpu_torch/csrc/<name>.cu
MEL = "logmel_fwd"
W2V0, W2V_TAIL, GN = "w2v_layer0_gn", "w2v_conv_tail", "w2v_gn_gelu"  # K7, K6, K8
STREAM, TILED = "flash_attention_stream", "flash_attention_tiled_bwd"  # K3, K4
PROBE = "probe_strided"  # P
KERNELS = (FWD, BWD, MEL, W2V0, W2V_TAIL, GN, STREAM, TILED, PROBE)
ATTENTION_FWD, ATTENTION_BWD = (FWD, STREAM), (BWD, TILED)
ZERO = dict.fromkeys(KERNELS, 0)
REPLACES = {FWD: "mer_tpu/ops/flash_attention.py:72", BWD: "mer_tpu/ops/flash_attention.py:270",
            MEL: "mer_tpu/ops/logmel_pallas.py:78", W2V0: "mer_tpu/ops/w2v_conv_pallas.py:194",
            W2V_TAIL: "mer_tpu/ops/w2v_conv_pallas.py:135", GN: "mer_tpu/ops/w2v_conv_pallas.py:320",
            STREAM: "mer_tpu/ops/flash_attention.py:424", TILED: "mer_tpu/ops/flash_attention.py:579",
            PROBE: "scripts/probe_pallas_strided.py:37"}
# K3 and K4 against their plain versions: (B, H, Sq, Sk, Dh), B = 2 for a fully masked batch element, Dh 64 and 50
STREAM_SHAPES = [(2, 1, s, s, 64) for s in (4097, 8192, 16384)] + [(2, 1, 4097, 4097, 50)]
TILED_SHAPES = [(2, 1, s, s, 64) for s in (2049, 4499, 8192)] + [(2, 1, 2049, 2049, 50)]
# K1 | K3 and K2 | K4 on the same inputs, at the dispatch's thresholds (fa.STREAM_THRESHOLD, fa.BWD_FUSED_MAX keys)
SEAM_BH = (2, 2)
LONG_DROPOUT = 0.1  # Wav2Vec2Config.attention_dropout
# the long-clip wav2vec2 phase: one clip of 45-90 s a dialogue, 8 train / 4 dev / 4 test, the 60 and 90 s buckets
LONG_SECONDS, LONG_BUCKETS, LONG_BATCH, LONG_STEPS = (45.0, 90.0), (60.0, 90.0), 2, 4
LONG_SPLITS = {"train_sent_emo.csv": 8, "dev_sent_emo.csv": 4, "test_sent_emo.csv": 4}
# K7 (clips, samples) and, through T0 = (samples - 10) // 5 + 1, K6 (clips, T0): the export batch (32), the
# fine-tuning batch (16) and the evaluation batch (2) at every wave bucket (each its own tile plan, the batch-2
# ones with split K), and a ragged length with an odd last tile
W2V_BUCKETS = (32000, 64000, 96000, 128000, 160000)
W2V_SHAPES = [(b, n) for b in (32, 16, 2) for n in W2V_BUCKETS] + [(2, 40005)]
# the shifted-input control of K6's bf16 limit: (clips, samples)
W2V_SHIFT_SHAPES = [(2, 64000), (32, 160000)]
W2V_EXPORT_BATCH, W2V_LAYERS, W2V_HEADS, W2V_HIDDEN = 32, 12, 12, 768
# K8 (clips, rows, valid rows): the profile entry's batch, a short batch, a ragged one with few valid rows
GN_SHAPES = [(32, 31999, 31999), (2, 12799, 12799), (3, 301, 7)]
PROFILE_REPEATS = 5
FE_EPOCHS, FE_FROZEN = 3, 2  # the text and wav2vec2 fine-tuning runs: the configs' 2 frozen epochs + 1
TEXT_WORDS = (2, 100)  # words per utterance of the synthetic root: context windows in the 64, 128, 256 buckets
TEXT_LAYERS = 12
W2V_TRAIN_SECONDS = (0.5, 10.0)  # clip lengths of the wav2vec2 training root: batches in all five wave buckets
# K1 at the wav2vec2 encoder: (B, H, S, S, 64), S the frames of each bucket, export and evaluation batch
W2V_ATTENTION_SHAPES = [(b, W2V_HEADS, s, s, 64) for b in (32, 2) for s in (99, 199, 299, 399, 499)]
# K1 at RoBERTa-base's batches of 32 (the export's and the e2e stream's): every rung of the token ladder
TEXT_ATTENTION_SHAPES = [(32, 12, s, s, 64) for s in (64, 128, 256, 512)]
# phase 6l, the e2e stream over the MELD-shaped test split: (what, flags, passes); the first pass of two warms
E2E_RUNS = (("wav2vec2, int16 wire", [], 2), ("wav2vec2, mu-law wire", ["--wire", "mulaw"], 1),
            ("mel, int16 wire", ["--audio", "mel"], 2), ("int8 engines, wav2vec2, int16 wire", ["--int8"], 1))
E2E_BATCH = 32  # e2e_stream's --utterance-batch
E2E_ENVELOPE_BATCHES = 16  # batches whose tables the mu-law and int8 envelopes hold (512 utterances)
E2E_PLAIN_BATCHES = 2  # batches of each branch embedded through the kernels and through the plain versions
MULAW_REL = 0.05  # mu-law against int16 audio embeddings, relative norm (tests/test_mulaw.py:153)
INT8_ENCODER_REL, INT8_FUSION_REL = 0.25, 0.15  # int8 against bf16, of the largest |value| (tests/test_serving_quant.py)
# K5: (clips, frames): the export batch, the cache chunk, a ragged chunk, a short clip
MEL_SHAPES = [(32, 1001), (64, 1001), (47, 1001), (3, 37)]
MEL_LAYOUTS = ("unfold", "contiguous")  # the strided view of the padded waveforms, or materialised frames
MEL_EPOCHS, MEL_BATCH = 2, 32
MEL_SPLIT_DIALOGUES = {"train_sent_emo.csv": 100, "dev_sent_emo.csv": 20}  # the test split is MELD-shaped
BUCKETS = (8, 16, 24, 33)
# (B, H, Sq, Sk, Dh): dialogue buckets, dh 96 (768/8) and 50 (300/6), one Sq != Sk
# the mel variant's fusion: 6 audio heads of 50
MEL_FUSION_SHAPES = [(32, 6, s, s, 50) for s in BUCKETS]
KERNEL_SHAPES = [(32, 8, s, s, dh) for dh in (96, 50) for s in BUCKETS] + [(32, 8, 24, 33, 96)] + MEL_FUSION_SHAPES
# K1 bf16 and its plain version against an f64 witness: (shape, case index) of the case where the two once parted by
# two ulps (dropout 0.4; its index in phase 3's list as it stands), then every dialogue shape at ROUNDING_SEEDS seeds
ROUNDING_CASE = ((32, 8, 24, 33, 96), 53)
ROUNDING_SEEDS = 16
ROUNDING_RMS_RATIO = 1.1
ONLINE_REQUESTS = (64, 280)  # one micro-batch at --max-batch 64; the MELD test split's dialogue count
TRAIN_EPOCHS = 2
MEL_VARIANT = (300, 6)  # the mel variant's AUDIO embedding_size and n_head (e2e_stream.py's --audio mel override)
# phase 6m: (name, dp, tp, tpu.zero1, compute dtype) of the two-rank fusion runs, each parallel_check.STEPS steps
PARALLEL_CASES = [("dp2_f32", 2, 1, False, "float32"), ("tp2_f32", 1, 2, False, "float32"),
                  ("dp2_bf16", 2, 1, False, "bfloat16"), ("tp2_bf16", 1, 2, False, "bfloat16"),
                  ("dp2_zero1_f32", 2, 1, True, "float32")]
# phase 6n: (name, kind, remat) of the two-rank pp 2 runs (parallel_check.PP_RUNS: steps, batch, microbatches)
PP_CASES = [("text_pp2", "text", False), ("w2v_pp2_remat", "wav2vec2", "full")]
PP_LAYERS = 12  # RoBERTa-base's and wav2vec2-base's encoder layers
REMAT_SPREAD = 4.0  # remat vs plain on a tensor whose plain f32 gradient itself does not repeat (atomic sums)
PARALLEL_BF16_LOSS_REL = 2e-2  # two-rank against one-process losses in bf16 (row-parallel sums rounded once more)
# the ring on a local ring: ([B, H, S, Dh], sp) at wav2vec2-base width: K1 blocks of 2,250 and 1,125 keys, K3 of 4,500
RING_CASES = [((2, 12, 4500, 64), 2), ((2, 12, 4500, 64), 4), ((1, 12, 9000, 64), 2)]
# (kernel, (B, H, Sq, Sk, Dh), dtype name, dropout rate) -> launches, over the main paths' counted runs
PATH_SHAPES: collections.Counter = collections.Counter()


def log(msg: str) -> None:
    """A line of the run's log after the seconds since the script started: the phases' timeline."""
    print(f"[{time.perf_counter() - START:.1f} s] {msg}", flush=True)


def device_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call (no host launch cost): ``reps`` calls captured in
    one CUDA graph, the median of ``replays`` replays each between an event
    pair of its own (``bench_attention.device_ms``: a host stall between
    replays is not device time)."""
    from mer_tpu_torch.scripts.bench_attention import device_ms as timed

    return timed(fn, reps, replays)


def eager_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Time per call issued eagerly from Python (host launch cost included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def excess(got, want, key) -> float:
    """Largest |got - want| beyond the TOL allowance of ``key`` (<= 0 passes)."""
    atol, rtol = TOL[key]
    got, want = got.float(), want.float()
    return ((got - want).abs() - atol - rtol * want.abs()).max().item()


def attention_inputs(shape, dtype, seed: int, fully_masked: bool = False, clips: bool = False):
    """q, k, v and a cotangent g at the main path's scale, and a
    dialogue-style key mask: row b keeps its first L_b keys, row 0 is all
    padding with key 0 attendable, or with ``fully_masked`` every key of row
    0 ignored. With ``clips`` (K3 and K4) every row keeps its first L_b >=
    Sk / 2 keys less a scattered 10%, key 0 always, and only
    ``fully_masked`` empties row 0: no row is left with one key, whose
    gradients would be zero.

    On the main path q, k, v are LayerNorm'd activations (unit variance)
    through the in-projection, whose seeded weights are U(+-1/sqrt(D)): the
    projections have variance 1/3."""
    b, h, sq, sk, dh = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = ((torch.randn(b, h, s, dh, generator=gen) / 3 ** 0.5).to("cuda", dtype)
                  for s in (sq, sk, sk, sq))
    lengths = torch.randint(sk // 2 if clips else 1, sk + 1, (b,), generator=gen)
    mask = torch.arange(sk)[None, :] >= lengths[:, None]
    if clips:
        mask |= torch.rand(b, sk, generator=gen) < 0.1
        mask[:, 0] = False
        mask[0] |= fully_masked
    else:
        mask[0] = True
        mask[0, 0] = fully_masked
    return q, k, v, g, mask.cuda()


def attention_errors(names, got, want, dtype: str, sums: torch.Tensor | None = None) -> dict:
    """Excess over the limit (<= 0 passes) of each output of an attention
    kernel: TOL, but a bf16 forward's out the rounding bound ``sums`` (from
    ``parallel_check.sum_bound``) + one ulp of the larger value; in bf16 also
    ``ATTENTION_BF16_REL`` of the plain version's largest |value| on out, dq,
    dk and dv."""
    from mer_tpu_torch.scripts.parallel_check import bf16_out_excess

    errs = {}
    for name, a, b in zip(names, got, want):
        if name == "out" and dtype == "bfloat16":
            errs[name] = bf16_out_excess(a, b, sums)
        else:
            errs[name] = excess(a, b, ({"out": "fwd", "lse": "lse"}.get(name, "bwd"), dtype))
        if dtype == "bfloat16" and name != "lse":
            rel_excess = ((a.float() - b.float()).abs().max() - ATTENTION_BF16_REL * b.float().abs().max()).item()
            errs[name] = max(errs[name], rel_excess)
    return errs


def dropout_seed(i: int, rate: float):
    return (0x9E3779B9 ^ i, 1000 + i) if rate else None


def attention_bound(kernel: str, shape, dtype) -> tuple[float, float]:
    """Least time (us) of one call from bytes at the HBM rate (each input
    read once, each output written once) and from the products' FLOPs at
    the dense peak of the dtype; the bound is the larger. A forward (K1, K3)
    reads q, k, v, mask and writes out, lse (2 products); a backward (K2, K4)
    reads q, k, v, out, g, lse, mask and writes dq, dk, dv (5 products).
    K1, K3 and K4 in f32 at head dim 64 (the 3xTF32 designs) count their
    products at ``PEAK_TF32X3``; K2 and the other f32 head dims (the
    templates) at the CUDA-core rate. Dropout's Philox integer work is not
    counted."""
    b, h, sq, sk, dh = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    forward = kernel in ATTENTION_FWD
    rows_q, rows_k = (2, 2) if forward else (4, 4)  # q, out (+ g, dq); k, v (+ dk, dv)
    nbytes = (rows_q * b * h * sq * dh + rows_k * b * h * sk * dh) * esize + b * h * sq * 4 + b * sk
    flops = (4 if forward else 10) * b * h * sq * sk * dh
    tf32 = (forward or kernel == TILED) and dtype == torch.float32 and dh == 64
    return nbytes / HBM_BYTES_PER_S * 1e6, flops / (PEAK_TF32X3 if tf32 else PEAK_FLOPS[dtype]) * 1e6


def sdpa_forward(q, k, v, mask, rate):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=~mask[:, None, None, :], dropout_p=rate)


def library_backward_ms(q, k, v, mask, g, rate) -> float:
    """SDPA's backward at the same shape: fwd+bwd minus fwd, both as device
    time of CUDA graph replays (the port never calls SDPA)."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def forward():
        return sdpa_forward(*leaves, mask, rate)

    def forward_backward():
        for t in leaves:
            t.grad = None
        forward().backward(g)

    return device_ms(forward_backward) - device_ms(forward)


def attention_calls(fa, kernel: str):
    """(kernel wrapper, its plain version) of attention kernel ``kernel``."""
    return {FWD: (fa.flash_attention_forward, fa.flash_attention_reference),
            STREAM: (fa.flash_attention_stream, fa.flash_attention_stream_reference),
            BWD: (fa.flash_attention_backward, fa.flash_attention_backward_reference),
            TILED: (fa.flash_attention_tiled_backward, fa.flash_attention_tiled_backward_reference)}[kernel]


def forward_route(shape, dtype: str) -> str:
    """The design K1's C entry takes (``fa.FORWARD_ROUTES``) for 16-byte aligned tensors, as every main path hands
    them: its Hopper forwards at head dim 64 (bf16 on wgmma, f32 in 3xTF32), its one-pass stacked forward in bf16 and
    f32 at Sq, Sk <= 64 and head dims 96 and 50 (the fusion model's dialogues), else the template."""
    from mer_tpu_torch.ops import flash_attention as fa

    return fa._forward_route(DTYPES[dtype], shape[2], shape[3], shape[4], True)


def k1_routed(fa, call, route: str):
    """call(), which launches K1 once, and the check that its C entry took the design ``route``."""
    before = dict(fa.flash_attention_forward.routes)
    result = call()
    if fa.flash_attention_forward.routes != {**before, route: before[route] + 1}:
        raise AssertionError(f"K1: expected one launch through its {route} design; routes "
                             f"{fa.flash_attention_forward.routes} after {before}")
    return result


def backward_route(shape, dtype: str) -> str:
    """The design K2's C entry takes (``fa.FUSED_ROUTES``) for 16-byte aligned tensors, as every main path hands
    them: its one-pass stacked design in bf16 and f32 at Sq, Sk <= 64 and head dims 50, 64 and 96, else the
    template."""
    from mer_tpu_torch.ops import flash_attention as fa

    return fa._fused_route(DTYPES[dtype], shape[2], shape[3], shape[4], True)


def backward_kernel(fa, keys: int) -> str:
    """The backward kernel the dispatch picks at ``keys`` keys: K2 up to
    ``BWD_FUSED_MAX`` (the dialogue buckets), K4 above."""
    return TILED if keys > fa.BWD_FUSED_MAX else BWD


def check_case(fa, kernel: str, shape, dtype: str, rate: float, i: int, timed: bool = True,
               fully_masked: bool = False) -> dict:
    """One attention kernel (K1-K4) against its plain version at one case,
    with times unless ``timed`` is off; raises on a disagreement. The plain
    versions run on the inputs themselves (they round P, and the backwards dS,
    to their dtype, as the kernels do). K3, and K1 and K2 on their stacked
    designs, also give the same bits from a second call; beside K1's stacked
    forward and K2's stacked backward at head dim 50 the template runs on the
    same inputs (through the C entries' route hook), is held to the same
    limits against the same plain result (``excess``'s ``template_*``) and
    is timed (``template_ms``)."""
    from mer_tpu_torch.scripts.parallel_check import sum_bound

    q, k, v, g, mask = attention_inputs(shape, DTYPES[dtype], seed=i, fully_masked=fully_masked,
                                        clips=kernel in (STREAM, TILED) or shape[3] >= 64)
    seed = dropout_seed(i, rate)
    call_fn, plain_fn = attention_calls(fa, kernel)
    forward_of = fa.flash_attention_forward if kernel in (FWD, BWD) else fa.flash_attention_stream
    if kernel == FWD:  # the design K1's C entry took: its Hopper forwards at head dim 64, else the template
        out, lse = k1_routed(fa, lambda: forward_of(q, k, v, mask, seed, rate), forward_route(shape, dtype))
    else:
        out, lse = forward_of(q, k, v, mask, seed, rate)
    # the dialogue shapes take microseconds a call; the wav2vec2 and RoBERTa encoders' take milliseconds, and
    # 45-90 s clips up to half a second for the plain versions with dropout
    scores = shape[0] * shape[1] * shape[2] * shape[3]
    time_device, time_eager = device_ms, eager_ms
    if scores > 1 << 28:
        time_device, time_eager = (functools.partial(device_ms, reps=1, replays=2),
                                   functools.partial(eager_ms, iters=3, warmup=1))
    elif scores > 1 << 22:
        time_device, time_eager = (functools.partial(device_ms, reps=4, replays=3),
                                   functools.partial(eager_ms, iters=10, warmup=2))
    same = True  # K3, K1's stacked forward: the same bits from a second call
    stacked = (forward_route if kernel == FWD else backward_route)(shape, dtype).startswith("stacked") \
        if kernel in (FWD, BWD) else False
    if kernel == STREAM or (kernel == FWD and stacked):
        again = call_fn(q, k, v, mask, seed, rate)
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del again
    template = None  # the template on the same inputs: K1's stacked forward, K2's stacked backward at head dim 50
    if kernel == FWD and stacked:
        template = lambda: fa._k1(q, k, v, mask, seed, rate, route=0)
    elif kernel == BWD and stacked and shape[4] == 50:
        template = lambda: fa._k2(q, k, v, mask, out, lse, g, seed, rate, None, route=0)
    if kernel in ATTENTION_FWD:
        torch.cuda.synchronize()
        ref_out, ref_lse = plain_fn(q, k, v, mask, seed, rate)
        sums = sum_bound(plain_fn, q, k, v, mask, seed, rate) if dtype == "bfloat16" else None
        errs = attention_errors(("out", "lse"), (out, lse), (ref_out, ref_lse), dtype, sums)
        if template is not None:  # the template's 1-, 2- and 4-slice builds, at the rows of this shape
            t_out, t_lse = k1_routed(fa, template, "template")
            errs.update({f"template_{name}": e for name, e in attention_errors(
                ("out", "lse"), (t_out, t_lse), (ref_out, ref_lse), dtype, sums).items()})
            del t_out, t_lse
        del sums
        max_abs_err = (out.float() - ref_out.float()).abs().max().item()
        rel_err = {"out": max_abs_err / ref_out.float().abs().max().item()}
        del ref_out, ref_lse
        call = lambda: call_fn(q, k, v, mask, seed, rate)
        plain = lambda: plain_fn(q, k, v, mask, seed, rate)
        library = (lambda: time_device(lambda: sdpa_forward(q, k, v, mask, rate)))
    else:
        wrapper = fa.flash_attention_tiled_backward if kernel == TILED else fa.flash_attention_backward
        routes = dict(wrapper.routes)
        grads = call_fn(q, k, v, mask, out, lse, g, seed, rate)
        torch.cuda.synchronize()
        # the design the C entry took: K4's Hopper designs at head dim 64, K2's stacked design at the fusion
        # model's dialogues, else the template
        if kernel == TILED:
            route = ("wgmma_tf32" if dtype == "float32" else "wgmma_bf16") if shape[4] == 64 else "template"
        else:
            route = backward_route(shape, dtype)
        if wrapper.routes != {**routes, route: routes[route] + 1}:
            raise AssertionError(f"{'K4' if kernel == TILED else 'K2'} at {shape} {dtype}: expected its {route} "
                                 f"route, took {wrapper.routes} after {routes}")
        if kernel == BWD and stacked:  # the same bits from a second call
            same = all(torch.equal(a, b) for a, b in zip(grads, call_fn(q, k, v, mask, out, lse, g, seed, rate)))
        ref = plain_fn(q, k, v, mask, out, lse, g, seed, rate)
        errs = attention_errors(("dq", "dk", "dv"), grads, ref, dtype)
        if template is not None:
            routes = dict(wrapper.routes)
            t_grads = template()
            if wrapper.routes != {**routes, "template": routes["template"] + 1}:
                raise AssertionError(f"K2 at {shape} {dtype}: expected its template route, took {wrapper.routes} "
                                     f"after {routes}")
            errs.update({f"template_{name}": e
                         for name, e in attention_errors(("dq", "dk", "dv"), t_grads, ref, dtype).items()})
            del t_grads
        max_abs_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref))
        rel_err = {name: (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
                   for name, a, b in zip(("dq", "dk", "dv"), grads, ref)}
        del grads, ref
        call = lambda: call_fn(q, k, v, mask, out, lse, g, seed, rate)
        plain = lambda: plain_fn(q, k, v, mask, out, lse, g, seed, rate)
        library = (lambda: library_backward_ms(q, k, v, mask, g, rate))
    row = {"kernel": kernel, "shape": shape, "dtype": dtype, "rate": rate, "fully_masked": fully_masked,
           "max_abs_err": max_abs_err, "err_over_largest": rel_err, "excess": errs, "same_bits": same}
    if timed:
        row.update(kernel_ms=time_device(call), kernel_eager_ms=time_eager(call), plain_ms=time_device(plain),
                   library_ms=library())
        if template is not None:
            row["template_ms"] = time_device(template)
    bytes_us, ops_us = attention_bound(kernel, shape, DTYPES[dtype])
    row.update(bound_bytes_us=bytes_us, bound_ops_us=ops_us, bound_us=max(bytes_us, ops_us),
               bound_by="bytes" if bytes_us >= ops_us else "operations")
    log("kernel " + json.dumps(row))
    if not (all(e <= 0 for e in errs.values()) and same):
        raise AssertionError(f"{kernel} disagrees with its plain version at {shape} {dtype} dropout {rate}"
                             f"{' (a fully masked batch element)' if fully_masked else ''}: excess over tolerance "
                             f"{errs} (template_*: the template on the same inputs), the same bits from two calls "
                             f"{same}")
    return row


def rounding_witness(fa, seeds: int = ROUNDING_SEEDS) -> dict:
    """K1 bf16 and its plain version, each against an f64 witness: the plain
    version on the inputs' exact values in f64 (P unrounded). Over every
    dialogue shape of phase 3, dropout off and on, ``seeds`` seeds each:
    each one's RMS and largest error against the witness, its largest error
    over its a priori bound (``parallel_check.sum_bound`` of one side + ulp / 2) as a
    ratio, the largest ratio of the K1-plain gap to the bound of
    ``attention_errors``, the largest gap in ulps of the plain value where
    that is at least 1/4, and the cases where the gap broke the elementwise
    limit the bound replaced. Then ``ROUNDING_CASE`` through
    :func:`check_case`. Raises if K1 or the plain version breaks its bound
    against the witness, or K1's RMS error is above ``ROUNDING_RMS_RATIO``
    times the plain version's."""
    from mer_tpu_torch.scripts.parallel_check import bf16_ulp, sum_bound

    atol, rtol = FWD_BF16_ELEMENTWISE
    squares = {"k1": 0.0, "plain": 0.0}
    summary = {"cases": 0, "elementwise_cases_over": 0, "elementwise_largest_excess": -float("inf"),
               "gap_over_bound": 0.0, "ulps_apart": 0.0}
    summary.update({f"{stat}_{name}": 0.0 for stat in ("largest", "over_bound") for name in squares})
    n = 0
    for shape in KERNEL_SHAPES:
        for rate in (0.0, DROPOUT):
            for i in range(seeds):
                q, k, v, _, mask = attention_inputs(shape, torch.bfloat16, seed=i)
                seed = dropout_seed(i, rate)
                got = fa.flash_attention_forward(q, k, v, mask, seed, rate)[0].double()
                plain = fa.flash_attention_reference(q, k, v, mask, seed, rate)[0].double()
                exact = fa.flash_attention_reference(q.double(), k.double(), v.double(), mask, seed, rate)[0]
                sums = sum_bound(fa.flash_attention_reference, q, k, v, mask, seed, rate, sides=1).double()
                for name, x in (("k1", got), ("plain", plain)):
                    err = (x - exact).abs()
                    squares[name] += err.square().sum().item()
                    bound = sums + bf16_ulp(x) / 2
                    summary[f"largest_{name}"] = max(summary[f"largest_{name}"], err.max().item())
                    summary[f"over_bound_{name}"] = max(summary[f"over_bound_{name}"], (err / bound).max().item())
                gap = (got - plain).abs()
                bound = 2 * sums + bf16_ulp(torch.maximum(got.abs(), plain.abs()))
                summary["gap_over_bound"] = max(summary["gap_over_bound"], (gap / bound).max().item())
                big = plain.abs() >= 0.25
                summary["ulps_apart"] = max(summary["ulps_apart"], (gap[big] / bf16_ulp(plain[big])).max().item())
                elementwise = (gap - atol - rtol * plain.abs()).max().item()
                summary["elementwise_largest_excess"] = max(summary["elementwise_largest_excess"], elementwise)
                summary["elementwise_cases_over"] += int(elementwise > 0)
                summary["cases"] += 1
                n += exact.numel()
    summary.update({f"rms_{name}": (total / n) ** 0.5 for name, total in squares.items()})
    log("rounding witness, K1 bf16 and its plain version against f64 " + json.dumps(summary))
    row = check_case(fa, FWD, ROUNDING_CASE[0], "bfloat16", DROPOUT, ROUNDING_CASE[1], timed=False)
    if summary["over_bound_k1"] > 1 or summary["over_bound_plain"] > 1 \
            or summary["rms_k1"] > ROUNDING_RMS_RATIO * summary["rms_plain"]:
        raise AssertionError(f"K1 bf16 or its plain version breaks its rounding bound against f64: {summary}")
    return {**summary, "case": row}


def check_limit_fails_rolled_slices(fa) -> None:
    """The bf16 limits shown to fail K1's stacked forward when it is handed K and V whose (b*h) slices are rolled by
    one (a tile reading its neighbour's keys), at the 16 bucket (two slices a tile at B H = 256) in both head dims:
    the excess over the limit of attention_errors must be positive, where the same call on the right keys passes
    (phase 3)."""
    from mer_tpu_torch.scripts.parallel_check import sum_bound

    for shape in ((32, 8, 16, 16, 96), (32, 6, 16, 16, 50)):
        q, k, v, _, mask = attention_inputs(shape, torch.bfloat16, seed=11)
        want = fa.flash_attention_reference(q, k, v, mask)
        sums = sum_bound(fa.flash_attention_reference, q, k, v, mask, None, 0.0)
        rolled = [t.reshape(-1, *t.shape[2:]).roll(1, 0).reshape(t.shape).contiguous() for t in (k, v)]
        got = k1_routed(fa, lambda: fa.flash_attention_forward(q, *rolled, mask), forward_route(shape, "bfloat16"))
        excess = attention_errors(("out",), got[:1], want[:1], "bfloat16", sums)["out"]
        log(f"K1's stacked forward on rolled key slices at {list(shape)} bf16: excess over the limit {excess} "
            "(must be > 0)")
        if not excess > 0:
            raise AssertionError(f"the bf16 limit does not catch K1 reading rolled key slices at {shape}")


def check_dropout_masks(fa, b: int, h: int, sq: int, sk: int, rate: float = DROPOUT, long: bool = False,
                        dtype=torch.float32) -> None:
    """Read the kernels' dropout masks off exactly: with v = I the forward's
    out[i, j] is P_ij D_ij; with g one-hot, g[i, i - i0] = 1 for the query
    rows i0 .. i0 + Dh - 1 of a window, the backward's dv[j, i - i0] is too.
    K1 and K2 (Dh = Sq: one window; both also at Dh 96 and, up to 50 keys,
    50, their stacked designs in bf16 and f32, up to 64 keys), or with
    ``long`` K3 and K4 (their
    wrappers, at this key count; Dh 64, K4's Hopper design in bf16, so
    ceil(Sq / 64) windows). With ``long`` K3 and K1 are also read at Dh 64
    (their Hopper designs: K3's in bf16, the 3xTF32 forward both launch in
    f32): v one-hot on a window of 64 keys, v[j, j - j0] = 1, gives
    out[i, j - j0] = P_ij D_ij, ceil(Sk / 64) windows."""
    seed = (0xC0FFEE, sq * 100 + sk)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate, "cuda") > 0
    eye = lambda n: torch.eye(n, device="cuda", dtype=dtype).expand(b, h, n, n).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(sk)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    q, k = randn(b, h, sq, sk), randn(b, h, sk, sk)
    forward = fa.flash_attention_stream if long else fa.flash_attention_forward
    backward = fa.flash_attention_tiled_backward if long else fa.flash_attention_backward
    fwd_mask = forward(q, k, eye(sk), None, seed, rate)[0] > 0
    dh = 64 if long else sq
    q = randn(b, h, sq, dh)
    k, v = randn(b, h, sk, dh), randn(b, h, sk, dh)
    out, lse = forward(q, k, v, None, seed, rate)
    bwd_mask = torch.zeros_like(want)
    for i0 in range(0, sq, dh):
        n = min(dh, sq - i0)
        g = torch.zeros(b, h, sq, dh, device="cuda", dtype=dtype)
        g[:, :, i0:i0 + n, :n] = torch.eye(n, device="cuda", dtype=dtype)
        bwd_mask[:, :, i0:i0 + n] = backward(q, k, v, None, out, lse, g, seed, rate)[2][..., :n].transpose(2, 3) > 0
    # K1's and K2's stacked designs at the fusion model's head dims (96 and 50 >= Sq, Sk: one window), bf16 and f32,
    # wherever they take the size (Sq, Sk <= 64; K2 through its own wrapper, which the dispatch skips above 33 keys):
    # v one-hot, v[j, j] = 1, gives the forward's out[i, j] = P_ij D_ij; g one-hot the backward's dv[j, i]
    stacked_bad = 0
    for dtype_name, stacked_dtype in DTYPES.items() if not long and max(sq, sk) <= fa.STACKED_MAX else ():
        for sdh in (96, 50) if max(sq, sk) <= 50 else (96,):
            shape = (b, h, sq, sk, sdh)
            q, k = (randn(b, h, n, sdh).to(stacked_dtype) for n in (sq, sk))
            v = torch.zeros(b, h, sk, sdh, device="cuda", dtype=stacked_dtype)
            v[..., :sk] = torch.eye(sk, device="cuda", dtype=stacked_dtype)
            got = k1_routed(fa, lambda: forward(q, k, v, None, seed, rate)[0], forward_route(shape, dtype_name))
            stacked_bad += int(((got[..., :sk] > 0) != want).sum())
            v = randn(b, h, sk, sdh).to(stacked_dtype)
            out, lse = forward(q, k, v, None, seed, rate)
            g = torch.zeros(b, h, sq, sdh, device="cuda", dtype=stacked_dtype)
            g[:, :, :, :sq] = torch.eye(sq, device="cuda", dtype=stacked_dtype)
            before, route = dict(fa.flash_attention_backward.routes), backward_route(shape, dtype_name)
            dv = fa.flash_attention_fused_backward(q, k, v, None, out, lse, g, seed, rate)[2]
            if fa.flash_attention_backward.routes != {**before, route: before[route] + 1}:
                raise AssertionError(f"K2's dropout read-off at Dh {sdh} missed its {route} design")
            stacked_bad += int(((dv[..., :sq].transpose(2, 3) > 0) != want).sum())
    windowed = {}  # K3's and K1's mismatches at Dh 64, read in key windows
    for name, fwd in (("K3", forward), ("K1", fa.flash_attention_forward)) if long else ():
        window_mask = want.clone()
        for j0 in range(0, sk, dh):
            n = min(dh, sk - j0)
            v = torch.zeros(b, h, sk, dh, device="cuda", dtype=dtype)
            v[:, :, j0:j0 + n, :n] = torch.eye(n, device="cuda", dtype=dtype)
            call = lambda: fwd(q, k, v, None, seed, rate)[0]
            if name == "K1":
                got = k1_routed(fa, call, forward_route((b, h, sq, sk, dh), DTYPE_NAMES[dtype == torch.bfloat16]))
            else:
                got = call()
            window_mask[..., j0:j0 + n] = got[..., :n] > 0
        windowed[name] = int((window_mask != want).sum())
    bad = int((fwd_mask != want).sum()), int((bwd_mask != want).sum()), sum(windowed.values()) + stacked_bad
    what = "K3, K4" if long else "K1, K2 (also at Dh 96 and 50, their stacked designs in bf16 and f32)"
    log(f"dropout masks of {what} "
        f"{DTYPE_LABELS[dtype]} at B={b} H={h} Sq={sq} Sk={sk} "
        f"rate {rate}: {want.numel()} probabilities, keep rate {want.float().mean().item()}, mismatches forward "
        f"{bad[0]}, backward {bad[1]}" + (f", forwards at Dh 64 in key windows {windowed}" if long else
                                          f", stacked designs {stacked_bad}"))
    if bad != (0, 0, 0):
        raise AssertionError(f"kernel dropout masks differ from the plain Philox mask: {bad}")


def mel_waveforms(b: int, seed: int) -> torch.Tensor:
    """[b, max_samples + 400] on the card: tone + noise clips of 0.5-10 s
    (the synthetic MELD root's recipe), peak-normalised and reflect-padded
    as the frontend pads them."""
    from mer_tpu_torch.ops import logmel

    cfg = logmel.MelConfig()
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(cfg.sample_rate // 2, cfg.max_samples + 1, (b,), generator=gen)
    t = torch.arange(cfg.max_samples, dtype=torch.float32) / cfg.sample_rate
    freq = 150 + 650 * torch.rand(b, 1, generator=gen)
    audio = 0.4 * torch.sin(2 * math.pi * freq * t) + 0.05 * torch.randn(b, cfg.max_samples, generator=gen)
    audio = torch.where(torch.arange(cfg.max_samples) < lengths[:, None], audio, 0.0).cuda()
    return logmel.reflect_pad_batch(audio / audio.abs().amax(dim=1, keepdim=True), lengths.cuda(),
                                    cfg.max_samples, cfg.n_fft // 2)


def stft_chain(padded: torch.Tensor, f: int):
    """The library yardstick of K5, a 4-call chain from the same padded
    buffer: torch.stft (cuFFT) -> abs -> baddbmm (mel projection + eps) ->
    log. The port never calls it."""
    from mer_tpu_torch.ops.logmel import EPS_F64, mel_filterbank

    buf = padded[:, : (f - 1) * 160 + 400]
    window = torch.hann_window(400, device="cuda")
    mel_t = torch.from_numpy(mel_filterbank()).cuda().T.expand(buf.shape[0], -1, -1)
    eps = torch.full((1, 1, 1), EPS_F64, device="cuda")

    def chain():
        mag = torch.stft(buf, 400, 160, 400, window=window, center=False, return_complex=True).abs()
        return torch.log(torch.baddbmm(eps, mag.mT, mel_t))

    return chain


def logmel_bound(shape) -> tuple[float, float]:
    """Least time (us) of one K5 call from bytes and from operations (the
    bound is the larger).

    Bytes, at the HBM rate: the frames' footprint read once (the padded
    buffer for the unfold view), the window and the filterbank's nonzeros,
    the output written once. Operations, at the f32 non-tensor peak, the
    function's least work per frame: the window (400 products), a real FFT
    of 400 taps (2.5 n log2 n, half the 5 n log2 n of a complex FFT), the
    magnitude (4 per bin, the square root as one), the mel product over the
    filterbank's nonzeros only (2 per entry), eps and the log (2 per band)."""
    from mer_tpu_torch.ops.logmel import mel_filterbank

    b, f, layout = shape
    taps, bins, mels = 400, 201, 128
    nnz = int(np.count_nonzero(mel_filterbank()))
    frames = b * ((f - 1) * 160 + taps) if layout == "unfold" else b * f * taps
    nbytes = 4 * (frames + b * f * mels + taps + nnz)
    least = taps + 2.5 * taps * math.log2(taps) + 4 * bins + 2 * nnz + 2 * mels
    return nbytes / HBM_BYTES_PER_S * 1e6, b * f * least / PEAK_FLOPS[torch.float32] * 1e6


def mel_held(lk, out: torch.Tensor, ref: torch.Tensor, mel64: torch.Tensor) -> dict:
    """K5 held as ``logmel_kernel``'s MEL_NOTCH and MEL_F64_SHARE say:
    ``log_excess``, its largest excess over TOL against the plain version on
    the log values outside the spectral notches (<= 0 passes); ``notches``,
    the notch values beyond TOL, left to the float64 chain; ``share_kernel``
    and ``share_plain``, the largest distance of K5 and of the plain version from
    the float64 chain in the linear domain, as a share of each frame's
    largest band (K5 <= MEL_F64_SHARE passes; silent frames are held exactly
    elsewhere)."""
    from mer_tpu_torch.ops.logmel import EPS_F64

    atol, rtol = TOL[("logmel", "float32")]
    largest = mel64.amax(dim=-1, keepdim=True)
    notch = (mel64 <= lk.MEL_NOTCH * largest) & (largest > 0)
    excess_all = (out - ref).abs() - atol - rtol * ref.abs()
    log_excess = excess_all.masked_fill(notch, -math.inf)
    share = lambda o: torch.where(largest > 0, (torch.exp(o.double()) - EPS_F64 - mel64).abs() / largest,
                                  0.0).max().item()
    return {"log_excess": log_excess.max().item(), "notches": int(((excess_all > 0) & notch).sum()),
            "share_kernel": share(out), "share_plain": share(ref)}


def check_mel_case(lk, shape, i: int) -> dict:
    """K5 against its plain version at one (clips, frames, layout), f32 with
    TF32 off, with times; raises on a disagreement."""
    from mer_tpu_torch.ops.logmel import frame_signal

    b, f, layout = shape
    padded = mel_waveforms(b, seed=1000 + i)
    frames = frame_signal(padded, f, 400, 160)  # the unfold view
    if layout == "contiguous":
        frames = frames.contiguous()
    out = lk.logmel_frames(frames)
    torch.cuda.synchronize()
    ref = lk.logmel_frames_reference(frames)
    library = stft_chain(padded, f)
    held = mel_held(lk, out, ref, lk.mel_bands_float64(frames))
    errs = {"out": held["log_excess"]}
    row = {"kernel": MEL, "shape": shape, "dtype": "float32", "rate": 0.0,
           "max_abs_err": (out - ref).abs().max().item(), "excess": errs, "float64_chain": held,
           "library_max_abs_diff": (library() - ref).abs().max().item(),
           "kernel_ms": device_ms(lambda: lk.logmel_frames(frames)),
           "kernel_eager_ms": eager_ms(lambda: lk.logmel_frames(frames)),
           "plain_ms": device_ms(lambda: lk.logmel_frames_reference(frames)), "library_ms": device_ms(library),
           "library": "torch.stft (cuFFT) -> abs -> baddbmm -> log, a 4-call chain"}
    bytes_us, ops_us = logmel_bound(shape)
    row.update(bound_bytes_us=bytes_us, bound_ops_us=ops_us, bound_us=max(bytes_us, ops_us),
               bound_by="bytes" if bytes_us >= ops_us else "operations")
    log("kernel " + json.dumps(row))
    if not errs["out"] <= 0:
        raise AssertionError(f"{MEL} disagrees with its plain version at {shape}: excess over tolerance {errs}")
    if not held["share_kernel"] <= lk.MEL_F64_SHARE:
        raise AssertionError(f"{MEL} is {held['share_kernel']} of the frame's largest band off a float64 chain at "
                             f"{shape}; the limit is {lk.MEL_F64_SHARE}")
    return row


def check_mel_tone_and_silence(lk) -> None:
    """K5 on two pure tones (no noise floor) and a silent clip at [3, 1001,
    400] in the unfold layout: in the log domain a pure tone's far bands sit
    at f32 rounding in the plain version, so it is held in the linear domain,
    within 1e-5 of each frame's largest band; silence gives exactly log(eps)
    rounded once to f32 (``torch.log`` in f32 on the card gives the value one
    step off); two calls give the same bits; and, like every phase-7 case,
    within MEL_F64_SHARE of a float64 chain."""
    from mer_tpu_torch.ops.logmel import EPS_F64, MelConfig, frame_signal, reflect_pad_batch

    cfg = MelConfig()
    t = torch.arange(cfg.max_samples, dtype=torch.float32) / cfg.sample_rate
    audio = 0.4 * torch.sin(2 * math.pi * torch.tensor([[310.0], [733.0], [0.0]]) * t)
    lengths = torch.full((3,), cfg.max_samples)
    padded = reflect_pad_batch(audio.cuda(), lengths.cuda(), cfg.max_samples, cfg.n_fft // 2)
    frames = frame_signal(padded, cfg.max_frames, cfg.n_fft, cfg.hop_length)
    got, again = lk.logmel_frames(frames), lk.logmel_frames(frames)
    ref = lk.logmel_frames_reference(frames)
    lin, lin_ref = (torch.exp(x[:2].double()) - EPS_F64 for x in (got, ref))
    largest = lin_ref.amax(dim=-1, keepdim=True)
    rel = ((lin - lin_ref).abs() / largest).max().item()
    share = mel_held(lk, got[:2], ref[:2], lk.mel_bands_float64(frames[:2]))["share_kernel"]
    log_eps = torch.tensor(math.log(EPS_F64), dtype=torch.float32, device="cuda")  # rounded once, from float64
    silent = bool(torch.equal(got[2], log_eps.expand_as(got[2])))
    same = bool(torch.equal(got, again))
    log(f"K5 pure tones [2, 1001, 400] unfold: max |exp(kernel) - exp(plain)| / frame's largest band {rel} (tol 1e-5), "
        f"max |log diff| {(got[:2] - ref[:2]).abs().max().item()} (not held: rounding in the far bands); "
        f"off a float64 chain by {share} of the frame's largest band (tol {lk.MEL_F64_SHARE}); "
        f"silent clip exactly log(eps) {silent}; same bits from two calls {same}")
    if not (rel <= 1e-5 and share <= lk.MEL_F64_SHARE and silent and same and bool((largest > 0).all())):
        raise AssertionError("K5 fails on pure tones, silence or reproducibility")


def kernel_wrappers() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts it."""
    from mer_tpu_torch.ops import flash_attention as fa
    from mer_tpu_torch.ops import logmel_kernel as lk
    from mer_tpu_torch.ops import w2v_conv as wc
    from mer_tpu_torch.scripts import probe_strided

    return {FWD: fa.flash_attention_forward, BWD: fa.flash_attention_backward, MEL: lk.logmel_frames,
            W2V0: wc.layer0_gn, W2V_TAIL: wc.conv_stack_fused, GN: wc.gn_gelu, STREAM: fa.flash_attention_stream,
            TILED: fa.flash_attention_tiled_backward, PROBE: probe_strided.run_probe}


@contextlib.contextmanager
def main_path_run():
    """One counted run of a main path: the launch counts start at 0 and are
    read at the end into ``run``; every launch's shape, dtype and dropout
    rate (K5: clips, frames and layout; K7: clips and samples; K6: clips and
    layer-0 frames; K8: clips, rows and valid rows; P: rows, columns and probe) is tallied in
    ``PATH_SHAPES`` from the arguments the wrappers hand the kernels (the tally launches nothing)."""
    from mer_tpu_torch.ops import flash_attention as fa
    from mer_tpu_torch.ops import logmel_kernel as lk
    from mer_tpu_torch.ops import w2v_conv as wc
    from mer_tpu_torch.scripts import probe_strided

    kernel_fn, mel_kernel_fn, l0_kernel_fn, tail_kernel_fn, gn_kernel_fn = fa._kernel_fn, lk._kernel_fn, \
        wc._l0_kernel_fn, wc._tail_kernel_fn, wc._gn_kernel_fn
    probe_kernel_fn = probe_strided._kernel_fn

    def tallying_by(name, get_fn, case):
        """``get_fn`` with every launch tallied under ``case(args)`` = (shape, dtype name)."""

        def patched():
            fn = get_fn()

            def launch(*args):
                PATH_SHAPES[(name, *case(args), 0.0)] += 1
                return fn(*args)

            return launch

        return patched

    # K5 (frames, clip stride, frame stride, B, F, n_fft, ...); K7 (dtype, 7 pointers, B, L, ...);
    # K6 (dtype, 6 pointers, B, T0, plan, ...); K8 (dtype, 6 pointers, B, rows, valid rows, ...)
    mel_tallying = tallying_by(MEL, mel_kernel_fn, lambda a: (
        (a[3], a[4], "contiguous" if a[2] == a[5] else "unfold"), "float32"))
    l0_tallying = tallying_by(W2V0, l0_kernel_fn, lambda a: ((a[8], a[9]), DTYPE_NAMES[a[0]]))
    tail_tallying = tallying_by(W2V_TAIL, tail_kernel_fn, lambda a: ((a[7], a[8]), DTYPE_NAMES[a[0]]))
    gn_tallying = tallying_by(GN, gn_kernel_fn, lambda a: ((a[7], a[8], a[9]), DTYPE_NAMES[a[0]]))
    # P (probe, x, w, out, T, C, stream)
    probe_tallying = tallying_by(PROBE, probe_kernel_fn, lambda a: ((a[4], a[5], probe_strided.PROBES[a[0]]),
                                                                    "float32"))

    def tallying(name, n_pointers):
        fn = kernel_fn(name, n_pointers)

        def launch(*args):
            dims = tuple(args[1 + n_pointers: 6 + n_pointers])
            on, keep_scale = args[7 + n_pointers], args[11 + n_pointers]
            rate = round(1.0 - 1.0 / keep_scale, 6) if on else 0.0
            PATH_SHAPES[(name, dims, DTYPE_NAMES[args[0]], rate)] += 1
            rc = fn(*args)
            if name in (FWD, BWD) and rc == 0:  # K1's and K2's last pointer: the design their C entry launched
                routes, expected = (fa.FORWARD_ROUTES, forward_route) if name == FWD else (fa.FUSED_ROUTES,
                                                                                            backward_route)
                route = routes[ctypes.c_int.from_address(args[n_pointers]).value]
                want = expected(dims, DTYPE_NAMES[args[0]])
                if route != want:
                    raise AssertionError(f"{'K1' if name == FWD else 'K2'} at {dims} {DTYPE_NAMES[args[0]]} took "
                                         f"its {route} design, not {want}")
            return rc

        return launch

    wrappers = kernel_wrappers()
    run = {}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    with mock.patch.object(fa, "_kernel_fn", tallying), mock.patch.object(lk, "_kernel_fn", mel_tallying), \
            mock.patch.object(wc, "_l0_kernel_fn", l0_tallying), \
            mock.patch.object(wc, "_tail_kernel_fn", tail_tallying), \
            mock.patch.object(wc, "_gn_kernel_fn", gn_tallying), \
            mock.patch.object(probe_strided, "_kernel_fn", probe_tallying):
        yield run
    run.update({name: wrapper.launches for name, wrapper in wrappers.items()})


@contextlib.contextmanager
def plain_attention(fa):
    """Every attention call through the plain versions instead of the kernels,
    dispatched by key count as the kernels are: the wrappers take their CUDA
    tensors as they take CPU ones."""
    with mock.patch.object(fa, "_device_or_raise", lambda q: False):
        yield


def embeddings(batch, device="cuda"):
    """A batch's (text, audio, padding_mask) on the card; f32 embeddings."""
    return tuple(torch.as_tensor(batch[k]).to(device) for k in ("text", "audio", "padding_mask"))


def offline_phase(fa, card: str) -> dict:
    """Phase 4; returns the launches of the offline entry point."""
    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.models import M2FNet, init_random_, save_reference_checkpoint
    from mer_tpu_torch.serving import BatchedPredictor, recollate_batches
    from mer_tpu_torch.serving.engine import build_model, predict_fn

    config = load_config(CONFIG_PATH)
    batches = eval_entry.eval_batches(config, eval_entry.eval_dataset(config, synthetic=True))
    feed = [{k: b[k] for k in ("text", "audio", "padding_mask")} for b in batches]
    merged, _ = recollate_batches(feed, 512)
    n_utt = int(sum((b["emotion"] != -1).sum() for b in batches))
    per_forward = attention_calls_per_forward(config)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m2fnet.pth")
        model = init_random_(M2FNet.from_config(config.model), torch.Generator().manual_seed(0))
        save_reference_checkpoint(ckpt, model)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"offline: M2FNet default config, {n_params} parameters, checkpoint {os.path.getsize(ckpt)} bytes")

        launches = 0
        for extra, n_forward in (([], len(batches)), (["--serving-batch", "512"], len(merged))):
            with main_path_run() as run:
                summary = eval_entry.main(["--synthetic", "--checkpoint", ckpt, *extra])
            launches += run[FWD]
            log(f"offline {extra or 'batch 32'}: {json.dumps(summary)}; kernel launches {run[FWD]} "
                f"= {per_forward} x {n_forward} forwards")
            if run != {**ZERO, FWD: per_forward * n_forward}:
                raise AssertionError(f"expected {per_forward * n_forward} attention launches, got {run}")

        f32 = build_model(config.override(tpu__compute_dtype="float32"), torch.device("cuda"), checkpoint=ckpt)
        bf16 = build_model(config, torch.device("cuda"), checkpoint=ckpt)

    def logits(model, feed_set):
        with torch.inference_mode():
            return [model(*embeddings(b)).float() for b in feed_set]

    for name, feed_set in (("batch 32", feed), ("serving batch 512", merged)):
        with_kernel = logits(f32, feed_set)
        with plain_attention(fa):
            with_plain = logits(f32, feed_set)
        err = max((a - b).abs().max().item() for a, b in zip(with_kernel, with_plain))
        log(f"offline f32 logits {name} {[tuple(b['text'].shape) for b in feed_set]}, kernel vs plain "
            f"attention: max abs diff {err} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"f32 logits through the kernel differ from plain attention by {err} ({name})")
        if name == "batch 32":
            f32_logits = with_kernel

    valid = [torch.from_numpy(b["emotion"] != -1).cuda() for b in batches]
    pred_bf16 = logits(bf16, feed)
    agree = sum(int(((a.argmax(-1) == b.argmax(-1)) & v).sum()) for a, b, v in zip(pred_bf16, f32_logits, valid))
    log(f"offline bf16 vs f32 predictions agree on {agree}/{n_utt} utterances "
        f"(encoder skips in f32, as mer_tpu) ({card})")

    for name, feed_set in (("batch 32", feed), ("serving batch 512", merged)):
        predictor = BatchedPredictor(predict_fn(bf16), "cuda")
        predictor(feed_set)  # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            predictor(feed_set)  # ends in a device-to-host fetch
            times.append(time.perf_counter() - t0)
        log(f"offline bf16 {name}: {len(feed_set)} forwards, {n_utt} utterances, median "
            f"{np.median(times) * 1e3} ms = {n_utt / np.median(times)} utterances/s ({card})")

    # where the time of one forward goes: eager wall time vs device-only time
    for name, b in (("batch 32", feed[0]), ("serving batch", merged[0])):
        args = embeddings(b)
        with torch.inference_mode():
            eager, device = eager_ms(lambda: bf16(*args), iters=20), device_ms(lambda: bf16(*args), reps=1, replays=20)
            kernels, count = kernel_profile(lambda: bf16(*args))
        log(f"forward bf16 {name} {tuple(b['text'].shape)}: eager {eager} ms, device-only (CUDA graph replay) "
            f"{device} ms, device idle share of the eager forward {1 - device / eager} ({card})")
        log_profile(kernels, count)
    return launches


def attention_calls_per_forward(config) -> int:
    m = config.model
    return (int(m.AUDIO.n_encoder_layers) * int(m.AUDIO.n_transformers)
            + int(m.TEXT.n_encoder_layers) * int(m.TEXT.n_transformers) + int(m.FAM.n_layers))


def kernel_profile(fn) -> tuple[dict[str, float], int]:
    """Device time (us) by kernel name over one call, and the number of
    kernels it ran (copies and memsets left out), from torch.profiler. The
    tracer can miss the first launches after it starts, so the window holds a
    warm-up call first, and only what starts inside the marked second call
    counts."""
    from torch.profiler import ProfilerActivity, profile, record_function

    marker = "chip_smoke measured call"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(marker):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    marks = [e.time_range for e in events if e.name == marker and e.device_type == torch.autograd.DeviceType.CPU]
    totals: dict[str, float] = {}
    count = 0
    for e in events:  # user annotations (Optimizer.step, the marker) span kernels already counted
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False) \
                and marks and marks[0].start <= e.time_range.start <= marks[0].end:
            totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += not e.name.startswith(("Memcpy", "Memset"))
    return totals, count


def log_profile(kernels: dict[str, float], count: int) -> None:
    if not kernels:
        log("  profiler: no device activity recorded (kernel breakdown not measured)")
        return
    busy = sum(kernels.values())
    share = lambda fragment: sum(t for n, t in kernels.items() if fragment in n) / busy
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profiler: {count} kernels, {busy} us of kernels, K1 share {share('flash_attention_fwd')} (its stacked "
        f"forward {share('flash_attention_fwd_stacked')}), "
        f"K2 share {share('flash_attention_bwd')}, K3 share {share('flash_attention_stream')}, "
        f"K4 share {share('flash_attention_tiled_bwd')}, K1 and K3 f32 prep pass share {share('prep_tf32_kernel')}, "
        f"K5 share {share('logmel_fwd')}, "
        f"K6 share {share('w2v_conv_s2_gelu')}, K7 share {share('w2v_layer0')}, K8 share {share('w2v_gn_')}; top: "
        + "; ".join(f"{n[:60]} {t} us" for n, t in top))


def training_phase(fa, card: str) -> dict:
    """Phase 6; returns the launches of the training entry point."""
    import yaml

    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch import train as train_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.train import load_checkpoint
    from mer_tpu_torch.train.pipeline import build, parse_args

    config = load_config(CONFIG_PATH)
    per_forward = attention_calls_per_forward(config)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m2fnet.ckpt")

        def write_config(name, cfg):
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                yaml.safe_dump(cfg.override(checkpoint__save_path=ckpt, checkpoint__load_path=ckpt).to_dict(), f)
            return path

        cfg_path = write_config("config.yaml", config)
        argv = ["--synthetic", "--config", cfg_path]

        t0 = time.perf_counter()
        k2_before = dict(fa.flash_attention_backward.routes)
        with main_path_run() as run:
            state, history = train_entry.main([*argv, "--epochs", str(TRAIN_EPOCHS)])
        seconds = time.perf_counter() - t0
        _, batchers, solver = build(parse_args(argv))
        steps, val_batches = TRAIN_EPOCHS * len(batchers["train"]), TRAIN_EPOCHS * len(batchers["val"])
        want = {**ZERO, FWD: per_forward * (steps + val_batches), BWD: per_forward * steps}
        # every K2 launch of a step through the stacked design (the fusion model's 8 heads of 96, Sq = Sk <= 33)
        k2_routes = {r: fa.flash_attention_backward.routes[r] - k2_before[r] for r in fa.FUSED_ROUTES}
        want_routes = {**dict.fromkeys(fa.FUSED_ROUTES, 0),
                       backward_route((1, 1, max(BUCKETS), max(BUCKETS), 96), config.tpu.compute_dtype): want[BWD]}
        losses = history["loss_values"]
        log(f"training: {TRAIN_EPOCHS} epochs of {len(batchers['train'])} steps in {seconds} s (model build, "
            f"checkpoints and validation included); losses {json.dumps(history)}; launches {run} "
            f"(want {want}: {per_forward} K1 + {per_forward} K2 per step, {per_forward} K1 per validation batch); "
            f"K2 by design {k2_routes} (want {want_routes})")
        if run != want or k2_routes != want_routes:
            raise AssertionError(f"training launches {run}, want {want}; K2 designs {k2_routes}, want {want_routes}")
        if len(losses) != TRAIN_EPOCHS or not all(math.isfinite(x) for x in losses + history["val_loss_values"]):
            raise AssertionError(f"training losses not finite or epochs missing: {history}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the last epoch's train loss {losses[-1]} is not below the first {losses[0]}")
        saved = load_checkpoint(ckpt)
        log(f"training checkpoint: epoch {saved['epoch']}, step {saved['extra']['step']}, "
            f"{os.path.getsize(ckpt)} bytes")
        summary = eval_entry.main(["--synthetic", "--config", cfg_path, "--checkpoint", ckpt])
        log(f"mer_tpu_torch.test --checkpoint on the trained checkpoint: {json.dumps(summary)}")
        if saved["extra"]["step"] != steps or not math.isfinite(summary["accuracy"]):
            raise AssertionError(f"checkpoint step {saved['extra']['step']} (want {steps}) or metrics {summary}")
        tools_phase(cfg_path, ckpt, saved, summary, tmp, card)

        # throughput and one step's time split, on the default config (bf16)
        state = solver.init_state(len(batchers["train"]))
        n_utt = sum(int((torch.as_tensor(b["emotion"]) != -1).sum()) for b in batchers["train"])
        solver.train_epoch(state, batchers["train"])  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.train_epoch(state, batchers["train"])  # ends in a device-to-host fetch
            times.append(time.perf_counter() - t0)
        log(f"training bf16 epoch: {len(batchers['train'])} steps, {n_utt} utterances, median "
            f"{np.median(times) * 1e3} ms = {n_utt / np.median(times)} utterances/s ({card})")
        batch = next(iter(batchers["train"]))
        step = lambda: solver.train_epoch(state, [batch])
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        eager = (time.perf_counter() - t0) / 10 * 1e3
        kernels, count = kernel_profile(step)
        busy = sum(kernels.values()) / 1e3
        log(f"training step bf16 {tuple(batch['text'].shape)}: eager {eager} ms (forward, backward, Adam, loss "
            f"fetch), device busy {busy} ms, device idle share {1 - busy / eager if kernels else 'not measured'} "
            f"({card})")
        log_profile(kernels, count)

        # parity: 3 f32 dropout-0 steps through the kernels against the plain attention
        parity = parse_args(["--synthetic", "--config", write_config(
            "parity.yaml", config.override(tpu__compute_dtype="float32", model__dropout=0.0))])
        results = []
        for through in ("kernels", "plain"):
            _, batchers, solver = build(parity)
            state = solver.init_state(len(batchers["train"]))
            batches = list(batchers["train"])[:3]
            with plain_attention(fa) if through == "plain" else contextlib.nullcontext():
                step_losses = [solver.train_epoch(state, [b])[1] for b in batches]
            results.append((step_losses, {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    (k_losses, k_params), (p_losses, p_params) = results
    loss_diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    diffs = torch.cat([(k_params[n] - p_params[n]).abs().flatten() for n in k_params])
    lr = float(config.solver.lr)
    log(f"training parity f32 dropout 0, 3 steps, kernels vs plain attention: losses {k_losses} vs {p_losses}, "
        f"max diff {loss_diff} (tol 1e-4); params max diff {diffs.max().item()} (tol {2 * lr * 3}), "
        f"{int((diffs > lr / 50).sum())} of {diffs.numel()} beyond lr/50")
    if not (loss_diff <= 1e-4 and diffs.max().item() <= 2 * lr * 3 + 1e-6):
        raise AssertionError("training through the kernels departs from training through the plain attention")
    return run


def mel_variant_phase(fa, card: str) -> dict:
    """Phase 6p: the mel variant of the fusion model (``e2e_stream --audio mel``'s: 300-d audio embeddings in 6
    heads of 50, ``MEL_VARIANT``), ``src/config.yaml`` overridden in a temporary file as ``e2e_stream`` overrides it
    in memory: ``mer_tpu_torch.train.main(--synthetic --epochs 1)`` and one offline evaluation of its checkpoint,
    counted. Per step 6 K1 and 6 K2 launches at head dim 50 (the audio encoder) and 11 of each at 96 (the text
    encoder and the FAM layers), per validation and evaluation batch the same K1 launches, every one through its
    stacked design (``main_path_run`` checks each launch's); finite losses and metrics. Returns the launches."""
    import yaml

    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch import train as train_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.train.pipeline import build, parse_args

    width, heads = MEL_VARIANT
    config = load_config(CONFIG_PATH).override(model__AUDIO__embedding_size=width, model__AUDIO__n_head=heads)
    audio = int(config.model.AUDIO.n_encoder_layers) * int(config.model.AUDIO.n_transformers)
    per_forward = attention_calls_per_forward(config)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m2fnet_mel.ckpt")
        cfg_path = os.path.join(tmp, "config_mel.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(config.override(checkpoint__save_path=ckpt, checkpoint__load_path=ckpt).to_dict(), f)
        argv = ["--synthetic", "--config", cfg_path]
        before = collections.Counter(PATH_SHAPES)
        k1_before, k2_before = dict(fa.flash_attention_forward.routes), dict(fa.flash_attention_backward.routes)
        with main_path_run() as run:
            _, history = train_entry.main([*argv, "--epochs", "1"])
            summary = eval_entry.main([*argv, "--checkpoint", ckpt])
        _, batchers, _ = build(parse_args(argv))
        forwards = len(batchers["train"]) + len(batchers["val"]) + len(
            eval_entry.eval_batches(config, eval_entry.eval_dataset(config, synthetic=True)))
    steps = len(batchers["train"])
    launched = collections.Counter(PATH_SHAPES)
    launched.subtract(before)
    by_dh = {(name, dh): sum(n for (kernel, shape, *_), n in launched.items() if kernel == name and shape[4] == dh)
             for name in (FWD, BWD) for dh in (50, 96)}
    want_dh = {(FWD, 50): audio * forwards, (FWD, 96): (per_forward - audio) * forwards, (BWD, 50): audio * steps,
               (BWD, 96): (per_forward - audio) * steps}
    want = {**ZERO, FWD: per_forward * forwards, BWD: per_forward * steps}
    routes = {name: {r: wrapper.routes[r] - was[r] for r in wrapper.routes if wrapper.routes[r] != was[r]}
              for name, wrapper, was in ((FWD, fa.flash_attention_forward, k1_before),
                                         (BWD, fa.flash_attention_backward, k2_before))}
    want_routes = {FWD: {"stacked_bf16": want[FWD]}, BWD: {"stacked_bf16": want[BWD]}}
    log(f"mel variant (AUDIO {width} wide in {heads} heads): 1 epoch of {steps} steps and one offline evaluation in "
        f"{time.perf_counter() - t0:.1f} s; losses {json.dumps(history)}; {json.dumps(summary)}; launches {run} (want "
        f"{want}); by head dim {by_dh} (want {want_dh}: {audio} K1 and K2 a step at 50, {per_forward - audio} at 96); "
        f"by design {routes} (want {want_routes}) ({card})")
    if run != want or by_dh != want_dh or routes != want_routes:
        raise AssertionError(f"mel variant: launches {run}, by head dim {by_dh}, designs {routes}; want {want}, "
                             f"{want_dh}, {want_routes}")
    if not all(math.isfinite(x) for x in history["loss_values"] + history["val_loss_values"]) \
            or not math.isfinite(summary["accuracy"]):
        raise AssertionError(f"mel variant: losses or metrics not finite: {history}, {summary}")
    return run


def captured(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, what it printed); the printout is echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue()


def tools_phase(cfg_path: str, ckpt: str, saved: dict, summary: dict, tmp: str, card: str) -> None:
    """Phase 6o: ``python -m mer_tpu_torch.tools`` on phase 6's checkpoint:
    ``inspect``; ``export-torch``, then ``mer_tpu_torch.test --checkpoint``
    on the ``.pth`` with the checkpoint's logits (bit for bit) and metrics;
    ``preflight`` with the card, ``nvcc`` and every kernel source built
    ``[ok]``, and exit 1 (no MELD, no pretrained weights, no pickles here)."""
    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch import tools
    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.serving.engine import build_model

    t0 = time.perf_counter()
    info = tools.inspect_checkpoint(ckpt)
    log(f"tools inspect: {json.dumps(info, default=str)}")
    n_params = sum(v.numel() for v in saved["model_state_dict"].values())
    if (info["epoch"], info["n_params"], info["extra"].get("step")) != (saved["epoch"], n_params,
                                                                         saved["extra"]["step"]) \
            or info["n_opt_state"] < 2 * n_params:  # Adam's two moments of every parameter
        raise AssertionError(f"tools inspect {info}; checkpoint epoch {saved['epoch']}, {n_params} values")
    pth = os.path.join(tmp, "exported.pth")
    _, out = captured(tools.main, ["export-torch", ckpt, pth, cfg_path])
    config = load_config(cfg_path)
    batch = eval_entry.eval_batches(config, eval_entry.eval_dataset(config, True))[0]
    inputs = [torch.as_tensor(batch[k]).cuda() for k in ("text", "audio", "padding_mask")]
    with torch.inference_mode():
        logits = [build_model(config, torch.device("cuda"), checkpoint=path)(*inputs).float() for path in (ckpt, pth)]
    exported = eval_entry.main(["--synthetic", "--config", cfg_path, "--checkpoint", pth])
    log(f"tools export-torch -> {os.path.getsize(pth)} bytes; .test --checkpoint on it: {json.dumps(exported)}; "
        f"logits {tuple(logits[0].shape)} equal to the checkpoint's: {torch.equal(*logits)}")
    if not torch.equal(*logits) or exported != summary or "torch model_state_dict layout" not in out:
        raise AssertionError(f"the exported .pth gives other logits or metrics: {exported} vs {summary}")
    rc, out = captured(tools.main, ["preflight"])
    want = [f"[ok] card ({card})", "[ok] nvcc ("] + [f"[ok] kernel {name} (" for name in tools.kernel_sources()]
    missing = [w for w in want if w not in out]
    log(f"tools preflight: exit {rc}, {out.count('[ok]')} [ok] and {out.count('[MISSING]')} [MISSING] lines; "
        f"tools phase in {time.perf_counter() - t0} s ({card})")
    if rc != 1 or missing or "[MISSING] train CSV" not in out:
        raise AssertionError(f"preflight exit {rc}; lines not [ok]: {missing}")


def silhouette_f64(x: np.ndarray, labels: np.ndarray) -> float:
    """The mean silhouette in float64 numpy on the host (euclidean; a class
    of one point scores 0), the yardstick of ``utils/viz.py::silhouette``."""
    x = np.asarray(x, np.float64)
    sq = (x * x).sum(1)
    dist = np.sqrt(np.maximum(sq[:, None] + sq[None] - 2 * x @ x.T, 0))
    np.fill_diagonal(dist, 0)
    classes, codes = np.unique(labels, return_inverse=True)
    sums = np.stack([dist[:, codes == c].sum(1) for c in range(len(classes))], 1)
    counts = np.bincount(codes)
    rows = np.arange(len(x))
    intra = sums[rows, codes] / np.maximum(counts[codes] - 1, 1)
    other = sums / counts
    other[rows, codes] = np.inf
    inter = other.min(1)
    s = np.where(counts[codes] > 1, (inter - intra) / np.maximum(intra, inter), 0.0)
    return float(s.mean())


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit RGB PNG with filter 0 on every row, read
    through its chunks (each CRC checked) and ``zlib``."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG signature")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != zlib.crc32(kind + body):
            raise AssertionError(f"PNG chunk {kind} fails its CRC")
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
            if body[8:10] != b"\x08\x02":
                raise AssertionError("PNG not 8-bit RGB")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        raise AssertionError("PNG rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def visualization_checks(tables: dict, printed: str, root: str, cfg: str, save_dir: str, card: str) -> None:
    """Phase 6c's visualisation of the val split (``DEBUG.visualize``, 3D):
    the silhouettes against float64 numpy, the PNG and the HTML, its
    seconds; then ``project_embeddings`` at MELD's dev-split size, timed."""
    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.data import MelFeatureDataset
    from mer_tpu_torch.utils import viz

    config = load_config(cfg)
    if not (config.DEBUG.visualize and config.DEBUG.visualization_type == "3D"):
        raise AssertionError("config_audio_mel.yaml no longer ships DEBUG.visualize with the 3D type")
    val = tables["val"]
    labels = MelFeatureDataset("val", config, data_root=root, device="cpu").get_labels()
    host = silhouette_f64(val, labels)
    card_value = viz.silhouette(val, labels, device="cuda")
    line = [l for l in printed.splitlines() if l.startswith("silhouette score (val): ")]
    shown = float(line[-1].split(": ")[1]) if line else math.nan
    log(f"mel export visualisation, val {val.shape}: printed silhouette {shown}, the card's {card_value}, float64 "
        f"numpy {host}, diff {abs(card_value - host)} (tol 1e-6)")
    if not (abs(card_value - host) <= 1e-6 and abs(shown - host) <= 5e-5 + 1e-9):
        raise AssertionError(f"silhouette {card_value} (printed {shown}) against float64 {host}")
    png = os.path.join(save_dir, "visualization", "png", "visualization_0.png")
    html = os.path.join(save_dir, "visualization", "html", "visualization_0.html")
    with open(png, "rb") as f:
        img = decode_png(f.read())
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    absent = [int(c) for c in np.unique(labels) if viz.disc_colour(c) not in colours]
    with open(html) as f:
        page = f.read()
    payload = json.loads(page.split("const D = ", 1)[1].split(";\n", 1)[0])
    log(f"mel export visualisation: PNG {img.shape} with {len(colours)} colours, classes absent {absent}; HTML "
        f"{len(page)} bytes, {len(payload['pts'])} points of {payload['dims']} dims")
    if img.shape != (viz.CANVAS, viz.CANVAS, 3) or absent or len(payload["pts"]) != len(val) \
            or payload["dims"] != 3 or payload["labels"] != [int(l) for l in labels]:
        raise AssertionError("the mel export's PNG or HTML is wrong")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    viz.visualize_embeddings(val, labels, os.path.join(save_dir, "visualization_timed"), kind="3D", device="cuda")
    log(f"mel export visualisation of the val split ({len(val)} x {val.shape[1]}, 3D: silhouette, PCA, t-SNE, PNG, "
        f"HTML) in {time.perf_counter() - t0} s ({card})")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(7, 300)) * 3
    dev = (centers[rng.integers(0, 7, 1109)] + rng.normal(size=(1109, 300))).astype(np.float32)
    viz.project_embeddings(dev[:64], "3D", device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = viz.project_embeddings(dev, "3D", device="cuda")
    seconds = time.perf_counter() - t0
    log(f"project_embeddings of 1,109 x 300 seeded clustered embeddings (MELD's dev split) in 3D: {seconds} s "
        f"(PCA, perplexity search, up to 1,000 t-SNE iterations in float64, 300 without progress stop) ({card})")
    if z.shape != (1109, 3) or not np.isfinite(z).all():
        raise AssertionError(f"project_embeddings gave {z.shape}, finite {np.isfinite(z).all()}")


# -- the mel feature extractor (stage 1c) -------------------------------------------


def mel_config(tmp: str) -> str:
    """config_audio_mel.yaml, unchanged but for checkpoints under ``tmp``."""
    import yaml

    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.feature_extractors.audio_mel import MEL_CONFIG_PATH

    ckpt = os.path.join(tmp, "ckpt", "checkpoint.ckpt")
    path = os.path.join(tmp, "mel.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(load_config(MEL_CONFIG_PATH).override(checkpoint__save_path=ckpt,
                                                             checkpoint__load_path=ckpt).to_dict(), f)
    return path


def mel_training_phase(lk, card: str, root: str, cfg: str) -> int:
    """Phase 6b; returns the K5 launches of the mel training entry point."""
    from mer_tpu_torch.feature_extractors.audio_mel import build_solver, parse_args
    from mer_tpu_torch.feature_extractors.audio_mel import train as mel_train
    from mer_tpu_torch.ops.logmel import EPS_F64
    from mer_tpu_torch.train import load_checkpoint

    argv = ["--config", cfg, "--data-root", root]
    t0 = time.perf_counter()
    with main_path_run() as run:
        _, history = mel_train.main([*argv, "--epochs", str(MEL_EPOCHS)])
    seconds = time.perf_counter() - t0
    config, solver = build_solver(parse_args(argv))
    n_train, n_val = len(solver.data_train), len(solver.data_val)
    steps = n_train // MEL_BATCH
    want = {**ZERO, MEL: math.ceil(n_train / 64) + math.ceil(n_val / 64)}
    log(f"mel training: {n_train} train / {n_val} val clips, {MEL_EPOCHS} epochs of {steps} steps of "
        f"[{3 * MEL_BATCH}, 3, 1001, 128] f32 in {seconds} s (caches, validation, checkpoints included); "
        f"losses {json.dumps(history)}; launches {run} (want {want}: one K5 per cache chunk of 64, none in a step)")
    if run != want:
        raise AssertionError(f"mel training launches {run}, want {want}")
    losses = history["loss_values"] + history["val_loss_values"]
    if len(history["loss_values"]) != MEL_EPOCHS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mel training losses not finite or epochs missing: {history}")
    saved = load_checkpoint(config.checkpoint.save_path)
    log(f"mel checkpoint: epoch {saved['epoch']}, step {saved['extra']['step']}")
    if saved["epoch"] != MEL_EPOCHS - 1 or saved["extra"]["step"] != MEL_EPOCHS * steps:
        raise AssertionError(f"mel checkpoint at epoch {saved['epoch']}, step {saved['extra']['step']}")

    # throughput and one step's time split (f32, the caches on the card)
    state = solver.init_state()
    solver.train_epoch(state)  # warm-up
    before, times = lk.logmel_frames.launches, []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.train_epoch(state)  # ends in a device-to-host fetch
        times.append(time.perf_counter() - t0)
    if lk.logmel_frames.launches != before:
        raise AssertionError("K5 launched inside mel training steps")
    clips = steps * 3 * MEL_BATCH
    log(f"mel training f32 epoch: {steps} steps, {clips} triplet clips (each step also embeds a mined pool of "
        f"{3 * MEL_BATCH}), median {np.median(times) * 1e3} ms = {clips / np.median(times)} triplet clips/s ({card})")
    spec = solver._triplet_batch(solver.data_train, MEL_BATCH)
    step = lambda: solver.train_step(state, spec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) / 10 * 1e3
    kernels, count = kernel_profile(step)
    busy = sum(kernels.values()) / 1e3
    log(f"mel training step f32 {tuple(spec.shape)}: eager {eager} ms (forward, backward, Adam; mining not "
        f"included), device busy {busy} ms, device idle share {1 - busy / eager if kernels else 'not measured'} "
        f"({card})")
    log_profile(kernels, count)
    del solver, state, spec

    # parity: caches through K5, through the plain version and through a float64 rfft chain; 3 free f32 steps
    # from each on the same rows, then 3 steps from the same weights and Adam state
    float64_chain = lambda frames, cfg=None: torch.log(lk.mel_bands_float64(frames) + EPS_F64).float()
    torch.backends.cudnn.deterministic = True
    try:
        solvers = {}
        for name, fn in (("K5", lk.logmel_frames), ("plain", lk.logmel_frames_reference), ("float64", float64_chain)):
            with mock.patch.object(lk, "logmel_frames", fn):
                _, solver = build_solver(parse_args(argv))
                solvers[name] = (solver, solver.init_state())
        for other in ("plain", "float64"):
            for split in ("data_train", "data_val"):
                a, b = (getattr(solvers[n][0], split).device_cache.to(torch.int16) for n in ("K5", other))
                diff = (a - b).abs()
                log(f"mel cache {split} {tuple(a.shape)} uint8, K5 vs {other}: {int((diff > 0).sum())} of "
                    f"{diff.numel()} entries differ, by at most {int(diff.max())} step")
                if other == "plain" and int(diff.max()) > 1:
                    raise AssertionError(f"the K5 and plain caches part by {int(diff.max())} steps")
        k_solver, k_state = solvers["K5"]
        free = {name: [] for name in solvers}
        for _ in range(3):
            rows = k_solver._miner(k_solver.data_train).mine_hard_rows_device(MEL_BATCH)
            for name, (solver, state) in solvers.items():
                free[name].append(solver.train_step(state, solver.data_train.spectrogram_batch(rows)).item())
        p_solver, p_state = solvers["plain"]
        k_losses, p_losses = [], []
        for _ in range(3):
            p_solver.model.load_state_dict(k_solver.model.state_dict())
            p_state.optimizer.load_state_dict(k_state.optimizer.state_dict())
            rows = k_solver._miner(k_solver.data_train).mine_hard_rows_device(MEL_BATCH)
            k_losses.append(k_solver.train_step(k_state, k_solver.data_train.spectrogram_batch(rows)).item())
            p_losses.append(p_solver.train_step(p_state, p_solver.data_train.spectrogram_batch(rows)).item())
    finally:
        torch.backends.cudnn.deterministic = False
    gap = lambda a, b: max(abs(x - y) for x, y in zip(a, b))
    free_diff, step_diff = gap(free["K5"], free["float64"]), gap(k_losses, p_losses)
    log(f"mel parity f32, 3 free steps on the same rows from the K5, plain and float64 caches: losses "
        f"{json.dumps(free)}; K5 vs float64 max diff {free_diff} (tol 1e-4); plain vs float64 "
        f"{gap(free['plain'], free['float64'])}, K5 vs plain {gap(free['K5'], free['plain'])} (not held: the plain "
        f"version's f32 rounding moves its cache off the float64 chain's, and Adam's first steps amplify that)")
    log(f"mel parity f32, 3 steps on the same rows from the K5 and the plain caches, each from the K5 run's weights "
        f"and Adam state: losses {k_losses} vs {p_losses}, max diff {step_diff} (tol 1e-4)")
    if not (free_diff <= 1e-4 and step_diff <= 1e-4):
        raise AssertionError("mel training from the K5 caches departs from training from the float64 or plain caches")
    return run[MEL]


def mel_export_phase(lk, card: str, root: str, cfg: str, tmp: str) -> int:
    """Phase 6c; returns the K5 launches of the mel export entry point."""
    from mer_tpu_torch.core import get_text, load_config, load_embeddings
    from mer_tpu_torch.data import MelFeatureDataset
    from mer_tpu_torch.feature_extractors.audio_mel import build_solver, parse_args
    from mer_tpu_torch.feature_extractors.audio_mel import embeddings as mel_embeddings
    from mer_tpu_torch.train import load_checkpoint

    save_dir = os.path.join(tmp, "embeddings")
    argv = ["--config", cfg, "--data-root", root]
    t0 = time.perf_counter()
    with main_path_run() as run:
        tables, printed = captured(mel_embeddings.main, argv, save_dir=save_dir)
    seconds = time.perf_counter() - t0
    sizes = {mode: len(get_text(mode, root)) for mode in tables}
    batch = int(load_config(cfg).test.data_loader.batch_size)
    want = {**ZERO, MEL: sum(math.ceil(n / batch) for n in sizes.values())}
    log(f"mel export: splits {sizes} in {seconds} s = {sum(sizes.values()) / seconds} clips/s (model load and the "
        f"val split's visualisation included); launches {run} (want {want}: one K5 per batch of {batch})")
    if run != want or sizes["test"] != 2608:
        raise AssertionError(f"mel export launches {run}, want {want}; test split {sizes['test']} clips")
    for mode, table in tables.items():
        norm_err = float(np.abs(np.linalg.norm(table, axis=1) - 1).max())
        back = load_embeddings(os.path.join(save_dir, f"{mode}.pkl"))
        log(f"mel export {mode}: {table.shape}, finite {bool(np.isfinite(table).all())}, max |norm - 1| {norm_err}")
        if table.shape != (sizes[mode], 300) or not np.isfinite(table).all() or norm_err > 1e-5 \
                or not np.array_equal(back, table):
            raise AssertionError(f"mel export {mode}: bad table")
    visualization_checks(tables, printed, root, cfg, save_dir, card)

    # the test split alone, from fresh wav stores, and one batch's time split
    _, solver = build_solver(parse_args(argv), train_mode="val")
    solver.model.load_state_dict(load_checkpoint(solver.config.checkpoint.save_path)["model_state_dict"])
    solver.export_embeddings(MelFeatureDataset("test", solver.config, data_root=root, device=solver.device))
    test = MelFeatureDataset("test", solver.config, data_root=root, device=solver.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.export_embeddings(test)  # ends in a device-to-host fetch
    seconds = time.perf_counter() - t0
    log(f"mel export f32 test split: {len(test)} clips (wav decode, K5 frontend, ResNet18) in {seconds * 1e3} ms = "
        f"{len(test) / seconds} clips/s ({card})")
    idx = np.arange(MEL_BATCH)
    batch = lambda: solver.embed(test.spectrogram_batch(idx))
    batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        batch()
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) / 10 * 1e3
    kernels, count = kernel_profile(batch)
    busy = sum(kernels.values()) / 1e3
    log(f"mel export batch f32 [{MEL_BATCH} clips]: eager {eager} ms (wav decode of LRU-cached clips, int16 copy, "
        f"log-mel, forward), device busy {busy} ms, device idle share "
        f"{1 - busy / eager if kernels else 'not measured'} ({card})")
    log_profile(kernels, count)
    return run[MEL]


# -- the wav2vec2 feature extractor (stage 1b): export and evaluation ------------------


def w2v_waveforms(b: int, n_samples: int, seed: int) -> torch.Tensor:
    """[b, n_samples] f32 on the card: tone + noise clips (the synthetic MELD
    root's recipe) of ragged lengths, the first one full, zero past each end."""
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(n_samples // 4, n_samples + 1, (b,), generator=gen)
    lengths[0] = n_samples
    t = torch.arange(n_samples, dtype=torch.float32) / 16000
    freq = 150 + 650 * torch.rand(b, 1, generator=gen)
    audio = 0.4 * torch.sin(2 * math.pi * freq * t) + 0.05 * torch.randn(b, n_samples, generator=gen)
    return torch.where(torch.arange(n_samples) < lengths[:, None], audio, 0.0).cuda()


def w2v_bound(kernel: str, shape, dtype) -> tuple[float, float]:
    """Least time (us) of one K7 or K6 call from bytes at the HBM rate (each
    input read once, each output written once) and from the conv products'
    FLOPs at the dense peak of the dtype; the bound is the larger. K7 (clips,
    samples): wave, taps, gamma, beta in, [B, T0, 512] out; 2 x 10 x 512 per
    frame, and 8 per value for the statistics, the affine and the GELU (the
    erf as one). K6 (clips, T0): [B, T0, 512] and the 16 x 512 x 512 weights
    in, [B, T6, 512] out; 2 x k x 512 x 512 per frame of each layer, in f32 at
    ``PEAK_TF32X3`` (three TF32 products each at the TF32 peak). K8 (clips,
    rows, valid rows): [B, T, 512] in and out, gamma and beta in; no product:
    3 operations per valid value for the statistics and 8 per value for the
    affine and the GELU (the erf as one), at the f32 non-tensor peak whatever
    the storage dtype."""
    from mer_tpu_torch.ops import w2v_conv as wc

    esize = torch.tensor([], dtype=dtype).element_size()
    c = wc.CHANNELS
    if kernel == GN:
        b, rows, t_valid = shape
        nbytes = 2 * b * rows * c * esize + 2 * c * 4
        return nbytes / HBM_BYTES_PER_S * 1e6, b * c * (3 * t_valid + 8 * rows) / PEAK_FLOPS[torch.float32] * 1e6
    if kernel == W2V0:
        b, n = shape
        t0 = wc.conv_out_length(n, wc.L0_TAPS, wc.L0_STRIDE)
        nbytes = (b * n + wc.L0_TAPS * c + b * t0 * c) * esize + 2 * c * 4
        flops = b * t0 * c * (2 * wc.L0_TAPS + 8)
    else:
        b, t0 = shape
        lengths = wc.tail_lengths(t0)
        nbytes = (b * t0 * c + sum(wc.TAIL_TAPS) * c * c + b * lengths[-1] * c) * esize
        flops = 2 * c * c * b * sum(k * t for k, t in zip(wc.TAIL_TAPS, lengths))
        if dtype == torch.float32:
            return nbytes / HBM_BYTES_PER_S * 1e6, flops / PEAK_TF32X3 * 1e6
    return nbytes / HBM_BYTES_PER_S * 1e6, flops / PEAK_FLOPS[dtype] * 1e6


def check_w2v_case(wc, frontend, kernel: str, shape, dtype_name: str, i: int) -> dict:
    """K7 at (clips, samples), K6 at (clips, layer-0 frames) or K8 at (clips,
    rows, valid rows) against its plain version on the card, with times; raises
    on a disagreement. The weights are the seeded model's (``frontend``: its
    conv feature extractor on the card); K6 is fed K7's output at the sample
    count that gives its frame count, K8 the stock layer-0 convolution's. The library yardstick runs the same chain in the compute
    dtype, channels first, and is used nowhere in the port."""
    import torch.nn.functional as F

    dtype = DTYPES[dtype_name]
    first = frontend.conv_layers[0]
    w0, gamma, beta = first.conv.weight.detach(), first.layer_norm.weight.detach(), first.layer_norm.bias.detach()
    tail_w = [layer.conv.weight.detach() for layer in frontend.conv_layers[1:]]
    b = shape[0]
    n = shape[1] if kernel == W2V0 else wc.L0_STRIDE * (shape[1] - 1) + wc.L0_TAPS
    wave = w2v_waveforms(b, n, seed=2000 + i)
    if kernel == GN and shape[2] < shape[1]:
        wave[:, wc.L0_STRIDE * shape[2]:] = 1.0  # rows past the valid ones must not reach the statistics
    if kernel == W2V0:
        call = lambda: wc.layer0_gn(wave, w0, gamma, beta, dtype=dtype)
        plain = lambda: wc.layer0_gn_reference(wave, w0, gamma, beta, dtype=dtype)
        wave_c, w0_c, gamma_c, beta_c = wave.to(dtype)[:, None, :], w0.to(dtype), gamma.to(dtype), beta.to(dtype)
        library = lambda: F.gelu(F.group_norm(F.conv1d(wave_c, w0_c, stride=wc.L0_STRIDE), wc.CHANNELS, gamma_c,
                                              beta_c, first.layer_norm.eps))
        library_name = "F.conv1d -> F.group_norm -> F.gelu in the compute dtype, [B, 512, T0], a 3-call chain"
    elif kernel == GN:
        t_valid, eps = shape[2], first.layer_norm.eps
        y_c = F.conv1d(wave.to(dtype)[:, None, :], w0.to(dtype), stride=wc.L0_STRIDE)  # [B, 512, T0], stock
        y = y_c.transpose(1, 2).contiguous()
        if y.shape[1] != shape[1]:
            raise AssertionError(f"{n} samples gave {y.shape[1]} layer-0 frames, want {shape[1]}")
        call = lambda: wc.gn_gelu(y, gamma, beta, t_valid, eps)
        plain = lambda: wc.gn_gelu_reference(y, gamma, beta, t_valid, eps)
        gamma_c, beta_c = gamma.to(dtype), beta.to(dtype)
        library = lambda: F.gelu(F.group_norm(y_c, wc.CHANNELS, gamma_c, beta_c, eps))  # statistics over every row
        library_name = "F.group_norm -> F.gelu in the compute dtype, [B, 512, T], a 2-call chain"
    else:
        x0 = wc.layer0_gn(wave, w0, gamma, beta, dtype=dtype)
        if x0.shape[1] != shape[1]:
            raise AssertionError(f"{n} samples gave {x0.shape[1]} layer-0 frames, want {shape[1]}")
        call = lambda: wc.conv_stack_fused(x0, tail_w)
        plain = lambda: wc.conv_tail_reference(x0, tail_w)
        x0_c, tail_c = x0.transpose(1, 2).contiguous(), [w.to(dtype) for w in tail_w]

        def library():
            x = x0_c
            for w in tail_c:
                x = F.gelu(F.conv1d(x, w, stride=2))
            return x

        library_name = "6 x (F.conv1d -> F.gelu) in the compute dtype, [B, 512, T], a 12-call chain"
    got = call()
    torch.cuda.synchronize()
    same = torch.equal(got, call())  # no float atomics: two calls give the same bits
    want = plain()
    diff = (got.float() - want.float()).abs()
    if dtype_name == "float32":
        atol, rtol = TOL[(kernel, dtype_name)]
        errs = {"out": (diff - atol - rtol * want.abs()).max().item()}
    else:
        errs = {"out": diff.max().item() - W2V_BF16_REL * want.float().abs().max().item()}
    row = {"kernel": kernel, "shape": shape, "dtype": dtype_name, "rate": 0.0, "max_abs_err": diff.max().item(),
           "largest_value": want.float().abs().max().item(), "excess": errs,
           "finite": bool(torch.isfinite(got.float()).all()), "same_bits": same}
    del got, want, diff
    time_device = functools.partial(device_ms, reps=2, replays=3)
    row.update(kernel_ms=time_device(call), kernel_eager_ms=eager_ms(call, iters=3, warmup=1),
               plain_ms=time_device(plain), library_ms=time_device(library), library=library_name)
    bytes_us, ops_us = w2v_bound(kernel, shape, dtype)
    row.update(bound_bytes_us=bytes_us, bound_ops_us=ops_us, bound_us=max(bytes_us, ops_us),
               bound_by="bytes" if bytes_us >= ops_us else "operations")
    log("kernel " + json.dumps(row))
    torch.cuda.empty_cache()  # the plain versions' f32 intermediates
    if not (errs["out"] <= 0 and row["finite"] and same):
        raise AssertionError(f"{kernel} disagrees with its plain version at {shape} {dtype_name}: "
                             f"excess over tolerance {errs}, same bits from two calls {same}")
    return row


def check_w2v_limit_fails_shifted(wc, frontend) -> None:
    """K6's bf16 limit has teeth: its output against the plain version of
    its input shifted by one frame (what a kernel that read tap j + 1 for tap
    j, or the wrong pair row, would compute) exceeds ``W2V_BF16_REL``, while
    against the true input it is within, at a split-K batch-2 plan and the
    export batch's."""
    first = frontend.conv_layers[0]
    w0, gamma, beta = first.conv.weight.detach(), first.layer_norm.weight.detach(), first.layer_norm.bias.detach()
    tail_w = [layer.conv.weight.detach() for layer in frontend.conv_layers[1:]]
    ratios = {}
    for b, n in W2V_SHIFT_SHAPES:
        x0 = wc.layer0_gn(w2v_waveforms(b, n, seed=n), w0, gamma, beta, dtype=torch.bfloat16)
        got = wc.conv_stack_fused(x0, tail_w)
        for name, x in (("true", x0), ("shifted", torch.cat([x0[:, 1:], x0[:, -1:]], 1))):
            want = wc.conv_tail_reference(x, tail_w).float()
            ratios[f"[{b}, {n}] {name}"] = ((got.float() - want).abs().max() / want.abs().max()).item()
    log(f"bf16 limit {W2V_BF16_REL} of the largest |value|, K6 against the plain version of its true and of its "
        f"shifted input: error over the largest |value| {json.dumps(ratios)}")
    if not all((r > W2V_BF16_REL) == ("shifted" in name) for name, r in ratios.items()):
        raise AssertionError(f"K6's bf16 limit would pass a kernel reading the wrong frame: {ratios}")


@contextlib.contextmanager
def plain_w2v_conv(wc):
    """The conv frontend through the plain versions instead of K7 and K6."""
    with mock.patch.object(wc, "layer0_gn", wc.layer0_gn_reference), \
            mock.patch.object(wc, "conv_stack_fused", wc.conv_tail_reference):
        yield


def w2v_config(tmp: str) -> str:
    """audio_wav2vec2/config.yaml, unchanged but for the checkpoint under ``tmp``."""
    import yaml

    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH

    path = os.path.join(tmp, "w2v.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(load_config(W2V_CONFIG_PATH).override(
            checkpoint__save_path=os.path.join(tmp, "w2v_ckpt", "checkpoint.ckpt")).to_dict(), f)
    return path


def w2v_phase(fa, wc, card: str, root: str, tmp: str, model) -> dict:
    """Phases 6d and 6e; returns the launches of the two wav2vec2 entry points."""
    from mer_tpu_torch.core import get_text, load_config, load_embeddings
    from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
    from mer_tpu_torch.feature_extractors.audio_wav2vec2 import embeddings as w2v_embeddings
    from mer_tpu_torch.feature_extractors.audio_wav2vec2 import test as w2v_test
    from mer_tpu_torch.models import save_reference_checkpoint

    cfg = w2v_config(tmp)
    config = load_config(cfg)
    os.makedirs(os.path.dirname(config.checkpoint.save_path))
    save_reference_checkpoint(config.checkpoint.save_path, model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"wav2vec2: AudioERC base config, {n_params} parameters, seeded checkpoint "
        f"{os.path.getsize(config.checkpoint.save_path)} bytes")
    argv = ["--config", cfg, "--data-root", root, "--random-init"]
    per_batch = {**ZERO, W2V0: 1, W2V_TAIL: 1, FWD: W2V_LAYERS}
    launches = dict(ZERO)

    # 6d. export: the three splits, bf16 (the config's compute dtype)
    save_dir = os.path.join(tmp, "embeddings_w2v")
    t0 = time.perf_counter()
    with main_path_run() as run:
        tables = w2v_embeddings.main(argv, save_dir=save_dir)
    seconds = time.perf_counter() - t0
    sizes = {mode: len(get_text(mode, root)) for mode in tables}
    n_batches = sum(math.ceil(n / W2V_EXPORT_BATCH) for n in sizes.values())
    want = {name: n * n_batches for name, n in per_batch.items()}
    log(f"wav2vec2 export: splits {sizes} in {seconds} s = {sum(sizes.values()) / seconds} clips/s (model build and "
        f"load included); launches {run} (want {want}: per batch of {W2V_EXPORT_BATCH} K7 once, K6 once, K1 "
        f"{W2V_LAYERS} times)")
    if run != want or sizes["test"] != 2608:
        raise AssertionError(f"wav2vec2 export launches {run}, want {want}; test split {sizes['test']} clips")
    for mode, table in tables.items():
        back = load_embeddings(os.path.join(save_dir, f"{mode}.pkl"))
        log(f"wav2vec2 export {mode}: {table.shape} {table.dtype}, finite {bool(np.isfinite(table).all())}, "
            f"mean |x| {float(np.abs(table).mean())}")
        if table.shape != (sizes[mode], 768) or table.dtype != np.float32 or not np.isfinite(table).all() \
                or not np.abs(table).sum(axis=1).all() or not np.array_equal(back, table):
            raise AssertionError(f"wav2vec2 export {mode}: bad table")
    for name in KERNELS:
        launches[name] += run[name]

    # 6e. evaluation: the test split at the config's batch size
    batch = int(config.test.data_loader.batch_size)
    t0 = time.perf_counter()
    with main_path_run() as run:
        result = w2v_test.main(argv)
    seconds = time.perf_counter() - t0
    n_batches = math.ceil(sizes["test"] / batch)
    want = {name: n * n_batches for name, n in per_batch.items()}
    log(f"wav2vec2 evaluation: {sizes['test']} clips in {n_batches} batches of {batch} in {seconds} s = "
        f"{sizes['test'] / seconds} clips/s (model build and load included): {json.dumps(result)}; launches {run} "
        f"(want {want})")
    if run != want or not all(math.isfinite(v) for v in result.values()) or not 0 <= result["accuracy"] <= 1:
        raise AssertionError(f"wav2vec2 evaluation launches {run}, want {want}; result {result}")
    for name in KERNELS:
        launches[name] += run[name]

    # throughput of the export on the test split alone, from a fresh wav store; the f32 one (--f32) is a counted
    # path: K6's f32 launches
    for dtype in (torch.bfloat16, torch.float32):
        model.set_compute_dtype(dtype)
        w2v_embeddings.export_split(model, Wav2Vec2FeatureDataset("val", data_root=root))  # warm-up
        test = Wav2Vec2FeatureDataset("test", data_root=root)
        widths = collections.Counter(b["audio"].shape[1] for b in Wav2Vec2Batcher(test, W2V_EXPORT_BATCH))
        test = Wav2Vec2FeatureDataset("test", data_root=root)
        torch.cuda.synchronize()
        with main_path_run() if dtype == torch.float32 else contextlib.nullcontext({}) as run:
            t0 = time.perf_counter()
            w2v_embeddings.export_split(model, test)  # ends in a device-to-host fetch
            seconds = time.perf_counter() - t0
        log(f"wav2vec2 export {DTYPE_LABELS[dtype]} test split: {len(test)} clips (wav decode, K7, K6, 12 layers) in "
            f"{seconds * 1e3} ms = {len(test) / seconds} clips/s; batch widths {dict(sorted(widths.items()))}"
            + (f"; launches {run}" if run else "") + f" ({card})")
        if dtype == torch.float32:
            want = {name: n * sum(widths.values()) for name, n in per_batch.items()}
            if run != want:
                raise AssertionError(f"wav2vec2 f32 export launches {run}, want {want}")
            for name in KERNELS:
                launches[name] += run[name]

    # one export batch: eager against device time, and where the device time goes
    model.set_compute_dtype(torch.bfloat16)
    batches = list(Wav2Vec2Batcher(Wav2Vec2FeatureDataset("test", data_root=root), W2V_EXPORT_BATCH))
    widest = max(batches, key=lambda b: b["audio"].shape[1])
    inputs = w2v_batch_to_inputs(widest, "cuda")
    with torch.inference_mode():
        step = lambda: model.embed(*inputs)
        eager = eager_ms(step, iters=5, warmup=2)
        device = device_ms(step, reps=1, replays=5)
        kernels, count = kernel_profile(step)
    log(f"wav2vec2 export batch bf16 {tuple(inputs[0].shape)}: eager {eager} ms, device-only (CUDA graph replay) "
        f"{device} ms, device idle share of the eager batch {1 - device / eager} ({card})")
    log_profile(kernels, count)
    model.set_compute_dtype(torch.float32)  # the same batch through the f32 export (--f32)
    with torch.inference_mode():
        eager = eager_ms(step, iters=5, warmup=2)
        device = device_ms(step, reps=1, replays=5)
        kernels, count = kernel_profile(step)
    log(f"wav2vec2 export batch f32 {tuple(inputs[0].shape)}: eager {eager} ms, device-only (CUDA graph replay) "
        f"{device} ms, device idle share of the eager batch {1 - device / eager} ({card})")
    log_profile(kernels, count)
    model.set_compute_dtype(torch.bfloat16)
    # one evaluation batch, at the width most of the first 64 have
    firsts = list(itertools.islice(Wav2Vec2Batcher(Wav2Vec2FeatureDataset("test", data_root=root), batch), 64))
    common = collections.Counter(b["audio"].shape[1] for b in firsts).most_common(1)[0][0]
    inputs = w2v_batch_to_inputs(next(b for b in firsts if b["audio"].shape[1] == common), "cuda")
    with torch.inference_mode():
        step = lambda: model(*inputs)
        eager = eager_ms(step, iters=20, warmup=3)
        device = device_ms(step, reps=1, replays=10)
        kernels, count = kernel_profile(step)
    log(f"wav2vec2 evaluation batch bf16 {tuple(inputs[0].shape)}: eager {eager} ms, device-only (CUDA graph replay) "
        f"{device} ms, device idle share of the eager batch {1 - device / eager} ({card})")
    log_profile(kernels, count)

    # f32: the same batches through the kernels and through the plain versions
    model.set_compute_dtype(torch.float32)
    eval_batches = list(Wav2Vec2Batcher(Wav2Vec2FeatureDataset("val", data_root=root), batch))[:2]
    worst = 0.0
    with torch.inference_mode():
        for b in [min(batches, key=lambda b: b["audio"].shape[1]), widest, *eval_batches]:
            args = w2v_batch_to_inputs(b, "cuda")
            with_kernels = model.embed(*args)
            with plain_w2v_conv(wc), plain_attention(fa):
                with_plain = model.embed(*args)
            err = (with_kernels - with_plain).abs().max().item()
            worst = max(worst, err)
            log(f"wav2vec2 f32 embeddings {tuple(args[0].shape)} -> {tuple(with_kernels.shape)}, kernels (K7, K6, K1) "
                f"vs plain versions: max abs diff {err}, largest value {with_plain.abs().max().item()} (tol 1e-3)")
            torch.cuda.empty_cache()
    if not worst <= 1e-3:
        raise AssertionError(f"f32 embeddings through the kernels differ from the plain versions by {worst}")
    return launches


# -- the conv frontend's profile entry point, text and wav2vec2 fine-tuning ------------


def profile_phase(card: str) -> dict:
    """Phase 6f; returns the launches of the conv frontend's profile entry point."""
    from mer_tpu_torch.scripts import profile_w2v_conv

    with main_path_run() as run:
        results = profile_w2v_conv.main(["32", "10", "--fused", "--l0fused", "--gnfused",
                                         "--repeats", str(PROFILE_REPEATS)])
    calls = 1 + 2 + PROFILE_REPEATS  # the numerics on two clips, two warm-up batches, the timed batches
    want = {**ZERO, W2V0: 2 * calls, W2V_TAIL: calls, GN: calls}
    log(f"profile_w2v_conv [32, 160000] bf16: {json.dumps(results)}; launches {run} (want {want}: per call K7 + K6 "
        f"for --fused, K7 for --l0fused, K8 for --gnfused; {calls} calls each) ({card})")
    if run != want:
        raise AssertionError(f"profile entry launches {run}, want {want}")
    for name, r in results.items():
        if not (r["max_rel_err"] <= PROFILE_BF16_REL and r["ms"] > 0):
            raise AssertionError(f"profile variant {name} departs from the stock stack: {r}")
    return run


@contextlib.contextmanager
def fe_training_probe():
    """Watch ``FESolver`` train: per training epoch its phase, steps, kernel
    launches and which parameters it changed; and the parameters the first two
    fine-tune updates left unchanged against the start of the fine-tune phase."""
    from mer_tpu_torch.train import fe_solver

    train_epoch, step = fe_solver.FESolver.train_epoch, fe_solver.accumulate_and_step
    probe = {"epochs": [], "unchanged_after_update": {}, "snapshot": None}
    wrappers = kernel_wrappers()
    counts = lambda: {name: w.launches for name, w in wrappers.items()}

    def unchanged(model, snapshot) -> set:
        return {n for n, p in model.named_parameters() if torch.equal(p.detach(), snapshot[n])}

    def probed_epoch(self, state, batcher, epoch):
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        if epoch == self.num_frozen_epochs:
            probe["snapshot"] = before
        start = counts()
        out = train_epoch(self, state, batcher, epoch)
        end = counts()
        probe["epochs"].append({"epoch": epoch, "phase": state.phase, "steps": len(batcher),
                                "launches": {k: end[k] - start[k] for k in end},
                                "unchanged": unchanged(state.model, before), "names": set(before)})
        return out

    def probed_step(train_state, accum, schedule):
        updated = step(train_state, accum, schedule)
        n = train_state.step // accum
        if updated and probe["snapshot"] is not None and n in (1, 2) and n not in probe["unchanged_after_update"]:
            probe["unchanged_after_update"][n] = unchanged(train_state.model, probe["snapshot"])
        return updated

    with mock.patch.object(fe_solver.FESolver, "train_epoch", probed_epoch), \
            mock.patch.object(fe_solver, "accumulate_and_step", probed_step):
        yield probe


def softmax_blind(name: str) -> bool:
    """A key bias shifts every score of a query alike, so the softmax and with
    it the loss ignore it: its gradient is rounding noise and may be exactly 0."""
    return name.endswith(("key.bias", "k_proj.bias"))


def check_fe_phases(what: str, probe: dict, backbone: str, per_step: dict) -> None:
    """The freeze / fine-tune contract on a probed run: launches per step of
    each phase (``per_step``: phase -> kernel -> launches), the head alone
    changed by the frozen epochs, nothing by the first fine-tune update (lr 0),
    and by the second every tensor whose step exceeds its rounding (the norms'
    weights sit at 1.0, where the warmup's first steps round away), and by the
    epoch's end every tensor the loss can see."""
    epochs = probe["epochs"]
    if [e["phase"] for e in epochs] != ["frozen"] * FE_FROZEN + ["finetune"] * (FE_EPOCHS - FE_FROZEN):
        raise AssertionError(f"{what}: phases {[e['phase'] for e in epochs]}")
    for e in epochs:
        want = {**ZERO, **{k: n * e["steps"] for k, n in per_step[e["phase"]].items()}}
        changed = e["names"] - e["unchanged"]
        log(f"{what} epoch {e['epoch']} ({e['phase']}, {e['steps']} steps): launches {e['launches']} (want {want}); "
            f"{len(changed)} of {len(e['names'])} parameter tensors changed")
        if e["launches"] != want:
            raise AssertionError(f"{what} epoch {e['epoch']}: launches {e['launches']}, want {want}")
        if e["phase"] == "frozen" and (any(n.startswith(backbone + ".") for n in changed)
                                       or changed != {n for n in e["names"] if not n.startswith(backbone + ".")}):
            raise AssertionError(f"{what} epoch {e['epoch']}: a frozen epoch must change the head alone: {changed}")
        if e["phase"] == "finetune" and not all(softmax_blind(n) for n in e["unchanged"]):
            raise AssertionError(f"{what} epoch {e['epoch']}: a fine-tune epoch left unchanged {e['unchanged']}")
    first, second = probe["unchanged_after_update"][1], probe["unchanged_after_update"][2]
    names = epochs[-1]["names"]
    is_norm_weight = lambda n: n.lower().endswith(("layernorm.weight", "layer_norm.weight"))
    log(f"{what}: the first fine-tune update (lr 0) left {len(first)} of {len(names)} tensors unchanged; the second "
        f"left {len(second)} ({sorted(second)[:4]}...: norm weights at 1.0 and key biases)")
    if first != names or not all(is_norm_weight(n) or softmax_blind(n) for n in second):
        raise AssertionError(f"{what}: first update changed {names - first}; second left {second}")


def fe_config(tmp: str, src: str, name: str, test_model_path: bool = False) -> str:
    """A feature-extractor config, unchanged but for its checkpoint under
    ``tmp`` (and ``test.model_path``, which the text evaluation reads, set to it)."""
    import yaml

    from mer_tpu_torch.core import load_config

    path = os.path.join(tmp, f"{name}.yaml")
    ckpt = os.path.join(tmp, f"{name}_ckpt", "checkpoint.ckpt")
    with open(path, "w") as f:
        overrides = {"test__model_path": ckpt} if test_model_path else {}
        yaml.safe_dump(load_config(src).override(checkpoint__save_path=ckpt, **overrides).to_dict(), f)
    return path


def profile_training_step(what: str, step, card: str) -> None:
    """One training step's eager time against its device time, and its kernels."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) / 5 * 1e3
    kernels, count = kernel_profile(step)
    busy = sum(kernels.values()) / 1e3
    log(f"{what}: eager {eager} ms (forward, backward, AdamW, loss fetch), device busy {busy} ms, device idle share "
        f"{1 - busy / eager if kernels else 'not measured'} ({card})")
    log_profile(kernels, count)


def text_phase(fa, card: str, root: str, tmp: str) -> dict:
    """Phase 6g; returns the launches of the three text entry points."""
    from mer_tpu_torch.core import get_text, load_config, load_embeddings
    from mer_tpu_torch.data.text_fe import TextBatcher, TextFeatureDataset, ToyWhitespaceTokenizer, \
        text_batch_to_inputs
    from mer_tpu_torch.feature_extractors.text import TEXT_CONFIG_PATH
    from mer_tpu_torch.feature_extractors.text import embeddings as text_embeddings
    from mer_tpu_torch.feature_extractors.text import test as text_test
    from mer_tpu_torch.feature_extractors.text import train as text_train
    from mer_tpu_torch.models.roberta import text_erc_from_seed
    from mer_tpu_torch.train.fe_solver import FESolver

    cfg = fe_config(tmp, TEXT_CONFIG_PATH, "text", test_model_path=True)  # evaluate what the training writes
    config = load_config(cfg)
    argv = ["--config", cfg, "--data-root", root, "--random-init", "--toy-tokenizer"]
    sizes = {mode: len(get_text(mode, root)) for mode in ("train", "val", "test")}
    batch = int(config.train.data_loader.batch_size)
    steps, val_batches = math.ceil(sizes["train"] / batch), math.ceil(sizes["val"] / batch)
    launches = dict(ZERO)

    # training: 2 frozen epochs + 1 fine-tune epoch, bf16 (the config's)
    t0 = time.perf_counter()
    with main_path_run() as run, fe_training_probe() as probe:
        state, history = text_train.main([*argv, "--epochs", str(FE_EPOCHS)])
    seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    bwd = backward_kernel(fa, 64)  # every token bucket (64, 128, 256) on one side of the threshold
    want = {**ZERO, FWD: TEXT_LAYERS * FE_EPOCHS * (steps + val_batches),
            bwd: TEXT_LAYERS * (FE_EPOCHS - FE_FROZEN) * steps}
    log(f"text training: TextERC base config, {n_params} parameters; {sizes['train']} train / {sizes['val']} val "
        f"utterances, {FE_EPOCHS} epochs of {steps} steps of {batch} in {seconds} s (model build, validation, "
        f"checkpoints included) = {FE_EPOCHS * sizes['train'] / seconds} utterances/s; losses {json.dumps(history)}; "
        f"launches {run} (want {want}: K1 {TEXT_LAYERS} per forward, {bwd} {TEXT_LAYERS} per fine-tune step) ({card})")
    if run != want:
        raise AssertionError(f"text training launches {run}, want {want}")
    if len(history["loss_values"]) != FE_EPOCHS or not all(
            math.isfinite(x) for x in history["loss_values"] + history["val_loss_values"]):
        raise AssertionError(f"text training losses not finite or epochs missing: {history}")
    check_fe_phases("text training", probe, "roberta",
                    {"frozen": {FWD: TEXT_LAYERS}, "finetune": {FWD: TEXT_LAYERS, bwd: TEXT_LAYERS}})
    if any(m.dtype != torch.float32 for st in state.finetune.optimizer.state.values() for m in st.values()):
        raise AssertionError("AdamW state is not float32 under bf16 compute")
    for name in KERNELS:
        launches[name] += run[name]
    del state, probe
    torch.cuda.empty_cache()

    # evaluation of the test split at the config's batch, from the trained checkpoint
    test_batch = int(config.test.data_loader.batch_size)
    t0 = time.perf_counter()
    with main_path_run() as run:
        result = text_test.main(argv)
    seconds = time.perf_counter() - t0
    want = {**ZERO, FWD: TEXT_LAYERS * math.ceil(sizes["test"] / test_batch)}
    log(f"text evaluation: {sizes['test']} utterances in batches of {test_batch} in {seconds} s = "
        f"{sizes['test'] / seconds} utterances/s (model build and load included): {json.dumps(result)}; launches "
        f"{run} (want {want}) ({card})")
    if run != want or sizes["test"] != 2608 or not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"text evaluation launches {run}, want {want}; result {result}")
    for name in KERNELS:
        launches[name] += run[name]

    # export of the three splits in batches of 32
    save_dir = os.path.join(tmp, "embeddings_text")
    t0 = time.perf_counter()
    with main_path_run() as run:
        tables = text_embeddings.main(argv, save_dir=save_dir)
    seconds = time.perf_counter() - t0
    n_batches = sum(math.ceil(n / text_embeddings.EXPORT_BATCH) for n in sizes.values())
    want = {**ZERO, FWD: TEXT_LAYERS * n_batches}
    log(f"text export: splits {sizes} in {seconds} s = {sum(sizes.values()) / seconds} utterances/s (model build and "
        f"load included); launches {run} (want {want}) ({card})")
    if run != want:
        raise AssertionError(f"text export launches {run}, want {want}")
    for mode, table in tables.items():
        back = load_embeddings(os.path.join(save_dir, f"{mode}.pkl"))
        log(f"text export {mode}: {table.shape} {table.dtype}, finite {bool(np.isfinite(table).all())}, "
            f"mean |x| {float(np.abs(table).mean())}")
        if table.shape != (sizes[mode], 768) or table.dtype != np.float32 or not np.isfinite(table).all() \
                or not np.abs(table).sum(axis=1).all() or not np.array_equal(back, table):
            raise AssertionError(f"text export {mode}: bad table")
    for name in KERNELS:
        launches[name] += run[name]

    # the token buckets the batches landed in; the test split's export alone; one fine-tune step
    tokenizer = ToyWhitespaceTokenizer(vocab_size=50265)
    datasets = {mode: TextFeatureDataset(mode, tokenizer, data_root=root) for mode in sizes}
    histogram = {f"{mode} batch {b}": dict(sorted(collections.Counter(
        x["text"].shape[1] for x in TextBatcher(datasets[mode], b)).items()))
        for mode, b in (("train", batch), ("val", batch), ("test", test_batch), ("test", text_embeddings.EXPORT_BATCH))}
    log(f"text token buckets (batches per width): {json.dumps(histogram)}")
    if not {64, 128, 256} <= {w for h in histogram.values() for w in h}:
        raise AssertionError(f"the synthetic root's context windows miss a token bucket: {histogram}")
    model = text_erc_from_seed(0, dtype=torch.bfloat16).cuda().eval()
    text_embeddings.export_split(model, datasets["val"])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text_embeddings.export_split(model, datasets["test"])  # ends in a device-to-host fetch
    seconds = time.perf_counter() - t0
    log(f"text export bf16 test split: {sizes['test']} utterances (tokenizer, 12 layers on K1, CLS row) in "
        f"{seconds * 1e3} ms = {sizes['test'] / seconds} utterances/s ({card})")
    solver = FESolver(model, config, backbone_key="roberta", batch_to_inputs=text_batch_to_inputs)
    state = solver.init_state(steps)
    batches = list(TextBatcher(datasets["train"], batch))
    widest = max(batches, key=lambda b: b["text"].shape[1])
    solver.train_epoch(state, batches, epoch=FE_FROZEN)  # warm-up: AdamW's state, the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.train_epoch(state, batches, epoch=FE_FROZEN)  # ends in a device-to-host fetch
    seconds = time.perf_counter() - t0
    log(f"text fine-tune bf16 epoch: {len(batches)} steps of {batch}, {sizes['train']} utterances in {seconds * 1e3} "
        f"ms = {sizes['train'] / seconds} utterances/s ({card})")
    profile_training_step(f"text fine-tune step bf16 {tuple(widest['text'].shape)}",
                          lambda: solver.train_epoch(state, [widest], epoch=FE_FROZEN), card)
    return launches


def w2v_training_phase(fa, wc, card: str, root: str, tmp: str) -> dict:
    """Phase 6h; returns the launches of the wav2vec2 training entry point."""
    from mer_tpu_torch.core import get_text, load_config
    from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
    from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
    from mer_tpu_torch.feature_extractors.audio_wav2vec2 import train as w2v_train
    from mer_tpu_torch.models.wav2vec2 import audio_erc_from_seed
    from mer_tpu_torch.train import load_checkpoint
    from mer_tpu_torch.train.fe_solver import FESolver

    cfg = fe_config(tmp, W2V_CONFIG_PATH, "w2v_train")
    config = load_config(cfg)
    argv = ["--config", cfg, "--data-root", root, "--random-init"]
    sizes = {mode: len(get_text(mode, root)) for mode in ("train", "val")}
    batch = int(config.get_path("tpu.batch_size_override"))
    steps, val_batches = math.ceil(sizes["train"] / batch), math.ceil(sizes["val"] / batch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with main_path_run() as run, fe_training_probe() as probe:
        state, history = w2v_train.main([*argv, "--epochs", str(FE_EPOCHS)])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    served = FE_FROZEN * steps + FE_EPOCHS * val_batches  # forwards whose frontend runs K7 and K6
    bwd = backward_kernel(fa, 99)  # every wave bucket (99-499 frames) on one side of the threshold
    want = {**ZERO, FWD: W2V_LAYERS * FE_EPOCHS * (steps + val_batches),
            bwd: W2V_LAYERS * (FE_EPOCHS - FE_FROZEN) * steps, W2V0: served, W2V_TAIL: served}
    log(f"wav2vec2 training: {sizes['train']} train / {sizes['val']} val clips, {FE_EPOCHS} epochs of {steps} steps "
        f"of {batch} in {seconds} s (model build, wav decode, validation, checkpoints included) = "
        f"{FE_EPOCHS * sizes['train'] / seconds} clips/s; peak device memory {peak} bytes; losses "
        f"{json.dumps(history)}; launches {run} (want {want}: K7 and K6 once per frozen step and validation batch, "
        f"never in a fine-tune step; K1 {W2V_LAYERS} per forward, {bwd} {W2V_LAYERS} per fine-tune step) ({card})")
    if run != want:
        raise AssertionError(f"wav2vec2 training launches {run}, want {want}")
    if len(history["loss_values"]) != FE_EPOCHS or not all(
            math.isfinite(x) for x in history["loss_values"] + history["val_loss_values"]):
        raise AssertionError(f"wav2vec2 training losses not finite or epochs missing: {history}")
    check_fe_phases("wav2vec2 training", probe, "wav2vec2",
                    {"frozen": {FWD: W2V_LAYERS, W2V0: 1, W2V_TAIL: 1}, "finetune": {FWD: W2V_LAYERS, bwd: W2V_LAYERS}})
    saved = load_checkpoint(config.checkpoint.save_path)
    if set(saved) != {"epoch", "model_state_dict"} or saved["epoch"] != FE_EPOCHS - 1:
        raise AssertionError(f"wav2vec2 checkpoint holds {set(saved)} at epoch {saved.get('epoch')}")
    del state, probe, saved
    torch.cuda.empty_cache()

    # one fine-tune epoch's throughput and one step's time split, bf16, at the widest batch
    model = audio_erc_from_seed(0, dtype=torch.bfloat16).cuda()
    solver = FESolver(model, config, backbone_key="wav2vec2", batch_to_inputs=w2v_batch_to_inputs)
    state = solver.init_state(steps)
    batches = list(Wav2Vec2Batcher(Wav2Vec2FeatureDataset("train", data_root=root), batch))
    widest = max(batches, key=lambda b: b["audio"].shape[1])
    for phase, epoch in (("frozen", 0), ("fine-tune", FE_FROZEN)):
        solver.train_epoch(state, batches[:2], epoch=epoch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.train_epoch(state, batches, epoch=epoch)  # ends in a device-to-host fetch
        seconds = time.perf_counter() - t0
        log(f"wav2vec2 {phase} bf16 epoch: {len(batches)} steps of {batch}, {sizes['train']} clips (LRU-cached wavs) in "
            f"{seconds * 1e3} ms = {sizes['train'] / seconds} clips/s ({card})")
    torch.cuda.reset_peak_memory_stats()
    profile_training_step(f"wav2vec2 fine-tune step bf16 {tuple(widest['audio'].shape)}",
                          lambda: solver.train_epoch(state, [widest], epoch=FE_FROZEN), card)
    log(f"wav2vec2 fine-tune step bf16 {tuple(widest['audio'].shape)}: peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes ({card})")
    del solver, state, model
    torch.cuda.empty_cache()

    # f32, dropout on (both versions draw the same masks): 2 frozen + 2 fine-tune steps through the kernels
    # against the plain versions, from the same weights on the same batches
    results = []
    for through in ("kernels", "plain"):
        model = audio_erc_from_seed(0, dtype=torch.float32).cuda()
        solver = FESolver(model, config, backbone_key="wav2vec2", batch_to_inputs=w2v_batch_to_inputs)
        state = solver.init_state(steps)
        with (contextlib.nullcontext() if through == "kernels" else plain_kernels(fa, wc)):
            losses = [solver.train_epoch(state, [b], epoch=epoch)[1]
                      for epoch in (0, FE_FROZEN) for b in (batches[0], widest)]
        results.append((losses, {n: p.detach().clone() for n, p in model.named_parameters()}))
        del solver, state, model
        torch.cuda.empty_cache()
    (k_losses, k_params), (p_losses, p_params) = results
    loss_diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    diffs = torch.cat([(k_params[n] - p_params[n]).abs().flatten() for n in k_params])
    lr = float(config.solver.frozen.lr)
    log(f"wav2vec2 training parity f32, 2 frozen + 2 fine-tune steps, kernels (K7, K6, K1, K2) vs plain versions: "
        f"losses {k_losses} vs {p_losses}, max diff {loss_diff} (tol 1e-4); params max diff {diffs.max().item()} "
        f"(tol {2 * lr * 2}: AdamW moves a parameter whose gradient is rounding noise by up to lr per step)")
    if not (loss_diff <= 1e-4 and diffs.max().item() <= 2 * lr * 2 + 1e-6):
        raise AssertionError("wav2vec2 training through the kernels departs from training through the plain versions")
    return run


@contextlib.contextmanager
def plain_kernels(fa, wc):
    with plain_w2v_conv(wc), plain_attention(fa):
        yield


# -- the e2e stream and the int8 engines ----------------------------------------------------


def device_idle_share(fn) -> tuple[float, float, float]:
    """(kernel-busy ms, wall ms, idle share) of one call of ``fn``: the union
    of the device's kernel intervals (copies and memsets left out) against
    the call's wall time, from a CUDA-only torch.profiler trace. The tracer
    slows the host's launches, so the wall here is longer than untraced."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        return float("nan"), wall_us / 1e3, float("nan")
    return busy / 1e3, wall_us / 1e3, 1.0 - busy / wall_us


@contextlib.contextmanager
def plain_mel(lk):
    """K5 through its plain version."""
    with mock.patch.object(lk, "logmel_frames", lk.logmel_frames_reference):
        yield


def log_e2e(what: str, result: dict, card: str) -> None:
    stages = result["stages"]
    log(f"e2e {what}: {result['n_utterances']} utterances in {result['seconds']} s = {result['utterances_per_sec']} "
        f"utterances/s, accuracy {result['accuracy']}, weighted F1 {result['weighted_f1']}; embed_h2d_bytes "
        f"{stages['embed_h2d_bytes']}; stages {json.dumps(stages)} ({card})")


def e2e_phase(fa, wc, lk, card: str, root: str) -> dict:
    """Phase 6l, the stream: ``python -m mer_tpu_torch.e2e_stream`` on the
    2,608-clip test split at full width (RoBERTa-base, wav2vec2-base, the
    config's M2FNet; bf16, batches of 32) for each of ``E2E_RUNS``: its
    launches exactly, utterances/s, stages, H2D bytes, the device's idle
    share of one more timed pass; the first batches of each branch in f32
    through the kernels against the plain versions; the mu-law and int8
    tables against the int16 bf16 ones; the native wav decoder against the
    stdlib reader. Returns the counted launches."""
    from mer_tpu_torch import e2e_stream
    from mer_tpu_torch.core import CONFIG_PATH, dialogue_index, get_text, load_config
    from mer_tpu_torch.data import native_wavio
    from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2FeatureDataset

    config = load_config(CONFIG_PATH)
    df = get_text("test", root)
    n_utt, n_batches = len(df), math.ceil(len(df) / E2E_BATCH)
    forwards = math.ceil(len(dialogue_index(df)) / int(config.test.data_loader.batch_size))
    per_forward = attention_calls_per_forward(config)
    argv = ["--data-root", root, "--toy-tokenizer"]
    launches = dict(ZERO)
    pipelines = {}
    real_setup = e2e_stream.setup
    for what, flags, passes in E2E_RUNS:
        mel = "--audio" in flags
        per_pass = {**ZERO, FWD: n_batches * TEXT_LAYERS + forwards * per_forward}
        if mel:
            per_pass[MEL] = n_batches
        else:
            per_pass.update({FWD: per_pass[FWD] + n_batches * W2V_LAYERS, W2V0: n_batches, W2V_TAIL: n_batches})
        want = {name: passes * n for name, n in per_pass.items()}
        made = []  # the entry point's pipeline, batches and table, for the passes after the counted run
        setup = lambda *a, **k: made.append(real_setup(*a, **k)) or made[-1]
        with main_path_run() as run, mock.patch.object(e2e_stream, "setup", setup):
            if passes == 2:  # the entry point itself: a warm pass, then the timed one
                result = e2e_stream.main(argv + flags)
            else:
                pipeline, batches, table = e2e_stream.setup(e2e_stream.parse_args(argv + flags))
                result = pipeline.run(batches(), table)
        pipeline, batches, table = made[0]
        log_e2e(what, result, card)
        log(f"  launches {run} (want {want}: per pass {n_batches} text batches x K1 {TEXT_LAYERS}, "
            + (f"{n_batches} mel batches x K5 1, " if mel else
               f"{n_batches} wav2vec2 batches x (K7 1, K6 1, K1 {W2V_LAYERS}), ")
            + f"{forwards} fusion forwards x K1 {per_forward})")
        if run != want or result["n_utterances"] != n_utt or not 0.0 <= result["accuracy"] <= 1.0:
            raise AssertionError(f"e2e {what}: launches {run}, want {want}; result {result}")
        for name in KERNELS:
            launches[name] += run[name]
        busy, wall, idle = device_idle_share(lambda: pipeline.run(batches(), table))
        log(f"  device idle share of the timed pass {1.0 - busy / (result['seconds'] * 1e3)}: {busy} ms of kernels "
            f"in one more pass under the profiler (its wall {wall} ms, idle {idle}) against the timed pass's "
            f"{result['seconds'] * 1e3} ms ({card})")
        pipelines[what] = (pipeline, batches)

    # the f32 tables of the first batches of each branch: kernels against plain versions
    worst = 0.0
    for what in ("wav2vec2, int16 wire", "mel, int16 wire"):
        pipeline, batches = pipelines[what]
        models = [pipeline.m.text_model] + ([] if pipeline.audio_kind == "mel" else [pipeline.m.audio_model])
        for model in models:
            model.set_compute_dtype(torch.float32)
        head = list(itertools.islice(batches(), E2E_PLAIN_BATCHES))
        tables = pipeline.embed_utterances(iter(head))
        with plain_kernels(fa, wc), plain_mel(lk):
            plain = pipeline.embed_utterances(iter(head))
        for name, got, ref in zip(("text", "audio"), tables, plain):
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            log(f"e2e {what} f32 {name} table {got.shape} of {E2E_PLAIN_BATCHES} batches, kernels vs plain versions: "
                f"max abs diff {err}, largest value {float(np.abs(ref).max())} (tol 1e-3)")
        for model in models:
            model.set_compute_dtype(torch.bfloat16)
    if not worst <= 1e-3:
        raise AssertionError(f"e2e f32 tables through the kernels differ from the plain versions by {worst}")

    # the mu-law and int8 tables against the int16 bf16 ones, on the first batches
    def head_tables(what):
        pipeline, batches = pipelines[what]
        return pipeline.embed_utterances(itertools.islice(batches(), E2E_ENVELOPE_BATCHES))

    exact_t, exact_a = head_tables("wav2vec2, int16 wire")
    mulaw_t, mulaw_a = head_tables("wav2vec2, mu-law wire")
    int8_t, int8_a = head_tables("int8 engines, wav2vec2, int16 wire")
    rel = lambda got, want: float(np.abs(got - want).max() / np.abs(want).max())
    mulaw_rel = float(np.linalg.norm(mulaw_a - exact_a) / np.linalg.norm(exact_a))
    int8_rel = (rel(int8_t, exact_t), rel(int8_a, exact_a))
    log(f"e2e envelopes over {len(exact_t)} utterances: mu-law audio table off the int16 one by {mulaw_rel} of its "
        f"norm (tol {MULAW_REL}; the text tables, which the wire does not reach, by {rel(mulaw_t, exact_t)} of their "
        f"largest |value|); int8 text and audio tables off the bf16 ones by {int8_rel} of their largest |value| "
        f"(tol {INT8_ENCODER_REL})")
    if not (mulaw_rel < MULAW_REL and max(int8_rel) < INT8_ENCODER_REL):
        raise AssertionError("e2e mu-law or int8 tables outside their envelopes")
    del pipelines
    torch.cuda.empty_cache()

    # the native wav decoder against the stdlib reader, batch by batch in the stream's order
    native_ds = Wav2Vec2FeatureDataset("test", data_root=root)
    lengths = native_ds.waveform_lengths()
    order = np.argsort(lengths, kind="stable")
    ladder = tuple(int(x * native_ds.sample_rate) for x in (2.0, 4.0, 6.0, 8.0, 10.0))
    plan = [(idx, next((b for b in ladder if int(lengths[idx].max()) <= b), ladder[-1]))
            for idx in (order[i: i + E2E_BATCH] for i in range(0, len(order), E2E_BATCH))]
    native_wavio.load()  # built before the clock starts
    t0 = time.perf_counter()
    native = [native_ds.waveform_batch(idx, width) for idx, width in plan]
    native_ms = (time.perf_counter() - t0) * 1e3 / len(plan)
    stdlib_ds = Wav2Vec2FeatureDataset("test", data_root=root)  # a fresh store: no clip cached
    with mock.patch.dict(os.environ, {"MER_TPU_NATIVE": "0"}):
        t0 = time.perf_counter()
        stdlib = [stdlib_ds.waveform_batch(idx, width) for idx, width in plan]
        stdlib_ms = (time.perf_counter() - t0) * 1e3 / len(plan)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(native, stdlib))
    log(f"wav decode of the test split in the stream's {len(plan)} batches of {E2E_BATCH}: native {native_ms} ms a "
        f"batch, stdlib reader {stdlib_ms} ms a batch ({stdlib_ms / native_ms} times), equal bits on every batch "
        f"{same} (host: {os.cpu_count()} cores)")
    if not same:
        raise AssertionError("the native wav decoder and the stdlib reader disagree")
    return launches


def int8_phase(card: str, tmp: str) -> dict:
    """Phase 6l, the int8 legs: ``python -m mer_tpu_torch.test --synthetic
    --int8`` (17 K1 a forward), its logits against the bf16 model's within
    ``INT8_FUSION_REL`` of their largest |value| and its utterances/s, and
    ``.serve --synthetic --int8 --requests 280``. Returns the counted launches."""
    from mer_tpu_torch import serve as serve_entry
    from mer_tpu_torch import test as eval_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.models import M2FNet, init_random_, save_reference_checkpoint
    from mer_tpu_torch.serving import BatchedPredictor, M2FNetInt8, quantize_m2fnet
    from mer_tpu_torch.serving.engine import build_model, predict_fn

    config = load_config(CONFIG_PATH)
    per_forward = attention_calls_per_forward(config)
    batches = eval_entry.eval_batches(config, eval_entry.eval_dataset(config, synthetic=True))
    n_utt = int(sum((b["emotion"] != -1).sum() for b in batches))
    ckpt = os.path.join(tmp, "m2fnet_int8.pth")
    save_reference_checkpoint(ckpt, init_random_(M2FNet.from_config(config.model), torch.Generator().manual_seed(0)))
    launches = dict(ZERO)
    with main_path_run() as run:
        summary = eval_entry.main(["--synthetic", "--checkpoint", ckpt, "--int8"])
    want = {**ZERO, FWD: per_forward * len(batches)}
    log(f"offline int8: {json.dumps(summary)}; launches {run} (want {want})")
    if run != want:
        raise AssertionError(f"offline int8 launches {run}, want {want}")
    launches[FWD] += run[FWD]

    f32 = build_model(config, torch.device("cuda"), checkpoint=ckpt, dtype=torch.float32)
    bf16 = build_model(config, torch.device("cuda"), checkpoint=ckpt)
    qparams, engine = quantize_m2fnet(f32), M2FNetInt8(f32)
    worst = largest = 0.0
    with torch.inference_mode():
        for b in batches:
            args = embeddings(b)
            valid = torch.from_numpy(b["emotion"] != -1).cuda()
            got, ref = engine.apply(qparams, *args)[valid], bf16(*args).float()[valid]
            worst, largest = max(worst, (got - ref).abs().max().item()), max(largest, ref.abs().max().item())
    feed = [{k: b[k] for k in ("text", "audio", "padding_mask")} for b in batches]
    predictor = BatchedPredictor(predict_fn(f32, int8=True), "cuda")
    predictor(feed)  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        predictor(feed)
        times.append(time.perf_counter() - t0)
    log(f"offline int8 logits against bf16 over {n_utt} utterances: max abs diff {worst} = {worst / largest} of the "
        f"largest |logit| (tol {INT8_FUSION_REL}); batch 32: median {np.median(times) * 1e3} ms = "
        f"{n_utt / np.median(times)} utterances/s ({card})")
    if not worst <= INT8_FUSION_REL * largest:
        raise AssertionError(f"int8 logits off bf16 by {worst / largest} of the largest |logit|")

    with main_path_run() as run:
        report = serve_entry.main(["--synthetic", "--requests", str(ONLINE_REQUESTS[-1]), "--int8"])
    log(f"online int8 {ONLINE_REQUESTS[-1]} requests: {report['utterances_per_s']} utterances/s, p50 "
        f"{report['latency_ms_p50']} ms, p99 {report['latency_ms_p99']} ms, {report['batches']} micro-batches; "
        f"launches {run} ({card})")
    if report["requests"] != ONLINE_REQUESTS[-1] or report["mode"] != "int8" or run[FWD] == 0 \
            or run[FWD] % per_forward or run != {**ZERO, FWD: run[FWD]}:
        raise AssertionError(f"online int8 answered {report['requests']} requests with launches {run}")
    launches[FWD] += run[FWD]
    return launches


# -- long-sequence attention: K3, K4, the long-clip wav2vec2 path, the bench entry, P ----------


def check_seam(fa, kernel: str, shape, dtype: str, i: int) -> None:
    """K1 against K3 or K2 against K4 at the dispatch's threshold, on the
    same inputs (every batch element attending to most of its keys), within
    the kernel-vs-plain limits."""
    from mer_tpu_torch.scripts.parallel_check import sum_bound

    q, k, v, g, mask = attention_inputs(shape, DTYPES[dtype], seed=i, clips=True)
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    sums = None
    if kernel == FWD:
        names, got, want = ("out", "lse"), fa.flash_attention_stream(q, k, v, mask), (out, lse)
        what = "K1 | K3"
        if dtype == "bfloat16":
            sums = sum_bound(fa.flash_attention_stream_reference, q, k, v, mask)
    else:
        names, want = ("dq", "dk", "dv"), fa.flash_attention_backward(q, k, v, mask, out, lse, g)
        got, what = fa.flash_attention_tiled_backward(q, k, v, mask, out, lse, g), "K2 | K4"
    torch.cuda.synchronize()
    errs = attention_errors(names, got, want, dtype, sums)
    diffs = {name: (a.float() - b.float()).abs().max().item() for name, a, b in zip(names, got, want)}
    largest = {name: b.float().abs().max().item() for name, b in zip(names, want)}
    log(f"seam {what} at {shape} {dtype}: max abs diff {json.dumps(diffs)}, largest |value| {json.dumps(largest)}, "
        f"excess over the limit {json.dumps(errs)}")
    if not all(e <= 0 for e in errs.values()):
        raise AssertionError(f"{what} disagree at {shape} {dtype}: {errs}")


def check_limit_fails_wrong_tiles(fa, i: int) -> None:
    """The bf16 limit has teeth: K1 and K3 handed V, and K2 and K4 handed K,
    whose keys past the first 64 are rolled by 64 (as a kernel that reads the
    wrong tile after its first) exceed ``ATTENTION_BF16_REL`` against the
    plain versions on the true inputs, by a wide margin: K1 and K2 at the
    wav2vec2 shape, K3 and K4 at 8,192 keys."""
    wrong = lambda t: torch.cat([t[:, :, :64], t[:, :, 64:].roll(64, 2)], 2).contiguous()
    ratios = {}
    for names, shape, plain_fwd, plain_bwd, fwd, bwd in (
            (("K1", "K2"), (2, 12, 499, 499, 64), fa.flash_attention_reference,
             fa.flash_attention_backward_reference, fa.flash_attention_forward, fa.flash_attention_backward),
            (("K3", "K4"), (2, 1, 8192, 8192, 64), fa.flash_attention_stream_reference,
             fa.flash_attention_tiled_backward_reference, fa.flash_attention_stream, fa.flash_attention_tiled_backward)):
        q, k, v, g, mask = attention_inputs(shape, torch.bfloat16, seed=i, clips=True)
        ref_out, ref_lse = plain_fwd(q, k, v, mask)
        call = lambda: fwd(q, k, wrong(v), mask)[0]
        pairs = {f"{names[0]} out": (k1_routed(fa, call, "wgmma_bf16") if names[0] == "K1" else call(), ref_out)}
        ref = plain_bwd(q, k, v, mask, ref_out, ref_lse, g)
        bad = bwd(q, wrong(k), v, mask, ref_out, ref_lse, g)
        pairs.update({f"{names[1]} {name}": (a, b) for name, a, b in zip(("dq", "dk", "dv"), bad, ref)})
        for name, (a, b) in pairs.items():
            ratios[name] = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    log(f"bf16 limit {ATTENTION_BF16_REL} of the largest |value|, against K1-K4 fed rolled key tiles: error over "
        f"the largest |value| {json.dumps(ratios)}")
    if not all(r > 4 * ATTENTION_BF16_REL for r in ratios.values()):
        raise AssertionError(f"the bf16 limit would pass a kernel reading the wrong tiles: {ratios}")


def long_kernel_checks(fa, first_case: int) -> list[dict]:
    """Phase 3b: K3 and K4 against their plain versions in f32 and bf16, with
    a key mask, with a fully masked batch element and with dropout 0.1; the
    K1 | K3 and K2 | K4 seams; the bf16 limit against wrong tiles; K3's and
    K4's dropout masks read off exactly."""
    rows, i = [], first_case
    for kernel, shapes in ((STREAM, STREAM_SHAPES), (TILED, TILED_SHAPES)):
        for shape in shapes:
            for dtype in DTYPES:
                for fully_masked, rate in ((False, 0.0), (True, 0.0), (False, LONG_DROPOUT)):
                    rows.append(check_case(fa, kernel, shape, dtype, rate, i, timed=False, fully_masked=fully_masked))
                    i += 1
    for kernel, keys in ((FWD, fa.STREAM_THRESHOLD), (BWD, fa.BWD_FUSED_MAX)):
        for dtype in DTYPES:
            check_seam(fa, kernel, (*SEAM_BH, keys, keys, 64), dtype, i)
            i += 1
    check_limit_fails_wrong_tiles(fa, i)
    for dtype in DTYPES.values():
        check_dropout_masks(fa, 2, 2, 130, 100, LONG_DROPOUT, long=True, dtype=dtype)
    return rows


def long_clip_phase(fa, wc, card: str, tmp: str) -> dict:
    """Phase 6i: the wav2vec2 extractor on clips of 45-90 s at full width;
    returns the launches of its export and fine-tune runs."""
    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.data import write_synthetic_meld
    from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset, w2v_batch_to_inputs
    from mer_tpu_torch.feature_extractors.audio_wav2vec2 import W2V_CONFIG_PATH
    from mer_tpu_torch.feature_extractors.audio_wav2vec2.embeddings import export_split
    from mer_tpu_torch.models.wav2vec2 import Wav2Vec2Config, audio_erc_from_seed
    from mer_tpu_torch.train.fe_solver import FESolver

    t0 = time.perf_counter()
    root = os.path.join(tmp, "meld_90s")
    counts = write_synthetic_meld(root, split_dialogues=LONG_SPLITS, clip_seconds=LONG_SECONDS, max_utterances=1)
    data = {mode: Wav2Vec2FeatureDataset(mode, data_root=root, max_seconds=LONG_BUCKETS[-1])
            for mode in ("train", "test")}
    log(f"long-clip root {counts}, clips of {LONG_SECONDS} s, buckets {LONG_BUCKETS} s, in "
        f"{time.perf_counter() - t0:.1f} s")
    frames = Wav2Vec2Config.base().feat_extract_output_lengths
    forward_kernel = lambda width: STREAM if frames(width) > fa.STREAM_THRESHOLD else FWD
    launches = dict(ZERO)

    # export of the test clips, bf16 (the config's), batches of 2: K7, K6 and 12 attention forwards a batch
    model = audio_erc_from_seed(0, dtype=torch.bfloat16).cuda().eval()
    widths = [b["audio"].shape[1] for b in Wav2Vec2Batcher(data["test"], LONG_BATCH, seconds_buckets=LONG_BUCKETS)]
    want = {**ZERO, W2V0: len(widths), W2V_TAIL: len(widths)}
    for width in widths:
        want[forward_kernel(width)] += W2V_LAYERS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with main_path_run() as run:
        table = export_split(model, data["test"], LONG_BATCH, LONG_BUCKETS)
    seconds = time.perf_counter() - t0
    log(f"long-clip export: {len(data['test'])} test clips in batches of {LONG_BATCH} at widths {widths} "
        f"({[frames(w) for w in widths]} frames) in {seconds} s = {len(data['test']) / seconds} clips/s (first "
        f"batches at these shapes); launches {run} (want {want}) ({card})")
    if run != want:
        raise AssertionError(f"long-clip export launches {run}, want {want}")
    if table.shape != (len(data["test"]), W2V_HIDDEN) or not np.isfinite(table).all() or \
            not (np.abs(table).sum(1) > 0).all():
        raise AssertionError(f"long-clip export table {table.shape}: not finite or rows missing")
    for name, n in run.items():
        launches[name] += n
    # the same export in f32 (--f32): K7, K6 and the 12 forwards in f32 (K3 in the 90 s bucket, K1 in the 60 s one);
    # a first export at these shapes warms the allocator, the second is timed and counted
    model.set_compute_dtype(torch.float32)
    export_split(model, data["test"], LONG_BATCH, LONG_BUCKETS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with main_path_run() as run:
        table = export_split(model, data["test"], LONG_BATCH, LONG_BUCKETS)  # ends in a device-to-host fetch
    seconds = time.perf_counter() - t0
    log(f"long-clip export f32: {len(data['test'])} test clips in batches of {LONG_BATCH} in {seconds * 1e3} ms = "
        f"{len(data['test']) / seconds} clips/s; launches {run} (want {want}: per batch K7 1, K6 1, 12 forwards) "
        f"({card})")
    if run != want:
        raise AssertionError(f"long-clip f32 export launches {run}, want {want}")
    if table.shape != (len(data["test"]), W2V_HIDDEN) or not np.isfinite(table).all() or \
            not (np.abs(table).sum(1) > 0).all():
        raise AssertionError(f"long-clip f32 export table {table.shape}: not finite or rows missing")
    for name, n in run.items():
        launches[name] += n
    del model
    torch.cuda.empty_cache()

    # fine-tuning at batch 2, bf16, attention dropout 0.1: the stock convolutions, 12 attention forwards and
    # 12 K4 a step
    config = load_config(fe_config(tmp, W2V_CONFIG_PATH, "w2v_long"))
    model = audio_erc_from_seed(0, dtype=torch.bfloat16).cuda()
    solver = FESolver(model, config, backbone_key="wav2vec2", batch_to_inputs=w2v_batch_to_inputs)
    state = solver.init_state(LONG_STEPS)
    batches = list(Wav2Vec2Batcher(data["train"], LONG_BATCH, shuffle=True, seconds_buckets=LONG_BUCKETS))
    want = {**ZERO, TILED: W2V_LAYERS * len(batches)}
    for b in batches:
        want[forward_kernel(b["audio"].shape[1])] += W2V_LAYERS
    torch.cuda.reset_peak_memory_stats()
    with main_path_run() as run:
        state, loss = solver.train_epoch(state, batches, epoch=FE_FROZEN)
    log(f"long-clip fine-tune: {len(batches)} steps of {LONG_BATCH} at widths {[b['audio'].shape[1] for b in batches]}, "
        f"loss {loss}; launches {run} (want {want}: per step 12 K1 (60 s) or K3 (90 s) and 12 K4; no K2, K7, K6)")
    if run != want or len(batches) != LONG_STEPS or not math.isfinite(loss):
        raise AssertionError(f"long-clip fine-tune launches {run}, want {want}; loss {loss}")
    for name, n in run.items():
        launches[name] += n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.train_epoch(state, batches, epoch=FE_FROZEN)  # ends in a device-to-host fetch
    seconds = time.perf_counter() - t0
    log(f"long-clip fine-tune bf16 epoch: {len(batches)} steps, {len(batches) * LONG_BATCH} clips of 45-90 s in "
        f"{seconds * 1e3} ms = {len(batches) * LONG_BATCH / seconds} clips/s ({card})")
    widest = max(batches, key=lambda b: b["audio"].shape[1])
    profile_training_step(f"long-clip fine-tune step bf16 {tuple(widest['audio'].shape)}",
                          lambda: solver.train_epoch(state, [widest], epoch=FE_FROZEN), card)
    log(f"long-clip fine-tune bf16: peak device memory {torch.cuda.max_memory_allocated()} bytes ({card})")
    del solver, state, model
    torch.cuda.empty_cache()
    long_clip_parity(fa, wc, config, widest)
    return launches


def long_clip_parity(fa, wc, config, batch) -> None:
    """One f32 fine-tune step at the 90 s bucket (dropout on, the same seeds):
    loss and gradients through K3 and K4 against the plain versions."""
    from mer_tpu_torch.data.wav2vec2_fe import w2v_batch_to_inputs
    from mer_tpu_torch.models import set_attention_generator
    from mer_tpu_torch.models.wav2vec2 import audio_erc_from_seed
    from mer_tpu_torch.objectives.classification import cross_entropy
    from mer_tpu_torch.utils import seed_dropout, seed_step

    seed = int(config.get_path("tpu.seed", 0))
    labels = torch.from_numpy(batch["emotion"]).cuda()
    results = []
    for through in ("kernels", "plain"):
        model = audio_erc_from_seed(0, dtype=torch.float32).cuda().train()
        generator = seed_dropout(seed)
        set_attention_generator(model, generator)
        seed_step(seed, 0, generator)
        before = fa.flash_attention_stream.launches, fa.flash_attention_tiled_backward.launches
        with contextlib.nullcontext() if through == "kernels" else plain_kernels(fa, wc):
            loss = cross_entropy(model(*w2v_batch_to_inputs(batch, "cuda")), labels, ignore_index=-1)
            loss.backward()
        ran = fa.flash_attention_stream.launches - before[0], fa.flash_attention_tiled_backward.launches - before[1]
        if ran != ((W2V_LAYERS, W2V_LAYERS) if through == "kernels" else (0, 0)):
            raise AssertionError(f"f32 long-clip step through the {through}: K3, K4 launches {ran}")
        results.append((loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
        del model, loss
        torch.cuda.empty_cache()
    (k_loss, k_grads), (p_loss, p_grads) = results
    worst, worst_name = 0.0, None
    for name, want in p_grads.items():
        if softmax_blind(name):
            continue
        rel = (k_grads[name] - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f"long-clip f32 fine-tune step {tuple(batch['audio'].shape)}, K3 + K4 against the plain versions: loss "
        f"{k_loss} vs {p_loss} (diff {abs(k_loss - p_loss)}, tol 1e-4); gradients: largest difference over the "
        f"tensor's largest entry {worst} at {worst_name} (tol 1e-3; key biases, whose gradient is rounding noise, "
        f"left out)")
    if not (abs(k_loss - p_loss) <= 1e-4 and worst <= 1e-3):
        raise AssertionError("the f32 long-clip step through K3 and K4 departs from the plain versions")


# -- parallelism: dp, tp and ZeRO-1 over torch.distributed, ring attention (phase 6m) -----------------


def parallel_config(tmp: str, name: str, dtype: str, zero1: bool, ckpt: str | None = None) -> str:
    """``src/config.yaml`` at its width, dropout 0 (ranks would draw their own masks), ``dtype`` compute."""
    import yaml

    from mer_tpu_torch.core import CONFIG_PATH, load_config

    config = load_config(CONFIG_PATH).override(model__dropout=0.0, tpu__compute_dtype=dtype, tpu__zero1=zero1)
    if ckpt is not None:
        config = config.override(checkpoint__save_path=ckpt, checkpoint__load_path=ckpt)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(config.to_dict(), f)
    return path


def parallel_steps(cfg_path: str, mesh=None):
    """``parallel_check.fusion_steps`` on the card from the config at
    ``cfg_path``, the steps a counted main-path run."""
    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.parallel.mesh import Mesh
    from mer_tpu_torch.scripts import parallel_check

    return parallel_check.fusion_steps(load_config(cfg_path), mesh or Mesh(), "cuda", main_path_run)


def parallel_rank(rank: int, port: str, workdir: str, job: str = "fusion") -> None:
    """One of the two ranks of phase 6m or 6n (``chip_smoke.py
    --parallel-rank R PORT DIR [pp]``): gloo on the one card, every
    PARALLEL_CASES case (6m) or PP_CASES case (6n); each rank writes its
    losses, launches, optimizer bytes and path shapes, rank 0 the weights."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from mer_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://localhost:{port}", world_size=2, rank=rank, backend="gloo",
                           device="cuda:0")
    out = {}
    if job == "pp":
        from mer_tpu_torch.scripts import parallel_check

        for name, kind, remat in PP_CASES:
            PATH_SHAPES.clear()
            losses, weights, seconds, run = parallel_check.fe_pp_steps(
                kind, make_mesh(pp=2), torch.device("cuda"), torch.bfloat16, remat=remat, count=main_path_run)
            out[name] = {"losses": losses, "seconds": seconds, "launches": run,
                         "shapes": [[k[0], list(k[1]), k[2], k[3], n] for k, n in PATH_SHAPES.items()]}
            if rank == 0:
                torch.save(weights, os.path.join(workdir, f"{name}.pt"))
            dist.barrier()
        with open(os.path.join(workdir, f"pp_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
        return
    for name, dp, tp, zero1, dtype in PARALLEL_CASES:
        PATH_SHAPES.clear()
        losses, weights, nbytes, run = parallel_steps(os.path.join(workdir, f"{dtype}_{zero1}.yaml"),
                                                      make_mesh(dp=dp, tp=tp))
        out[name] = {"losses": losses, "optimizer_bytes": nbytes, "launches": run,
                     "shapes": [[k[0], list(k[1]), k[2], k[3], n] for k, n in PATH_SHAPES.items()]}
        if rank == 0:
            torch.save(weights, os.path.join(workdir, f"{name}.pt"))
        dist.barrier()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def ring_inputs(shape, dtype, seed: int):
    """q, k, v, g [B, H, S, Dh] at the main path's scale and the long clips'
    padding: element 0 whole, element 1 (when B > 1) padded from 2/3 of S on
    (a whole shard at sp = 4); element 0 of a one-clip batch pads its last
    tenth."""
    b, h, s, dh = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = ((torch.randn(b, h, s, dh, generator=gen) / 3 ** 0.5).to("cuda", dtype) for _ in range(4))
    mask = torch.zeros(b, s, dtype=torch.bool)
    if b > 1:
        mask[1, 2 * s // 3:] = True
    else:
        mask[0, s - s // 10:] = True
    return q, k, v, g, mask.cuda()


def ring_phase(fa, card: str) -> dict:
    """Phase 6m's ring: the local ring (sp shards on the card) at wav2vec2-base
    width, forward and backward, against the plain full attention; the
    launches of each call (counted: a main path of this slice)."""
    from mer_tpu_torch.ops import ring_attention as ra
    from mer_tpu_torch.scripts import parallel_check

    launches = dict(ZERO)
    for i, (shape, sp) in enumerate(RING_CASES):
        b, h, s, dh = shape
        blocks = s // sp
        fwd = STREAM if blocks > fa.STREAM_THRESHOLD else FWD
        for dtype_name, dtype in DTYPES.items():
            q, k, v, g, mask = ring_inputs(shape, dtype, 600 + i)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            with main_path_run() as run:
                out = ra.ring_attention(*leaves, key_padding_mask=mask, sp=sp)
                out.backward(g)
            torch.cuda.synchronize()
            want_run = {**ZERO, fwd: sp * sp, backward_kernel(fa, blocks): sp * sp}
            if run != want_run:
                raise AssertionError(f"ring {shape} sp={sp} {dtype_name}: launches {run}, want {want_run} "
                                     f"({sp} a ring step, {sp} steps)")
            for name, n in run.items():
                launches[name] += n
            errs = parallel_check.ring_errors([out.detach(), *(t.grad for t in leaves)], q, k, v, g, mask)
            with torch.no_grad():
                ring_ms = device_ms(lambda: ra.ring_attention(q, k, v, key_padding_mask=mask, sp=sp), reps=3,
                                    replays=3)
                whole_ms = device_ms(lambda: fa.flash_attention_forward(q, k, v, mask), reps=3, replays=3)
            whole = STREAM if s > fa.STREAM_THRESHOLD else FWD
            log(f"ring {shape} sp={sp} {dtype_name}: per ring step {sp} {fwd} + {sp} "
                f"{backward_kernel(fa, blocks)} (launches {run}); excess over the limit {json.dumps(errs)} "
                f"(<= 0 passes); forward {ring_ms} ms a call against {whole} on the whole sequence {whole_ms} ms "
                f"({card})")
            if max(errs.values()) > 0:
                raise AssertionError(f"ring {shape} sp={sp} {dtype_name} departs from the plain attention: {errs}")
    return launches


def parallel_phase(fa, card: str) -> dict:
    """Phase 6m; returns the launches of the two-rank steps and the ring."""
    from mer_tpu_torch import train as train_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.scripts import parallel_check
    from mer_tpu_torch.train import load_checkpoint

    t0 = time.perf_counter()
    launches = dict(ZERO)
    steps = parallel_check.STEPS
    with tempfile.TemporaryDirectory() as tmp:
        # torchrun, one rank: tpu.zero1 with one dp rank is the single-process run
        ckpts = {which: os.path.join(tmp, which, "m2fnet.ckpt") for which in ("torchrun", "single")}
        torchrun = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
                                   "--master-port", str(free_port()), "-m", "mer_tpu_torch.train", "--synthetic",
                                   "--epochs", "1", "--config",
                                   parallel_config(tmp, "torchrun.yaml", "bfloat16", True, ckpts["torchrun"])],
                                  cwd=REPO, capture_output=True, text=True, timeout=300)
        if torchrun.returncode != 0:
            raise AssertionError(f"torchrun --nproc-per-node 1 failed:\n{torchrun.stdout[-3000:]}\n"
                                 f"{torchrun.stderr[-3000:]}")
        train_entry.main(["--synthetic", "--epochs", "1", "--config",
                          parallel_config(tmp, "single.yaml", "bfloat16", False, ckpts["single"])])
        a, b = (load_checkpoint(ckpts[w])["model_state_dict"] for w in ("torchrun", "single"))
        diff = max((a[n].float() - b[n].float()).abs().max().item() for n in a)
        log(f"torchrun --nproc-per-node 1 (tpu.zero1, bf16, 1 epoch) against one process: weights max diff {diff} "
            f"(tol 1e-6)")
        if diff > 1e-6:
            raise AssertionError("a one-rank torchrun run departs from the single-process run")

        # two ranks on the one card over gloo: dp, tp, ZeRO-1 against the single-process steps
        for dtype in DTYPES:
            for zero1 in (False, True):
                parallel_config(tmp, f"{dtype}_{zero1}.yaml", dtype, zero1)
        port = str(free_port())
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r), port, tmp],
                                  cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            single = {dtype: parallel_steps(os.path.join(tmp, f"{dtype}_False.yaml")) for dtype in DTYPES}
            for *_, run in single.values():
                for name, n in run.items():
                    launches[name] += n
            outputs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, text) in enumerate(zip(procs, outputs)):
            if p.returncode != 0:
                raise AssertionError(f"parallel rank {r} failed:\n{text[-4000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        per_step = attention_calls_per_forward(load_config(CONFIG_PATH))
        for name, dp, tp, zero1, dtype in PARALLEL_CASES:
            losses, weights, _, _ = single[dtype]
            got_losses = ranks[0][name]["losses"]
            loss_diff = max(abs(x - y) for x, y in zip(got_losses, losses))
            loss_tol = parallel_check.F32_TOL if dtype == "float32" else PARALLEL_BF16_LOSS_REL * max(map(abs, losses))
            held = parallel_check.weight_check(torch.load(os.path.join(tmp, f"{name}.pt")), weights,
                                               parallel_check.STRAY_SHARE[DTYPES[dtype]])
            want_run = {**ZERO, FWD: per_step * steps, BWD: per_step * steps}
            log(f"parallel {name} ({dtype}, 2 ranks over gloo on one card) against one process, {steps} steps: "
                f"losses {got_losses} vs {losses}, max diff {loss_diff} (tol {loss_tol}); weights {json.dumps(held)} "
                f"(beyond {parallel_check.F32_TOL}: at most {parallel_check.STRAY_SHARE[DTYPES[dtype]]} of those "
                f"held); launches a rank {[r[name]['launches'] for r in ranks]} (want {want_run}: "
                f"{per_step} K1 + {per_step} K2 a step, every K2 launch through its "
                f"{backward_route((1, 1, 8, 8, 96), dtype)} design, as main_path_run checks each); optimizer bytes "
                f"a rank {[r[name]['optimizer_bytes'] for r in ranks]}")
            if not (loss_diff <= loss_tol and held["excess"] <= 0):
                raise AssertionError(f"parallel {name} departs from the single-process steps")
            for r in ranks:
                if r[name]["launches"] != want_run:
                    raise AssertionError(f"parallel {name}: launches {r[name]['launches']}, want {want_run}")
                for kernel, shape, dtype_name, rate, n in r[name]["shapes"]:
                    PATH_SHAPES[(kernel, tuple(shape), dtype_name, rate)] += n
                    launches[kernel] += n
        dp_bytes = ranks[0]["dp2_f32"]["optimizer_bytes"]
        ratios = [r["dp2_zero1_f32"]["optimizer_bytes"] / dp_bytes for r in ranks]
        log(f"ZeRO-1 at dp 2: optimizer bytes a rank {ratios} of dp-only's {dp_bytes}")
        if not all(0.5 <= x <= 0.51 for x in ratios):
            raise AssertionError(f"ZeRO-1 keeps {ratios} of the optimizer bytes a rank, want half")
    # the ring, sp shards on the card
    for name, n in ring_phase(fa, card).items():
        launches[name] += n
    log(f"phase 6m (parallel) in {time.perf_counter() - t0:.1f} s ({card})")
    return launches


def pipeline_phase(fa, card: str) -> dict:
    """Phase 6n's GPipe and remat legs; returns their launches."""
    from mer_tpu_torch.parallel.mesh import Mesh
    from mer_tpu_torch.scripts import parallel_check

    t0 = time.perf_counter()
    launches = dict(ZERO)
    with tempfile.TemporaryDirectory() as tmp:
        port = str(free_port())
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r), port, tmp,
                                   "pp"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            single = {}
            for name, kind, _ in PP_CASES:  # one process, pp 1, no remat: the same microbatches and seeds
                single[name] = parallel_check.fe_pp_steps(kind, Mesh(), torch.device("cuda"), torch.bfloat16,
                                                          count=main_path_run)
                for kernel, n in single[name][3].items():
                    launches[kernel] += n
            outputs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, text) in enumerate(zip(procs, outputs)):
            if p.returncode != 0:
                raise AssertionError(f"pipeline rank {r} failed:\n{text[-4000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"pp_rank{r}.json")) as f:
                ranks.append(json.load(f))
        for name, kind, remat in PP_CASES:
            steps, batch, m = parallel_check.PP_RUNS[kind]
            losses, weights, one_seconds, one_run = single[name]
            got = ranks[0][name]["losses"]
            loss_diff = max(abs(x - y) for x, y in zip(got, losses))
            loss_tol = PARALLEL_BF16_LOSS_REL * max(map(abs, losses))
            held = parallel_check.weight_check(torch.load(os.path.join(tmp, f"{name}.pt")), weights,
                                               parallel_check.STRAY_SHARE[torch.bfloat16])
            per_rank = PP_LAYERS // 2 * m * steps  # L / pp layers x M microbatches a step
            want_run = {**ZERO, FWD: per_rank * (2 if remat else 1), TILED: per_rank}
            want_single = {**ZERO, FWD: PP_LAYERS * m * steps, TILED: PP_LAYERS * m * steps}
            log(f"pipeline {name} (pp 2, {m} microbatches of {batch // m}, remat {remat}, bf16, dropout on; 2 ranks "
                f"over gloo on one card) against one process, {steps} steps: losses {got} vs {losses}, max diff "
                f"{loss_diff} (tol {loss_tol}); weights {json.dumps(held)}; launches a rank "
                f"{[r[name]['launches'] for r in ranks]} (want {want_run}), one process {one_run} (want "
                f"{want_single}); step s rank 0 {ranks[0][name]['seconds']}, one process {one_seconds} (both ranks "
                f"and this process share the card: no speed) ({card})")
            if not (loss_diff <= loss_tol and held["excess"] <= 0):
                raise AssertionError(f"pipeline {name} departs from the single-process steps")
            if one_run != want_single or any(r[name]["launches"] != want_run for r in ranks):
                raise AssertionError(f"pipeline {name}: launches {[r[name]['launches'] for r in ranks]}, "
                                     f"one process {one_run}")
            for r in ranks:
                for kernel, shape, dtype_name, rate, n in r[name]["shapes"]:
                    PATH_SHAPES[(kernel, tuple(shape), dtype_name, rate)] += n
                    launches[kernel] += n

    for kernel, n in remat_phase(card).items():
        launches[kernel] += n
    log(f"phase 6n (pipeline, remat) in {time.perf_counter() - t0:.1f} s ({card})")
    return launches


def remat_phase(card: str) -> dict:
    """Phase 6n's remat leg: ``--remat`` (full, dots) against none in one
    process, one f32 RoBERTa-base text step with dropout on; the gradients
    to the bit, the plain step run twice to show the card's own repeatability;
    returns the launches."""
    from mer_tpu_torch.data.text_fe import text_batch_to_inputs
    from mer_tpu_torch.models import set_attention_generator
    from mer_tpu_torch.models.roberta import text_erc_from_seed
    from mer_tpu_torch.objectives.classification import cross_entropy
    from mer_tpu_torch.scripts import parallel_check
    from mer_tpu_torch.utils import seed_dropout, seed_step

    launches = dict(ZERO)
    batch = parallel_check.fe_pp_batches("text")[0]
    grads, runs = {}, {}
    for policy in ("plain", "plain again", "full", "dots"):
        remat = policy not in ("plain", "plain again")
        model = text_erc_from_seed(0, dtype=torch.float32).cuda().train().set_remat(remat, policy if remat else None)
        generator = seed_dropout(0)
        set_attention_generator(model, generator)
        seed_step(0, 1, generator)
        with main_path_run() as run:
            loss = cross_entropy(model(*text_batch_to_inputs(batch, "cuda")),
                                 torch.from_numpy(batch["emotion"]).long().cuda())
            loss.backward()
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
        runs[policy] = run
        for kernel, n in run.items():
            launches[kernel] += n
        del model, loss
    differing = {policy: {n: (grads[policy][n] - g).abs().max().item() for n, g in grads["plain"].items()
                          if not torch.equal(grads[policy][n], g)} for policy in ("plain again", "full", "dots")}
    # a tensor whose plain gradient does not repeat (atomic sums: the token-type table's one row gathers every
    # token) is held within REMAT_SPREAD x the plain runs' own difference; every other one to the bit
    spread = differing["plain again"]
    beyond = {p: {n: d for n, d in differing[p].items() if not d <= REMAT_SPREAD * spread.get(n, 0.0)}
              for p in ("full", "dots")}
    want = {p: {**ZERO, FWD: PP_LAYERS * (2 if p in ("full", "dots") else 1), TILED: PP_LAYERS} for p in runs}
    log(f"remat f32 text step [16, 256], dropout on: tensors whose gradient differs from the plain step's, with the "
        f"largest difference: {json.dumps(differing)} (of {len(grads['plain'])}); beyond the bit, or for a tensor the "
        f"plain step does not repeat beyond {REMAT_SPREAD} x its plain-vs-plain difference: {json.dumps(beyond)}; "
        f"launches {runs} (want {want}: K1 once more a layer in the recompute) ({card})")
    if any(beyond.values()) or runs != want:
        raise AssertionError(f"remat departs from plain: {beyond}, launches {runs}")
    return launches


def mel_async_augment_phase(lk, card: str, root: str, cfg: str, tmp: str) -> int:
    """Phase 6n's mel legs (async mining, augmentation); returns K5's launches."""
    import yaml

    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.data import MelFeatureDataset
    from mer_tpu_torch.feature_extractors.audio_mel import build_solver, parse_args
    from mer_tpu_torch.feature_extractors.audio_mel import train as mel_train

    t0 = time.perf_counter()
    argv = ["--config", cfg, "--data-root", root]
    torch.backends.cudnn.deterministic = True  # the two epochs below compare to the loss
    try:
        results = []
        for asynchronous in (True, False):
            config, solver = build_solver(parse_args(argv))
            solver.async_mining = asynchronous
            state = solver.init_state()
            steps = len(solver.data_train) // MEL_BATCH
            mined = []
            miner = solver._miner(solver.data_train)
            mine = miner.mine
            miner.mine = lambda *a, **k: (lambda out: (mined.append(np.concatenate(out)), out)[1])(mine(*a, **k))
            t1 = time.perf_counter()
            if asynchronous:
                losses = [loss.item() for loss in solver._train_steps_async(state, steps)]
            else:
                stale, losses = copy.deepcopy(solver.model).eval(), []
                solver._mining_model = stale
                for _ in range(steps):
                    a, p, n = solver._miner(solver.data_train).mine(MEL_BATCH, solver.mining_type)
                    spec = solver.data_train.spectrogram_batch(np.concatenate([a, p, n]))
                    stale.load_state_dict(solver.model.state_dict())  # the weights before this step's update
                    losses.append(solver.train_step(state, spec).item())
            results.append((losses, mined, time.perf_counter() - t1))
            del solver, state
    finally:
        torch.backends.cudnn.deterministic = False
    (a_losses, a_mined, a_s), (s_losses, s_mined, s_s) = results
    same = all(np.array_equal(x, y) for x, y in zip(a_mined, s_mined)) and len(a_mined) == len(s_mined) == steps
    diff = max(abs(x - y) for x, y in zip(a_losses, s_losses))
    log(f"mel async mining, one epoch of {steps} steps: mined indices equal to the one-step-stale synchronous "
        f"epoch's {same}; losses {a_losses} vs {s_losses}, max diff {diff} (tol 1e-5 of the loss); {a_s} s async, "
        f"{s_s} s synchronous ({card})")
    if not (same and diff <= 1e-5 * max(map(abs, s_losses))):
        raise AssertionError("async mining departs from the stale-weights synchronous epoch")

    # one training epoch at augmentation_factor 2 through the entry point
    aug_cfg = os.path.join(tmp, "mel_aug.yaml")
    ckpt = os.path.join(tmp, "ckpt_aug", "checkpoint.ckpt")
    with open(aug_cfg, "w") as f:
        yaml.safe_dump(load_config(cfg).override(AUDIO__augmentation_factor=2, checkpoint__save_path=ckpt,
                                                 checkpoint__load_path=ckpt).to_dict(), f)
    augmented = collections.Counter()
    augment = MelFeatureDataset.augment

    def counting(self, audio, lengths, generator):
        out = augment(self, audio, lengths, generator)
        augmented["batches"] += 1
        augmented["rows"] += int((out[2] > 0).sum())
        augmented["clips"] += audio.shape[0]
        if audio.device.type != "cuda":
            raise AssertionError("random_augment ran off the card")
        return out

    t1 = time.perf_counter()
    with mock.patch.object(MelFeatureDataset, "augment", counting), main_path_run() as run:
        _, history = mel_train.main(["--config", aug_cfg, "--data-root", root, "--epochs", "1"])
    seconds = time.perf_counter() - t1
    config, solver = build_solver(parse_args(["--config", aug_cfg, "--data-root", root]))
    steps, n_val = len(solver.data_train) // MEL_BATCH, len(solver.data_val)
    want = {**ZERO, MEL: 2 * steps + math.ceil(n_val / 64)}
    log(f"mel augmented epoch (factor 2): {steps} steps, {augmented['rows']} of {augmented['clips']} triplet clips "
        f"augmented over {augmented['batches']} batches, losses {json.dumps(history)}, {seconds} s; launches {run} "
        f"(want {want}: K5 for each step's mining pool and triplet batch, one a validation cache chunk) ({card})")
    losses = history["loss_values"] + history["val_loss_values"]
    if run != want or augmented["batches"] != steps or not 0 < augmented["rows"] < augmented["clips"] \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"augmented mel epoch: launches {run}, want {want}; augmented {dict(augmented)}")
    log(f"phase 6n (mel async mining, augmentation) in {time.perf_counter() - t0:.1f} s ({card})")
    return run[MEL]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def log_sdpa_f32_kernels(card: str) -> None:
    """The kernels SDPA's f32 forward runs at the f32 export's [32, 12, 499, 499, 64] with a key mask, by name
    with their device us a call (a CUDA-only profile of three calls): the yardstick of K1 and K3 in f32."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, _, mask = attention_inputs((32, W2V_HEADS, 499, 499, 64), torch.float32, seed=0, clips=True)
    sdpa_forward(q, k, v, mask, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sdpa_forward(q, k, v, mask, 0.0)
        torch.cuda.synchronize()
    kernels = {e.key: e.device_time_total / 3 for e in prof.key_averages() if e.device_time_total > 0}
    log("SDPA f32 forward [32, 12, 499, 499, 64] with a key mask, device us a call by kernel: "
        + ("; ".join(f"{name} {us}" for name, us in sorted(kernels.items(), key=lambda kv: -kv[1]))
           or "no device activity recorded (not measured)") + f" ({card})")


def log_k4_f32_breakdown(fa, card: str, calls: int = 5) -> None:
    """Device us of each of the three launches of K4's 3xTF32 design (prep, dq, dk/dv), averaged over ``calls``
    calls after a warm one (a CUDA-only profile), at the remat f32 text step's [16, 12, 256, 256, 64] and the 90 s
    clips' [2, 12, 4499, 4499, 64], dropout 0 and 0.1."""
    from torch.profiler import ProfilerActivity, profile

    for shape in ((16, 12, 256, 256, 64), (2, 12, 4499, 4499, 64)):
        for rate in (0.0, LONG_DROPOUT):
            q, k, v, g, mask = attention_inputs(shape, torch.float32, seed=7, clips=True)
            seed = dropout_seed(7, rate)
            out, lse = fa.flash_attention_stream(q, k, v, mask, seed, rate)
            call = lambda: fa.flash_attention_tiled_backward(q, k, v, mask, out, lse, g, seed, rate)
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            us = {e.key: e.device_time_total / calls for e in prof.key_averages() if "mer_k4_tf32" in e.key}
            part = lambda name: sum(t for n, t in us.items() if name in n)
            log(f"K4 f32 at {list(shape)} dropout {rate}, device us a launch: " + (
                f"prep {part('prep_kernel')}, dq {part('dq_kernel')}, dk/dv {part('dkv_kernel')}" if us
                else "no device activity recorded (not measured)") + f" (torch.profiler, {calls} calls; {card})")


def attention_bench_phase(card: str) -> None:
    """Phase 6j: the attention bench entry point at all its shapes, f32 and
    bf16, and its crossover rows (K1 | K3, K2 | K4 on either side of the
    dispatch thresholds; K1's and K2's templates against their Hopper
    designs)."""
    from mer_tpu_torch.scripts import bench_attention

    t0 = time.perf_counter()
    rows = bench_attention.main([])
    for r in rows:
        times = [r[k] for k in ("kernel_fwd_ms", "kernel_fwdbwd_ms")]
        if not all(math.isfinite(t) and t > 0 for t in times):
            raise AssertionError(f"bench_attention row without times: {r}")
        log(f"bench {r['shape']} {r['dtype']} ({r['kernels']}): fwd {r['kernel_fwd_ms']} ms (SDPA {r['sdpa_fwd_ms']}, "
            f"bound {r['bound_fwd_ms']}), fwd+bwd {r['kernel_fwdbwd_ms']} ms (SDPA {r['sdpa_fwdbwd_ms']}, bound "
            f"{r['bound_fwdbwd_ms']}) ({card})")
    log(f"bench_attention: {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for r in bench_attention.main(["--crossover"]):
        a, b = r["kernels"].split(" | ")
        times = (r[f"{a}_ms"], r[f"{b}_ms"])
        if not all(math.isfinite(t) and t > 0 for t in times):
            raise AssertionError(f"bench_attention crossover row without times: {r}")
        sdpa = (f", SDPA {r['sdpa_ms']} ms, {b} / SDPA {times[1] / r['sdpa_ms']}, template on unaligned inputs "
                f"{r['template_unaligned_ms']} ms" if r["direction"] == "designs" else
                f", SDPA {r['sdpa_ms']} ms, {b} / SDPA {times[1] / r['sdpa_ms']}" if r["direction"] == "k1 designs" else
                f", SDPA's backward {r['sdpa_backward_ms']} ms, {b} / SDPA {times[1] / r['sdpa_backward_ms']}"
                if r["direction"] == "k2 designs" else "")
        log(f"crossover {r['direction']} [{r['B']}, {r['H']}, {r['S']}, {r['Dh']}] {r.get('dtype', 'bfloat16')} "
            f"dropout {r['dropout']}: {a} {times[0]} ms, {b} {times[1]} ms, {b} / {a} {times[1] / times[0]}{sdpa} "
            f"({card})")
    log(f"bench_attention --crossover in {time.perf_counter() - t0:.1f} s")


def probe_phase(card: str) -> tuple[dict, int]:
    """Phase 6k: the probes P, each exact against torch; returns their results
    and launches."""
    from mer_tpu_torch.scripts import probe_strided

    with main_path_run() as run:
        results = probe_strided.main([])
    log(f"probes P: {json.dumps(results)}; launches {run} ({card})")
    for name, r in results.items():
        log(f"probe {name}: kernel {r['ms']} ms, plain {r['plain_ms']} ms, torch call {r['library_ms']} ms, "
            f"bound {probe_bound_ms(name)} ms, kernel / torch call {r['ms'] / r['library_ms']} ({card})")
    if not all(r["ok"] for r in results.values()) or run[PROBE] == 0 or run != {**ZERO, PROBE: run[PROBE]}:
        raise AssertionError(f"probes P: {results}, launches {run}")
    return results, run[PROBE]


def probe_bound_ms(name: str) -> float:
    """A probe's bound: its bytes at the HBM rate, each read once: the part of
    x that its out needs (half the rows for even and odd rows, x[:, :16] and
    the bf16 w [16, C] for the product, all of x otherwise), and out written
    once."""
    from mer_tpu_torch.scripts import probe_strided

    t, c = probe_strided.T, probe_strided.C
    x_elems = {"even_rows": t * c // 2, "odd_rows": t * c // 2, "fold_pairs": t * c, "unfold_halves": t * c,
               "skinny_bf16_gemm": t * 16, "grid_reduce": t * c}
    out_elems = {"even_rows": t * c // 2, "odd_rows": t * c // 2, "fold_pairs": t * c, "unfold_halves": t * c,
                 "skinny_bf16_gemm": t * c, "grid_reduce": c}
    w_bytes = 2 * 16 * c if name == "skinny_bf16_gemm" else 0
    return (4 * (x_elems[name] + out_elems[name]) + w_bytes) / HBM_BYTES_PER_S * 1e3


def probe_kernel_line(results: dict, n: int, card: str) -> dict:
    """P's entry of the kernels line: per launch, averaged over the six
    probes, each probe's row (with its bound) beside it."""
    bound = [probe_bound_ms(name) for name in results]
    mean = lambda key: sum(r[key] for r in results.values()) / len(results)
    return {"name": PROBE, "route": "cuda", "source": f"mer_tpu_torch/csrc/{PROBE}.cu", "replaces": REPLACES[PROBE],
            "launches": n, "max_abs_err": max(r["max_abs_err"] for r in results.values()), "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": sum(bound) / len(bound), "bound_by": "bytes",
            "library_ms": mean("library_ms"),
            "probes": {name: {**r, "bound_ms": probe_bound_ms(name)} for name, r in results.items()}, "card": card}


def main() -> None:
    if os.environ.get("PYTHONHASHSEED") != "0":  # the hash tokenizer's ids: the same tokens in every run
        os.execve(sys.executable, [sys.executable, *sys.argv], {**os.environ, "PYTHONHASHSEED": "0"})
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs one NVIDIA card")
    from mer_tpu_torch import serve as serve_entry
    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.data import write_synthetic_meld
    from mer_tpu_torch.ops import _build
    from mer_tpu_torch.models.wav2vec2 import audio_erc_from_seed
    from mer_tpu_torch.ops import flash_attention as fa
    from mer_tpu_torch.ops import logmel_kernel as lk
    from mer_tpu_torch.ops import w2v_conv as wc
    from mer_tpu_torch.tools import kernel_sources

    # 1. device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)  # as nvidia-smi gives it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        "TF32 off (torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False)")

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    sources = kernel_sources()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # KERNELS and the design probes' sources
        built = [name for name, new in zip(sources, pool.map(_build.build, sources)) if new]
    log(f"build: {built or 'all kernels already built'} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions at the dialogue buckets (the head dims 50 after 96: the seeds of the
    # cases before them stay as they were)
    cases = [(FWD, shape, dtype, 0.0) for shape in KERNEL_SHAPES for dtype in DTYPES]
    for dh in (96, 50):
        cases += [(kernel, shape, dtype, rate) for shape in KERNEL_SHAPES if shape[-1] == dh for dtype in DTYPES
                  for kernel, rate in ((FWD, DROPOUT), (BWD, 0.0), (BWD, DROPOUT))]
    rows = [check_case(fa, *case, i) for i, case in enumerate(cases)]
    rounding_witness(fa)
    check_limit_fails_rolled_slices(fa)
    for s in BUCKETS:
        check_dropout_masks(fa, 32, 8, s, s)
    rows += [check_mel_case(lk, (b, f, layout), len(rows) + i)
             for i, (b, f, layout) in enumerate((b, f, layout) for b, f in MEL_SHAPES for layout in MEL_LAYOUTS)]
    # K7 and K6 with the seeded wav2vec2 model's conv weights; K1 at its encoder's shapes
    w2v_model = audio_erc_from_seed(0).cuda().eval()
    frontend = w2v_model.wav2vec2.feature_extractor
    for b, n in W2V_SHAPES:
        for dtype in DTYPES:
            rows.append(check_w2v_case(wc, frontend, W2V0, (b, n), dtype, len(rows)))
            t0 = wc.conv_out_length(n, wc.L0_TAPS, wc.L0_STRIDE)
            rows.append(check_w2v_case(wc, frontend, W2V_TAIL, (b, t0), dtype, len(rows)))
    check_w2v_limit_fails_shifted(wc, frontend)
    for shape in GN_SHAPES:
        for dtype in DTYPES:
            rows.append(check_w2v_case(wc, frontend, GN, shape, dtype, len(rows)))
    rows += [check_case(fa, FWD, shape, dtype, 0.0, len(rows) + i)
             for i, (shape, dtype) in enumerate((shape, dtype) for shape in W2V_ATTENTION_SHAPES + TEXT_ATTENTION_SHAPES
                                                for dtype in DTYPES)]
    # 3b. K3 and K4 at 2,049-16,384 keys, the seams with K1 and K2, their dropout masks
    t0 = time.perf_counter()
    rows += long_kernel_checks(fa, len(rows))
    log(f"phase 3b (K3, K4 against their plain versions) in {time.perf_counter() - t0:.1f} s")
    log_sdpa_f32_kernels(card)
    log_k4_f32_breakdown(fa, card)

    # 4. offline evaluation, 5. online serving, 6. training: counts start at 0 for each path
    launches = {**ZERO, FWD: offline_phase(fa, card)}
    per_forward = attention_calls_per_forward(load_config(CONFIG_PATH))
    for n_requests in ONLINE_REQUESTS:
        with main_path_run() as run:
            report = serve_entry.main(["--synthetic", "--requests", str(n_requests)])
        log(f"online {n_requests} requests: {run[FWD]} kernel launches, {report['batches']} micro-batches ({card})")
        if report["requests"] != n_requests or run[FWD] == 0 or run[FWD] % per_forward \
                or run != {**ZERO, FWD: run[FWD]}:
            raise AssertionError(f"online serving answered {report['requests']}/{n_requests} requests "
                                 f"with launches {run}")
        launches[FWD] += run[FWD]
    for name, n in training_phase(fa, card).items():
        launches[name] += n
    # 6p. the mel variant of the fusion model: 6 audio heads of 50
    for name, n in mel_variant_phase(fa, card).items():
        launches[name] += n
    # 6b. mel training, 6c. mel export, on a synthetic MELD root (MELD-shaped test split)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "meld")
        counts = write_synthetic_meld(root, meld_shape=True, split_dialogues=MEL_SPLIT_DIALOGUES, words=TEXT_WORDS)
        log(f"synthetic MELD root {counts}, utterances of {TEXT_WORDS} words, in {time.perf_counter() - t0:.1f} s")
        cfg = mel_config(tmp)
        launches[MEL] += mel_training_phase(lk, card, root, cfg)
        launches[MEL] += mel_export_phase(lk, card, root, cfg, tmp)
        # 6d. wav2vec2 export, 6e. wav2vec2 evaluation, on the same root
        for name, n in w2v_phase(fa, wc, card, root, tmp, w2v_model).items():
            launches[name] += n
        # 6f. the conv frontend's profile entry, 6g. text, 6h. wav2vec2 fine-tuning, on the same root
        # (wav2vec2 trains on a root of its own: train and dev clips of 0.5-10 s, so every wave bucket is reached)
        long_root = os.path.join(tmp, "meld_long")
        counts = write_synthetic_meld(long_root, split_dialogues={**MEL_SPLIT_DIALOGUES, "test_sent_emo.csv": 2},
                                      clip_seconds=W2V_TRAIN_SECONDS)
        log(f"synthetic MELD root for wav2vec2 training {counts}, clips of {W2V_TRAIN_SECONDS} s")
        for phase in (profile_phase(card), text_phase(fa, card, root, tmp),
                      w2v_training_phase(fa, wc, card, long_root, tmp)):
            for name, n in phase.items():
                launches[name] += n
        # 6i. wav2vec2 on 45-90 s clips (K3, K4), 6j. the attention bench entry, 6k. the probes P
        t0 = time.perf_counter()
        for name, n in long_clip_phase(fa, wc, card, tmp).items():
            launches[name] += n
        log(f"phase 6i (long clips) in {time.perf_counter() - t0:.1f} s")
        # 6l. the e2e stream and the int8 engines, on the MELD-shaped root
        t0 = time.perf_counter()
        for phase in (e2e_phase(fa, wc, lk, card, root), int8_phase(card, tmp)):
            for name, n in phase.items():
                launches[name] += n
        log(f"phase 6l (e2e stream, int8 engines) in {time.perf_counter() - t0:.1f} s")
        # 6m. dp, tp and ZeRO-1 on two ranks over gloo, torchrun, the ring on the card
        for name, n in parallel_phase(fa, card).items():
            launches[name] += n
        # 6n. GPipe at pp 2 on two ranks over gloo, remat, the mel extractor's async mining and augmentation
        for name, n in pipeline_phase(fa, card).items():
            launches[name] += n
        launches[MEL] += mel_async_augment_phase(lk, card, root, cfg, tmp)
    attention_bench_phase(card)
    probe_results, launches[PROBE] = probe_phase(card)
    del w2v_model  # its conv frontend serves phase 7
    torch.cuda.empty_cache()
    for name in KERNELS:
        tallied = sum(n for (kernel, *_), n in PATH_SHAPES.items() if kernel == name)
        if tallied != launches[name]:
            raise AssertionError(f"{name}: {tallied} launches tallied, {launches[name]} counted")

    # 7. kernels against their plain versions at every case the paths gave them
    checked = {(r["kernel"], r["shape"], r["dtype"], r["rate"]) for r in rows if "kernel_ms" in r}
    more = {(kernel, shape, dtype, rate) for kernel, shape, _, rate in PATH_SHAPES if kernel not in (MEL, PROBE)
            for dtype in DTYPES}  # K1-K4, K6, K7, K8: both dtypes at every shape (P checks itself, phase 6k)
    more |= {(MEL, (*shape[:2], layout), "float32", 0.0) for kernel, shape, _, _ in PATH_SHAPES if kernel == MEL
             for layout in MEL_LAYOUTS}
    for i, (kernel, shape, dtype, rate) in enumerate(sorted(more - checked), len(rows)):
        if kernel == MEL:
            rows.append(check_mel_case(lk, shape, i))
        elif kernel in (W2V0, W2V_TAIL, GN):
            rows.append(check_w2v_case(wc, frontend, kernel, shape, dtype, i))
        else:
            rows.append(check_case(fa, kernel, shape, dtype, rate, i))
    # the exact read-off needs v = I, so Sk as a head dim; wider shapes are held by value (check_case with dropout)
    for b, h, sq, sk, rate in sorted({(*shape[:4], rate) for (kernel, shape, _, rate) in PATH_SHAPES if rate
                                      and max(shape[2:4]) <= fa.MAX_HEAD_DIM}):
        check_dropout_masks(fa, b, h, sq, sk, rate)
    check_mel_tone_and_silence(lk)
    by_case = {(r["kernel"], r["shape"], r["dtype"], r["rate"]): r for r in rows if "kernel_ms" in r}

    # 8. kernel line (times per launch, averaged over the main paths' launches
    # at their own shapes), then the device line last
    dh64 = lambda case: case[1][-1] == 64
    stacked = lambda case: backward_route(case[1], case[2]) != "template"  # K2's one-pass stacked design
    k1_route = lambda route: (lambda case: forward_route(case[1], case[2]) == route)  # K1's design at a case
    for what, kernel, dtype, only in (
            ("K6 f32 (3xTF32) against cuDNN's f32 chain, TF32 off", W2V_TAIL, "float32", None),
            ("K1 bf16, Hopper forward (Dh 64), against SDPA", FWD, "bfloat16", dh64),
            ("K1 bf16, stacked forward (Dh 96, 50), against its template and SDPA", FWD, "bfloat16",
             k1_route("stacked_bf16")),
            ("K1 f32, stacked forward (Dh 96, 50), against its template and SDPA's f32", FWD, "float32",
             k1_route("stacked_f32")),
            ("K1, template (other head dims), against SDPA", FWD, None, k1_route("template")),
            ("K2 bf16, stacked design (its template at Dh 50), against SDPA's backward", BWD, "bfloat16", stacked),
            ("K2 f32, stacked design, against SDPA's f32 backward", BWD, "float32", stacked),
            ("K2, template (other head dims), against SDPA's backward", BWD, None, lambda case: not stacked(case)),
            ("K3 against SDPA", STREAM, "bfloat16", None),
            ("K1 f32 (3xTF32) against SDPA's f32", FWD, "float32", dh64),
            ("K3 f32 (3xTF32) against SDPA's f32", STREAM, "float32", dh64),
            ("K4 f32 (3xTF32) against SDPA's f32 backward", TILED, "float32", dh64)):
        log(f"{what}, per phase-3 shape (launches: the counted paths'; ms a call, graph replay; {card}):")
        # the attention f32 rows: head dim 64 alone (the 3xTF32 design; other head dims run the template)
        for case in sorted(c for c in by_case
                           if c[0] == kernel and dtype in (None, c[2]) and (only is None or only(c))):
            r = by_case[case]
            template = (f", template {r['template_ms']} ms, kernel / template {r['kernel_ms'] / r['template_ms']}"
                        if "template_ms" in r else "")
            log(f"  {case[1]} {case[2]} dropout {case[3]}: launches {PATH_SHAPES.get(case, 0)}, kernel "
                f"{r['kernel_ms']} ms{template}, library {r['library_ms']} ms, kernel / library "
                f"{r['kernel_ms'] / r['library_ms']}, bound {r['bound_us'] / 1e3} ms ({r['bound_by']}), share of "
                f"bound {r['bound_us'] / 1e3 / r['kernel_ms']}")
    kernels = []
    # K6's, K3's and K4's two dtypes are two routes each (bf16 wgmma or mma.sync, f32 3xTF32 or the f32 template),
    # K1's four (its Hopper forwards at head dim 64, bf16 and 3xTF32, its stacked forward at the fusion model's
    # head dims, bf16 and f32) beside its template, and K2's stacked design two (bf16 on wgmma, f32 by FMA) beside
    # its template: an entry each, together the kernel's launches. The templates' entries stand only where a counted
    # path launched them (every counted K1 and K2 call at the fusion model's dialogues takes a stacked design)
    bf16, f32 = (lambda case: case[2] == "bfloat16"), (lambda case: case[2] == "float32")
    entries, optional = [], {FWD + "_template", BWD + "_template"}
    for name in KERNELS:
        if name == FWD:
            entries += [(FWD, FWD, k1_route("wgmma_bf16")), (FWD + "_stacked", FWD, k1_route("stacked_bf16")),
                        (FWD + "_stacked_f32", FWD, k1_route("stacked_f32")),
                        (FWD + "_f32", FWD, k1_route("wgmma_tf32")), (FWD + "_template", FWD, k1_route("template"))]
        elif name == BWD:
            entries += [(BWD, BWD, lambda case: bf16(case) and stacked(case)),
                        (BWD + "_f32", BWD, lambda case: f32(case) and stacked(case)),
                        (BWD + "_template", BWD, lambda case: not stacked(case))]
        elif name in (W2V_TAIL, STREAM, TILED):
            entries += [(name, name, bf16), (name + "_f32", name, f32)]
        else:
            entries.append((name, name, None))
    for entry, name, only in entries:
        selected = lambda r: r["kernel"] == name and (only is None or only((name, r["shape"], r["dtype"], r["rate"])))
        if name == PROBE:
            kernels.append(probe_kernel_line(probe_results, launches[PROBE], card))
            continue
        path = {case: n for case, n in PATH_SHAPES.items() if case[0] == name and (only is None or only(case))}
        for case, n in sorted(path.items()):
            r = by_case[case]
            log(f"main path {case}: {n} launches x kernel {r['kernel_ms']} ms (bound {r['bound_us'] / 1e3} ms, "
                f"plain {r['plain_ms']} ms, library {r['library_ms']} ms)")
        keys = ("kernel_ms", "plain_ms", "library_ms", "bound_bytes_us", "bound_ops_us")
        total = {key: sum(n * by_case[case][key] for case, n in path.items()) for key in keys}
        n = sum(path.values())  # launches[name] over all its entries (tallied = counted, checked above)
        if n == 0 and entry in optional:
            log(f"{entry}: no launch on the counted paths (none of their calls takes this design)")
            continue
        if n == 0:
            raise AssertionError(f"{entry}: no launch on the counted paths")
        log(f"{entry} main path: {n} launches at {len(path)} cases; summed over them {json.dumps(total)} ({card})")
        # the template on the same inputs where phase 3 or 7 timed it (K1's stacked forward, K2's at head dim 50)
        beside = {case: c for case, c in path.items() if "template_ms" in by_case[case]}
        template = {}
        if beside:
            n_beside = sum(beside.values())
            mean = {key: sum(c * by_case[case][key] for case, c in beside.items()) / n_beside
                    for key in ("kernel_ms", "template_ms", "plain_ms", "library_ms", "bound_bytes_us", "bound_ops_us")}
            template = {"template_ms": mean["template_ms"], "template_launches": n_beside}
            log(f"{entry} against its template at the same {n_beside} launches (head dims "
                f"{sorted({case[1][4] for case in beside})}), a launch: {json.dumps(mean)}; kernel / template "
                f"{mean['kernel_ms'] / mean['template_ms']} ({card})")
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": f"mer_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in rows if selected(r)),
            "ms": total["kernel_ms"] / n,
            "plain_ms": total["plain_ms"] / n,
            "bound_ms": max(total["bound_bytes_us"], total["bound_ops_us"]) / 1e3 / n,
            "bound_by": "bytes" if total["bound_bytes_us"] >= total["bound_ops_us"] else "operations",
            "library_ms": total["library_ms"] / n,
            "shapes": {f"{dtype} {'x'.join(map(str, shape))}" + (f" dropout {rate}" if name in (FWD, BWD, STREAM, TILED)
                                                                 else ""): c
                       for (_, shape, dtype, rate), c in sorted(path.items())},
            "cases_checked": sum(map(selected, rows)),
            **template,
            "card": card,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], *sys.argv[5:6])
    else:
        main()
