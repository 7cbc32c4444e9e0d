"""mer_tpu_torch: ``mer_tpu`` in PyTorch, with hand-written CUDA kernels for
Hopper (sm_90a): the fusion path (serving and training) and the three stage-1
feature extractors: mel (training and embedding export), wav2vec2 (fine-tuning,
embedding export and evaluation, clips of any length the batcher's ladder
takes) and text (RoBERTa: fine-tuning, evaluation and export); the
end-to-end stream from wavs and transcripts to predictions; the int8 serving
engines.

Layout (module names follow ``mer_tpu``'s):

- ``core``       config, MELD tables (with the text extractor's context), embedding artifacts
- ``data``       dialogue datasets, collate, length-bucketed batching and
                 batching from tables kept on the device; WAV I/O; the mel
                 utterance dataset with its uint8 spectrogram cache on the
                 device; the wav2vec2 utterance dataset and its bucketed
                 batcher (``max_seconds``, ``seconds_buckets``); the text
                 utterance dataset (``text_fe``: context windows, the token
                 ladder); synthetic dialogues and a synthetic MELD root
                 (``python -m mer_tpu_torch.data.synthetic``)
- ``ops``        attention and its CUDA kernels (forward K1 and the streaming
                 forward K3 above 4,096 keys, backward K2 and the key-tiled
                 backward K4 above 2,048, all with in-kernel Philox dropout
                 and their bf16 products on the tensor cores; the thresholds
                 from the card's crossover rows), the log-mel frontend
                 and its frames -> log-mel kernel K5, the wav2vec2 conv
                 frontend's kernels K7 (layer 0 + GroupNorm + GELU), K6
                 (layers 1-6) and K8 (GroupNorm + GELU); ring attention over
                 the sp axis; kernels build from
                 ``csrc/`` at first use into ``_build/``; each has its plain
                 version
- ``models``     M2FNet and its layers in the reference ``state_dict`` layout,
                 the ResNet18 mel extractor in torchvision's, wav2vec2 and
                 RoBERTa (``models/roberta.py``) with their classifier heads in
                 Hugging Face's, weight and Adam-state conversion from
                 ``mer_tpu``
- ``mining``     online triplet mining (class-uniform pools, hard / semi-hard)
- ``objectives`` cross-entropy, class weights, batch-averaged metrics, the
                 mel extractor's triplet / variance / covariance losses
- ``parallel``   the (dp, tp, sp) mesh over ``torch.distributed``, Megatron
                 tensor parallelism, data parallelism with the global
                 batch's loss and ZeRO-1 (ring attention is
                 ``ops/ring_attention.py``, process sharding
                 ``data/process_sharding.py``)
- ``pipelines``  the end-to-end stream (``e2e``): wavs and transcripts ->
                 embeddings on the device -> fusion, behind a prefetch thread
                 (``data/prefetch.py``) with the native wav decoder
                 (``data/native_wavio.py``) and the int16 or μ-law wire
                 (``ops/mulaw.py``)
- ``serving``    offline batched prediction, the online server and the int8
                 engines (``quant``: M2FNet; ``encoders``: RoBERTa, wav2vec2)
- ``train``      the fusion solver, the mel solver, the text / wav2vec2
                 solver (``fe_solver``: freeze, then fine-tune), checkpoints,
                 ``python -m mer_tpu_torch.train``
- ``feature_extractors.audio_mel``  ``.train`` and ``.embeddings`` entry points
- ``feature_extractors.audio_wav2vec2``  ``.train``, ``.test`` and ``.embeddings``
- ``feature_extractors.text``  ``.train``, ``.test`` and ``.embeddings``
- ``scripts``    profile and probe entry points on the card:
                 ``profile_w2v_conv`` (the conv frontend's variants),
                 ``bench_attention`` (K1-K4 against SDPA at the workload's
                 shapes), ``probe_strided`` (the lowering probes P),
                 ``parallel_check`` (dp x tp, ZeRO-1 and the sp ring on four
                 ranks against one process)
- ``utils``      dropout generators, console logging
- ``test``, ``serve``, ``e2e_stream``  entry points (``python -m
                 mer_tpu_torch.test`` / ``.serve`` / ``.e2e_stream``); every
                 entry point runs on CUDA unless ``--device cpu``

The package imports neither ``jax`` nor anything of ``mer_tpu``.
"""

__version__ = "0.1.0"
