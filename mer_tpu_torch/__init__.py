"""mer_tpu_torch: ``mer_tpu`` in PyTorch, with hand-written CUDA kernels for
Hopper (sm_90a): the fusion path (serving and training) and the stage-1 mel
feature extractor (training and embedding export).

Layout (module names follow ``mer_tpu``'s):

- ``core``       config, MELD tables, embedding artifacts
- ``data``       dialogue datasets, collate, length-bucketed batching and
                 batching from tables kept on the device; WAV I/O; the mel
                 utterance dataset with its uint8 spectrogram cache on the
                 device; synthetic dialogues and a synthetic MELD root
                 (``python -m mer_tpu_torch.data.synthetic``)
- ``ops``        attention and its CUDA kernels (forward K1 and backward K2
                 with in-kernel Philox dropout), the log-mel frontend and its
                 frames -> log-mel kernel K5; kernels build from ``csrc/`` at
                 first use into ``_build/``; each has its plain version
- ``models``     M2FNet and its layers in the reference ``state_dict`` layout,
                 the ResNet18 mel extractor in torchvision's, weight and
                 Adam-state conversion from ``mer_tpu``
- ``mining``     online triplet mining (class-uniform pools, hard / semi-hard)
- ``objectives`` cross-entropy, class weights, batch-averaged metrics, the
                 mel extractor's triplet / variance / covariance losses
- ``serving``    offline batched prediction and the online server
- ``train``      the fusion solver, the mel solver, checkpoints,
                 ``python -m mer_tpu_torch.train``
- ``feature_extractors.audio_mel``  ``.train`` and ``.embeddings`` entry points
- ``utils``      dropout generators, console logging
- ``test``, ``serve``  entry points (``python -m mer_tpu_torch.test`` /
                 ``.serve``); every entry point runs on CUDA unless
                 ``--device cpu``

The package imports neither ``jax`` nor anything of ``mer_tpu``.
"""

__version__ = "0.1.0"
