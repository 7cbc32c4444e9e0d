"""mer_tpu_torch: the fusion path of ``mer_tpu`` (serving and training) in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

Layout (module names follow ``mer_tpu``'s):

- ``core``       config, MELD tables, embedding artifacts
- ``data``       dialogue datasets, collate, length-bucketed batching, and
                 batching from tables kept on the device
- ``ops``        attention, its CUDA kernels (forward K1 and backward K2 with
                 in-kernel Philox dropout, built from ``csrc/`` at first use
                 into ``_build/``), their plain versions and the autograd
                 Function that joins them
- ``models``     M2FNet and its layers in the reference ``state_dict`` layout,
                 weight and Adam-state conversion from ``mer_tpu``
- ``objectives`` cross-entropy, class weights, batch-averaged metrics
- ``serving``    offline batched prediction and the online server
- ``train``      the solver, checkpoints, ``python -m mer_tpu_torch.train``
- ``utils``      dropout generators, console logging
- ``test``, ``serve``  entry points (``python -m mer_tpu_torch.test`` /
                 ``.serve``); every entry point runs on CUDA unless
                 ``--device cpu``

The package imports neither ``jax`` nor anything of ``mer_tpu``.
"""

__version__ = "0.1.0"
