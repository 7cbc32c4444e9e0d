"""mer_tpu_torch: the fusion serving path of ``mer_tpu`` in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

Layout (module names follow ``mer_tpu``'s):

- ``core``       config, MELD tables, embedding artifacts
- ``data``       dialogue datasets, collate and length-bucketed batching
- ``ops``        attention, its CUDA kernel (built from ``csrc/`` at first
                 use into ``_build/``) and the kernel's plain version
- ``models``     M2FNet and its layers in the reference ``state_dict`` layout,
                 weight conversion from ``mer_tpu`` param trees
- ``objectives`` batch-averaged accuracy and weighted F1
- ``serving``    offline batched prediction and the online server
- ``test``, ``serve``  entry points (``python -m mer_tpu_torch.test`` /
                 ``.serve``); both run on CUDA unless ``--device cpu``

The package imports neither ``jax`` nor anything of ``mer_tpu``.
"""

__version__ = "0.1.0"
