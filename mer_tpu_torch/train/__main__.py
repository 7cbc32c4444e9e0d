"""``python -m mer_tpu_torch.train``: see :mod:`mer_tpu_torch.train.pipeline`."""

from mer_tpu_torch.train.pipeline import main

main()
