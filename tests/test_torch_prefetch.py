"""The host -> device prefetcher (``mer_tpu_torch/data/prefetch.py``).

On the CPU: order and values, a producer's exception after the batches made
before it, a consumer that stops early, ``sharding`` at one dp rank and a
rank outside its group (two ranks: ``tests/test_torch_parallel.py``). On a card
(the ``cuda`` marker): 64 batches through the pinned slots while the
consumer's stream is kept busy, every batch's checksum, taken on the
consumer's stream and the batch then dropped, equal to the host batch's. A
slot refilled before its copy finished, or a batch's memory handed back to
the copy stream while the compute stream still reads it, shows as a wrong sum.
"""

import numpy as np
import pytest
import torch

from mer_tpu_torch.data.prefetch import DevicePrefetcher, prefetch


def _batches(n: int):
    rng = np.random.default_rng(0)
    return [{"a": np.full((3, 2), i, np.int16), "b": rng.normal(size=(i + 1,)).astype(np.float32),
             "m": np.arange(4) % (i + 2) == 0} for i in range(n)]


def test_order_values_and_dtypes():
    batches = _batches(7)
    got = list(prefetch(iter(batches), device="cpu", buffer_size=2))
    assert len(got) == 7
    for g, b in zip(got, batches):
        for k in b:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), b[k])


def test_producer_error_reaches_the_consumer():
    def failing():
        yield from _batches(2)
        raise KeyError("producer fault")

    seen = []
    with pytest.raises(KeyError, match="producer fault"):
        for g in prefetch(failing(), device="cpu"):
            seen.append(g)
    assert len(seen) == 2


def test_early_stop_and_sharding():
    it = prefetch(iter(_batches(9)), device="cpu", buffer_size=1)
    next(it)
    it.close()  # the producer is unblocked and joined
    batch = {"x": np.arange(10).reshape(5, 2), "m": np.arange(5) % 2 == 0}
    (whole,) = DevicePrefetcher([batch], device="cpu", sharding=(None, 0))  # one dp rank: the whole batch
    for k in batch:
        np.testing.assert_array_equal(whole[k].numpy(), batch[k])
    with pytest.raises(ValueError, match="dp rank 1 outside a group of 1"):
        DevicePrefetcher([batch], device="cpu", sharding=(None, 1))


@pytest.mark.cuda
def test_pinned_slots_under_a_busy_consumer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: pinned memory and copy streams")
    rng = np.random.default_rng(1)
    batches = [{"x": rng.integers(-30000, 30000, size=(64, 4096)).astype(np.int16),
                "n": np.array([i], np.int32)} for i in range(64)]
    work = torch.randn(2048, 2048, device="cuda")
    sums = []
    for b in prefetch(iter(batches), device="cuda", buffer_size=2):
        for _ in range(4):  # keep the compute stream behind the copies
            work = torch.tanh(work @ work * 1e-3)
        sums.append((b["x"].to(torch.int64).sum(), b["n"].clone()))
    torch.cuda.synchronize()
    assert [int(n) for _, n in sums] == list(range(64))
    assert [int(s) for s, _ in sums] == [int(b["x"].astype(np.int64).sum()) for b in batches]
