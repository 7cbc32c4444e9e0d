"""The port's ResNet18 mel extractor against the JAX package's, on the CPU.

- ``mer_tpu``'s extractor with random weights and randomised BatchNorm
  statistics, carried over with ``mel_state_dict_from_jax``, gives the same
  embeddings: rtol 2e-4 / atol 2e-5 (``tests/test_resnet_parity.py``'s, the
  f32 convolutions summing in another order), of unit norm;
- its ``state_dict`` has torchvision's names, so a torchvision-layout
  ``state_dict`` loads with ``strict=True``, and ``mer_tpu``'s
  ``convert_torch_mel_extractor`` reads the port's into ``mer_tpu``'s trees;
- ``bn_mode="eval"`` keeps the running statistics under ``train()``;
  ``"train"`` updates them.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mer_tpu.models.resnet import AudioMelFeatureExtractor as JaxExtractor
from mer_tpu.models.resnet import convert_torch_mel_extractor
from mer_tpu_torch.models import AudioMelFeatureExtractor, mel_extractor_from_seed, mel_state_dict_from_jax

X_SHAPE = (2, 3, 96, 64)  # NCHW; mer_tpu's extractor takes NCHW too and transposes


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tests run in several worker processes at once; torch's default pool
    (one thread per core in every worker) oversubscribes the cores and slows
    the CPU convolutions here tenfold. Two threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_weights():
    """mer_tpu params and BatchNorm stats, the stats drawn with numpy."""
    variables = JaxExtractor().init(jax.random.PRNGKey(0), jnp.zeros((1, 96, 64, 3)))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(0, 0.1, v.shape) if path[-1].key == "mean" else rng.uniform(0.6, 1.5, v.shape))
        .astype(np.float32), variables["batch_stats"])
    return jax.tree.map(np.asarray, variables["params"]), stats


def test_embeddings_match_jax(jax_weights):
    params, stats = jax_weights
    x = np.random.default_rng(1).normal(size=X_SHAPE).astype(np.float32)
    want = np.asarray(JaxExtractor(bn_mode="eval").apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = AudioMelFeatureExtractor()
    model.load_state_dict(mel_state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
        in_train_mode = model.train()(torch.from_numpy(x)).numpy()  # bn_mode "eval": the same
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(in_train_mode, got)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


class _Block(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), nn.BatchNorm2d(cout))


class _TorchvisionResNet18(nn.Module):
    """torchvision's resnet18 parameter and buffer names (no forward needed)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        widths = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        for i, (cin, cout, stride) in enumerate(widths, 1):
            setattr(self, f"layer{i}", nn.Sequential(_Block(cin, cout, stride), _Block(cout, cout)))
        self.fc = nn.Linear(512, 1000)


def test_torchvision_state_dict_loads_strict_and_mer_tpu_reads_the_port():
    reference = nn.Module()
    reference.resnet18 = _TorchvisionResNet18()
    reference.projector = nn.Sequential(nn.ReLU(), nn.Linear(1000, 300))
    model = AudioMelFeatureExtractor()
    model.load_state_dict(reference.state_dict(), strict=True)
    for name, value in reference.state_dict().items():
        torch.testing.assert_close(model.state_dict()[name], value, rtol=0, atol=0)

    params, stats = convert_torch_mel_extractor(mel_extractor_from_seed(3).state_dict())
    variables = JaxExtractor().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))
    for tree, want_tree in ((params, variables["params"]), (stats, variables["batch_stats"])):
        shapes = lambda t: {jax.tree_util.keystr(k): np.shape(v) for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
        assert shapes(tree) == shapes(want_tree)


def test_bn_mode_train_updates_running_stats_and_seeded_init():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=X_SHAPE).astype(np.float32))
    a, b = mel_extractor_from_seed(5), mel_extractor_from_seed(5)
    for name, value in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[name], value, rtol=0, atol=0)
    frozen, updating = mel_extractor_from_seed(5, bn_mode="eval"), mel_extractor_from_seed(5, bn_mode="train")
    for model, changes in ((frozen, False), (updating, True)):
        before = model.resnet18.bn1.running_mean.clone()
        with torch.no_grad():
            model.train()(x)
        assert model.resnet18.bn1.training == changes
        assert (not torch.equal(model.resnet18.bn1.running_mean, before)) == changes
    with pytest.raises(ValueError, match="bn_mode"):
        AudioMelFeatureExtractor(bn_mode="frozen")
