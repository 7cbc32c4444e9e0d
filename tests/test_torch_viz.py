"""The port's embedding visualisation (``mer_tpu_torch/utils/viz.py``)
against scikit-learn and ``mer_tpu/utils/viz.py``, on the CPU.

On seeded clusters (seven classes, as MELD's emotions, 210 points in 300
dimensions, spread 3):

- ``silhouette`` equals ``sklearn.metrics.silhouette_score`` within 1e-6,
  0.0 for one class, and sklearn's value with a one-point class;
- ``pca`` equals ``sklearn.decomposition.PCA(random_state=0)`` on the
  float64 data up to each component's sign, within 1e-5;
- ``tsne`` in 2D and 3D against ``TSNE(init="pca", method="exact")`` on the
  same float32 PCA projection ``mer_tpu`` passes it: final KL within 10% of
  sklearn's ``kl_divergence_``, ``trustworthiness`` (k 5) within 0.02 of
  sklearn's; the planted fault, a 3D run without early exaggeration, fails
  the KL check (exact 3D t-SNE takes other minima from small changes: on
  these points sklearn's own float32 and float64 runs part by 3%);
- the HTML page is byte-equal to ``mer_tpu``'s ``write_scatter_html``
  (plotly is absent here); the PNG decodes with PIL to 800 x 800 RGB with
  every class's disc colour present;
- ``visualize_embeddings`` writes ``mer_tpu``'s paths and uploads through
  the logger; the mel export with ``DEBUG.visualize`` (3D) plots the val
  split from a ``mer_tpu`` mel checkpoint, and ``MelSolver.fit`` plots each
  epoch under ``DEBUG.visualize_during_training``.

The ``cuda`` legs hold ``project_embeddings`` and ``silhouette`` on the card
to their CPU results; this file imports scikit-learn and the JAX package
inside its tests, so they run on a machine with neither.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
import yaml

from mer_tpu_torch.utils import viz

N, C, SPREAD, WIDTH = 210, 7, 3.0, 300
KL_SHARE, TRUST_GAP = 0.10, 0.02


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def clusters(n=N, classes=C, spread=SPREAD, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, WIDTH)) * spread
    labels = rng.integers(0, classes, n)
    return (centers[labels] + rng.normal(size=(n, WIDTH))).astype(np.float32), labels


@pytest.fixture(scope="module")
def projected():
    """The clusters, their float32 PCA projection (the first 50 of
    sklearn's components, as mer_tpu's project_embeddings passes t-SNE) and
    sklearn's exact t-SNE of it in 2D and 3D (embedding, KL)."""
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE

    x, labels = clusters()
    xp = PCA(random_state=0).fit_transform(x)[:, :50]
    perplexity = min(30.0, max(5.0, N / 10))
    sk = {}
    for dims in (2, 3):
        tsne = TSNE(n_components=dims, perplexity=perplexity, init="pca", random_state=0, method="exact")
        sk[dims] = (tsne.fit_transform(xp), float(tsne.kl_divergence_))
    return {"x": x, "labels": labels, "xp": xp, "perplexity": perplexity, "sk": sk}


def test_silhouette_matches_sklearn(projected):
    from sklearn.metrics import silhouette_score

    x, labels = projected["x"], projected["labels"]
    assert abs(viz.silhouette(x, labels, device="cpu") - silhouette_score(x, labels)) <= 1e-6
    lone = labels.copy()
    lone[0] = C  # a class of one point: its silhouette is 0
    assert abs(viz.silhouette(x, lone, device="cpu") - silhouette_score(x, lone)) <= 1e-6
    assert viz.silhouette(x, np.zeros(N, int), device="cpu") == 0.0


def test_pca_matches_sklearn_up_to_sign(projected):
    from sklearn.decomposition import PCA

    x = projected["x"].astype(np.float64)
    want = PCA(random_state=0).fit_transform(x)
    got = viz.pca(x, device="cpu").numpy()
    assert got.shape == want.shape == (N, N)
    signs = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * signs, want, rtol=0, atol=1e-5)
    # sklearn's sign convention: each component's largest loading positive, so no flip is needed
    assert (signs[:50] == 1).all()


def _kl_off(kl, want):
    return abs(kl - want) / want


@pytest.mark.parametrize("dims", [2, 3])
def test_tsne_matches_sklearn_exact(projected, dims):
    from sklearn.manifold import trustworthiness

    y, kl = viz.tsne(projected["xp"], dims, perplexity=projected["perplexity"], device="cpu")
    sk_y, sk_kl = projected["sk"][dims]
    assert y.shape == (N, dims) and y.dtype == torch.float64
    assert _kl_off(kl, sk_kl) <= KL_SHARE, (kl, sk_kl)
    gap = trustworthiness(projected["xp"], y.numpy(), n_neighbors=5) - trustworthiness(projected["xp"], sk_y,
                                                                                        n_neighbors=5)
    assert abs(gap) <= TRUST_GAP, gap


def test_tsne_without_early_exaggeration_fails_the_kl_check(projected):
    """The planted fault: the schedule's first 250 iterations without early
    exaggeration end far from sklearn's KL."""
    _, kl = viz.tsne(projected["xp"], 3, perplexity=projected["perplexity"], early_exaggeration=1.0, device="cpu")
    assert _kl_off(kl, projected["sk"][3][1]) > KL_SHARE, kl


def test_project_embeddings_kinds():
    x, _ = clusters(n=60, seed=3)
    for kind, dims in (("2D", 2), ("3D", 3)):
        z = viz.project_embeddings(x, kind, device="cpu")
        assert z.shape == (60, dims) and z.dtype == np.float32 and np.isfinite(z).all()
    with pytest.raises(ValueError, match="not supported"):
        viz.project_embeddings(x, "4D", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            viz.silhouette(x, np.arange(60) % 3)  # the card by default


@pytest.mark.parametrize("dims, names", [(2, None), (3, "emotions")])
def test_html_equals_mer_tpu(dims, names, tmp_path):
    from mer_tpu.core.config import EMOTION_LABELS
    from mer_tpu.utils import viz as jax_viz

    rng = np.random.default_rng(dims)
    z = rng.normal(size=(40, dims)).astype(np.float32) * 20
    labels = rng.integers(0, 7, 40)
    label_names = EMOTION_LABELS if names else None
    title = f"t-SNE ({dims}D) — silhouette=0.1234"
    want = jax_viz.write_scatter_html(z, labels, str(tmp_path / "jax" / "v.html"), title, label_names=label_names)
    got = viz.write_scatter_html(z, labels, str(tmp_path / "port" / "v.html"), title, label_names=label_names)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit RGB PNG whose rows all use filter 0
    (what ``encode_png`` writes), checking every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        assert struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] == zlib.crc32(kind + body)
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
            assert body[8:10] == b"\x08\x02"
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("dims", [2, 3])
def test_png_decodes_with_every_class_colour(dims, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(dims)
    labels = np.arange(70) % 7
    z = (rng.normal(size=(70, dims)) + labels[:, None] * 4).astype(np.float32)
    path = viz.write_scatter_png(z, labels, str(tmp_path / "png" / "v.png"))
    with Image.open(path) as im:
        assert im.size == (viz.CANVAS, viz.CANVAS) and im.mode == "RGB"
        pixels = np.asarray(im)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), pixels)
    colours = {tuple(c) for c in pixels.reshape(-1, 3)}
    for label in range(7):
        assert viz.disc_colour(label) in colours, label
    assert (255, 255, 255) in colours


class _Recorder:
    def __init__(self):
        self.calls = []

    def log_image(self, key, path):
        self.calls.append(("image", key, path))

    def log_html(self, key, path):
        self.calls.append(("html", key, path))


def test_visualize_embeddings_paths_and_uploads(tmp_path):
    from sklearn.metrics import silhouette_score

    x, labels = clusters(n=50, seed=5)
    logger = _Recorder()
    out = viz.visualize_embeddings(x, labels, str(tmp_path / "vis"), epoch=3, kind="3D", logger=logger,
                                   device="cpu")
    assert set(out) == {"silhouette", "tsne", "png", "html"}
    assert out["png"] == str(tmp_path / "vis" / "png" / "visualization_3.png")
    assert out["html"] == str(tmp_path / "vis" / "html" / "visualization_3.html")
    assert os.path.getsize(out["png"]) > 0 and out["tsne"].shape == (50, 3)
    assert abs(out["silhouette"] - silhouette_score(x, labels)) <= 1e-6
    assert logger.calls == [("image", "Visualization_png", out["png"]), ("html", "Visualization_html", out["html"])]
    with open(out["html"]) as f:
        assert json.dumps(f"t-SNE (3D) — silhouette={out['silhouette']:.4f}") in f.read()


def _mel_config(path, root_ckpt, **debug):
    from mer_tpu_torch.feature_extractors.audio_mel import MEL_CONFIG_PATH

    with open(MEL_CONFIG_PATH) as f:
        raw = yaml.safe_load(f)
    raw["AUDIO"]["max_duration"] = 0.5
    raw["solver"]["len_triplet_picking"] = 16
    raw["DEBUG"].update(enabled=True, num_samples=16, **debug)
    for mode in ("train", "val", "test"):
        raw[mode]["data_loader"]["batch_size"] = 8
    raw["checkpoint"].update(save_path=root_ckpt, load_path=root_ckpt)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def test_mel_export_plots_the_val_split_from_a_mer_tpu_checkpoint(meld_like_root_with_wavs, tmp_path, capsys):
    """The shipped DEBUG.visualize / 3D: the silhouette of the val table
    (sklearn's within 1e-6) and the 3D PNG and HTML under
    <save_dir>/visualization, from a mer_tpu mel checkpoint."""
    import jax
    import jax.numpy as jnp
    from sklearn.metrics import silhouette_score

    from mer_tpu.models.resnet import AudioMelFeatureExtractor as JaxExtractor
    from mer_tpu.train.checkpoint import save_checkpoint
    from mer_tpu_torch.core import load_embeddings
    from mer_tpu_torch.data import MelFeatureDataset
    from mer_tpu_torch.core import load_config
    from mer_tpu_torch.feature_extractors.audio_mel import embeddings as embeddings_entry

    variables = JaxExtractor().init(jax.random.PRNGKey(0), jnp.zeros((1, 51, 128, 3)))
    ckpt = str(tmp_path / "ckpt" / "mer_tpu.ckpt")
    save_checkpoint(ckpt, epoch=2, params=variables["params"], extra={
        "min_loss_val": 1.0, "patience_counter": 0, "batch_stats": variables["batch_stats"]})
    config = _mel_config(str(tmp_path / "mel.yaml"), ckpt)
    save_dir = str(tmp_path / "emb")
    embeddings_entry.main(["--config", config, "--data-root", meld_like_root_with_wavs[0], "--device", "cpu"],
                          save_dir=save_dir)
    out = capsys.readouterr().out
    val = load_embeddings(os.path.join(save_dir, "val.pkl"))
    labels = MelFeatureDataset("val", load_config(config), data_root=meld_like_root_with_wavs[0],
                               device="cpu").get_labels()
    line = next(l for l in out.splitlines() if l.startswith("silhouette score (val): "))
    assert abs(float(line.split(": ")[1]) - silhouette_score(val, labels)) <= 5e-5  # printed to 4 places
    png = os.path.join(save_dir, "visualization", "png", "visualization_0.png")
    html = os.path.join(save_dir, "visualization", "html", "visualization_0.html")
    with open(png, "rb") as f:
        assert decode_png(f.read()).shape == (viz.CANVAS, viz.CANVAS, 3)
    with open(html) as f:
        page = f.read()
    assert '"dims": 3' in page and page.count("], [") == len(val) - 1


def test_mel_fit_plots_each_epoch(meld_like_root_with_wavs, tmp_path, monkeypatch, capsys):
    from mer_tpu_torch.feature_extractors.audio_mel import train as train_entry

    monkeypatch.chdir(tmp_path)  # mer_tpu's relative visualization/ directory
    config = _mel_config(str(tmp_path / "mel.yaml"), str(tmp_path / "ckpt" / "c.ckpt"),
                         visualize_during_training=True, visualization_type="2D")
    with open(config) as f:
        raw = yaml.safe_load(f)
    raw["solver"]["epochs"] = 2
    with open(config, "w") as f:
        yaml.safe_dump(raw, f)
    train_entry.main(["--config", config, "--data-root", meld_like_root_with_wavs[0], "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("Silhouette score: ") == 2
    for epoch in (0, 1):
        assert os.path.getsize(tmp_path / "visualization" / "png" / f"visualization_{epoch}.png") > 0
        assert os.path.getsize(tmp_path / "visualization" / "html" / f"visualization_{epoch}.html") > 0


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the visualisation's device path")
    return torch.device("cuda")


@pytest.mark.cuda
def test_silhouette_on_card_equals_cpu(cuda):
    x, labels = clusters()
    assert abs(viz.silhouette(x, labels, device=cuda) - viz.silhouette(x, labels, device="cpu")) <= 1e-9


def trustworthiness(x: np.ndarray, y: np.ndarray, k: int = 5) -> float:
    """scikit-learn's ``trustworthiness`` (euclidean) in numpy: how far the
    k nearest neighbours in ``y`` rank beyond k in ``x``."""
    def ranks(a):
        d = ((a[:, None] - a[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        return d
    n = len(x)
    rank_x = np.argsort(np.argsort(ranks(np.asarray(x, np.float64)), axis=1), axis=1) + 1
    nn_y = np.argsort(ranks(np.asarray(y, np.float64)), axis=1)[:, :k]
    excess = rank_x[np.arange(n)[:, None], nn_y] - k
    return float(1 - excess[excess > 0].sum() * 2 / (n * k * (2 * n - 3 * k - 1)))


def test_trustworthiness_restated_equals_sklearn(projected):
    from sklearn.manifold import trustworthiness as sk_trustworthiness

    y = projected["sk"][3][0]
    assert abs(trustworthiness(projected["xp"], y) - sk_trustworthiness(projected["xp"], y, n_neighbors=5)) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["2D", "3D"])
def test_project_embeddings_on_card_matches_cpu(cuda, kind):
    """The same schedule on the card: PCA within 1e-9 of the CPU's; every
    row of the perplexity search at its entropy (1e-5); one KL and gradient
    on the same points and the same P within 1e-10 of the CPU's; the whole run's KL no
    more than 10% above the CPU run's, and its trustworthiness (k 5) within
    0.02. Exact t-SNE in 3D lands in another minimum when the order of its
    sums changes (this leg's first card run: KL 0.450 on the card against
    0.563 on the CPU, from the same points), so the KL is held on one side:
    the card may find a better minimum, not a worse one."""
    x, _ = clusters()
    np.testing.assert_allclose(viz.pca(x, device=cuda).abs().cpu().numpy(), viz.pca(x, device="cpu").abs().numpy(),
                               rtol=0, atol=1e-9)
    xp = viz.pca(x, device="cpu")[:, :50]
    dims = 3 if kind == "3D" else 2
    card = xp.to(cuda)
    sq = ((card[:, None] - card[None]) ** 2).sum(-1)
    cond = viz._conditional_p(sq, N / 10)
    entropy = -(cond * torch.log(cond.clamp_min(1e-300))).sum(1)
    assert (entropy - np.log(N / 10)).abs().max().item() <= 1e-5
    joint = (cond + cond.T) / (cond + cond.T).sum()
    off = ~torch.eye(N, dtype=torch.bool)
    y = torch.from_numpy(np.random.default_rng(1).normal(size=(N, dims)))
    kl_cpu, grad_cpu = viz._kl_and_grad(y, joint.cpu() * off, max(dims - 1, 1.0), off)
    kl_card, grad_card = viz._kl_and_grad(y.to(cuda), joint * off.to(cuda), max(dims - 1, 1.0), off.to(cuda))
    assert abs(float(kl_card) - float(kl_cpu)) <= 1e-10 * abs(float(kl_cpu))
    torch.testing.assert_close(grad_card.cpu(), grad_cpu, rtol=1e-10, atol=1e-14)
    z_card, kl_card = viz.tsne(xp, dims, perplexity=N / 10, device=cuda)
    z_cpu, kl_cpu = viz.tsne(xp, dims, perplexity=N / 10, device="cpu")
    assert kl_card <= (1 + KL_SHARE) * kl_cpu, (kl_card, kl_cpu)
    gap = trustworthiness(xp.numpy(), z_card.cpu().numpy()) - trustworthiness(xp.numpy(), z_cpu.numpy())
    assert abs(gap) <= TRUST_GAP, gap
    z = viz.project_embeddings(x, kind, device=cuda)
    assert z.shape == (N, dims) and np.isfinite(z).all()
