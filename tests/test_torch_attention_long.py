"""The port's long-sequence attention against the JAX package's.

The plain streaming forward ``flash_attention_stream_reference`` (K3's
algebra) is held against ``mer_tpu``'s streaming kernel
(``_flash_impl(..., force_stream=True)``) in interpret mode, and the plain
key-tiled backward ``flash_attention_tiled_backward_reference`` (K4's) against
``_flash_bwd_tiled`` in interpret mode, in float32: out and lse within 1e-5,
gradients within 2e-5 (sums over up to 1,100 keys of unit-scale products).

A fully masked batch element is where the two tiled backwards part: the TPU
kernel recomputes P = exp(s - lse) = 1 per key there (every score and the lse
round to -1e30), the port takes 1/Sk as the fused backward does. The port is
held to ``_flash_bwd_fused``'s values; a second test records the standing
difference (the TPU kernel's sum of dV over that element is Sk times the fused
one's).

The dispatch by key count (K1 / K3 at 4,096 keys, K2 / K4 at 2,048) is checked
on the CPU, where it picks the plain versions, with gradients through the
autograd Function against autodiff of ``_attention_reference``; the dropout
masks of the tiled versions against the single-pass ones, exactly. At the
model level a narrow wav2vec2 at more than 4,096 frames runs forward and
backward against ``mer_tpu``'s, and the port's batcher gives ``mer_tpu``'s
batches on 45-90 s clips. On the card (``cuda`` marker) K3 and K4 are held
against their plain versions, and P's probes run:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_long.py
"""

import math

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa

STREAM_TOL, TILED_TOL = 1e-5, 2e-5


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, sq, sk, dh, seed=0, mask_frac=0.25, fully_masked=None):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, h, sq, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, dh)).astype(np.float32) for _ in range(2))
    mask = rng.random((b, sk)) < mask_frac
    mask[:, 0] = False
    if fully_masked is not None:
        mask[fully_masked] = True
    return q, k, v, g, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from mer_tpu.ops.attention import _attention_reference
    from mer_tpu.ops.flash_attention import _NEG_INF, _flash_bwd_fused, _flash_bwd_tiled, _flash_impl

    def bias_of(mask):
        return jnp.where(jnp.asarray(mask), _NEG_INF, 0.0).astype(jnp.float32)

    def k3(q, k, v, mask):
        out, lse = _flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias_of(mask), interpret=True,
                               force_stream=True, return_stats=True)
        return np.asarray(out), np.asarray(lse)

    def backward(which, q, k, v, mask, out, lse, g, g_lse=None):
        fn = _flash_bwd_tiled if which == "tiled" else _flash_bwd_fused
        grads = fn(*(jnp.asarray(a) for a in (q, k, v)), bias_of(mask), jnp.asarray(out), jnp.asarray(lse),
                   jnp.asarray(g), True, g_lse=None if g_lse is None else jnp.asarray(g_lse))
        return [np.asarray(x) for x in grads]

    def grads_of_reference(q, k, v, mask, g_out, g_lse):
        """jax.grad of sum(out * g_out) + sum(lse * g_lse) through _attention_reference."""
        scale = 1.0 / math.sqrt(q.shape[-1])

        def loss(q, k, v):
            out = _attention_reference(q, k, v, key_padding_mask=jnp.asarray(mask), dropout_rate=0.0,
                                       dropout_rng=None, deterministic=True)
            s = jnp.einsum("bhqd,bhkd->bhqk", q * scale, k) + bias_of(mask)[:, None, None, :]
            lse = jax.scipy.special.logsumexp(s, axis=-1)
            return jnp.sum(out * g_out) + jnp.sum(lse * g_lse)

        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (q, k, v)))
        return [np.asarray(x) for x in grads]

    return {"k3": k3, "backward": backward, "grads_of_reference": grads_of_reference}


# -- K3's plain version ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2, 256, 1100, 32), (1, 2, 200, 1100, 32)],
                         ids=["three_tiles_ragged", "sq_ne_sk"])
def test_stream_plain_matches_k3_interpret(shape, jax_side):
    """Three 512-key tiles, the last ragged, a 25% key mask; Sq = Sk and Sq != Sk."""
    q, k, v, _, mask = _inputs(*shape, seed=1)
    want_out, want_lse = jax_side["k3"](q, k, v, mask)
    out, lse = fa.flash_attention_stream_reference(*_t(q, k, v, mask))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=STREAM_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=STREAM_TOL)


# -- K4's plain version ---------------------------------------------------------------


@pytest.mark.parametrize("with_g_lse", [False, True])
def test_tiled_backward_plain_matches_k4_interpret(with_g_lse, jax_side):
    q, k, v, g, mask = _inputs(1, 2, 256, 1024, 32, seed=2)
    g_lse = np.random.default_rng(3).normal(size=(1, 2, 256)).astype(np.float32) if with_g_lse else None
    out, lse = fa.flash_attention_stream_reference(*_t(q, k, v, mask))
    want = jax_side["backward"]("tiled", q, k, v, mask, out.numpy(), lse.numpy(), g, g_lse)
    got = fa.flash_attention_tiled_backward_reference(*_t(q, k, v, mask), out, lse, *_t(g), None, 0.0,
                                                      *_t(g_lse))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=TILED_TOL)


@pytest.fixture(scope="module")
def fully_masked_case(jax_side):
    """Inputs whose batch element 1 ignores every key, the forward, and
    mer_tpu's fused and tiled backwards of them."""
    q, k, v, g, mask = _inputs(2, 1, 128, 1024, 16, seed=4, fully_masked=1)
    out, lse = fa.flash_attention_stream_reference(*_t(q, k, v, mask))
    grads = {which: jax_side["backward"](which, q, k, v, mask, out.numpy(), lse.numpy(), g)
             for which in ("fused", "tiled")}
    return (q, k, v, g, mask, out, lse), grads


def test_fully_masked_element_matches_the_fused_backward(fully_masked_case):
    """Batch element 1 ignores every key: the port's tiled backward gives the
    fused backward's gradients there (P = 1/Sk), and sum(dV) of that element
    is sum(g), as softmax's rows sum to one."""
    (q, k, v, g, mask, out, lse), grads = fully_masked_case
    want = grads["fused"]
    got = fa.flash_attention_tiled_backward_reference(*_t(q, k, v, mask), out, lse, *_t(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=TILED_TOL)
    np.testing.assert_allclose(got[2][1].sum().item(), g[1].sum(), rtol=1e-4)


def test_mer_tpu_tiled_backward_differs_on_a_fully_masked_element(fully_masked_case):
    """A standing difference, kept on purpose: mer_tpu's K4 takes
    exp(s - lse) = 1 per key on a fully masked row, so sum(dV) of that
    element is Sk times the fused backward's; on the other element the two
    agree."""
    (q, k, v, g, *_), grads = fully_masked_case
    tiled, fused = grads["tiled"], grads["fused"]
    sk = k.shape[2]
    np.testing.assert_allclose(tiled[2][1].sum(), sk * fused[2][1].sum(), rtol=1e-3)
    assert abs(fused[2][1].sum() - g[1].sum()) < 1e-3 * abs(g[1].sum())
    for a, w in zip(tiled, fused):
        np.testing.assert_allclose(a[0], w[0], rtol=0, atol=TILED_TOL)


# -- dispatch and autograd --------------------------------------------------------------


@pytest.mark.parametrize("sk, forward_plain, backward_plain", [
    (2049, "flash_attention_reference", "flash_attention_tiled_backward_reference"),
    (4097, "flash_attention_stream_reference", "flash_attention_tiled_backward_reference"),
])
def test_cpu_dispatch_and_gradients_through_out_and_lse(sk, forward_plain, backward_plain, jax_side, monkeypatch):
    """The CPU path takes the plain version of the kernel the card would run;
    a loss reading out and lse exercises the lse cotangent in K4's algebra."""
    calls = []
    for name in ("flash_attention_reference", "flash_attention_stream_reference",
                 "flash_attention_backward_reference", "flash_attention_tiled_backward_reference"):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    q, k, v, g, mask = _inputs(1, 1, 16, sk, 8, seed=5, mask_frac=0.2)
    g_lse = np.random.default_rng(6).normal(size=(1, 1, 16)).astype(np.float32)
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    out, lse = fa.FlashAttention.apply(qt, kt, vt, torch.from_numpy(mask), None, 0.0)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(g_lse)).sum(),
                              (qt, kt, vt))
    assert calls == [forward_plain, backward_plain]
    want = jax_side["grads_of_reference"](q, k, v, mask, g, g_lse)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=TILED_TOL)


def test_k3_k4_wrappers_run_at_any_key_count():
    """Below the thresholds the dispatch picks K1 and K2; K3's and K4's own
    wrappers take any key count and agree with them. The thresholds: 4,096
    keys for the forward (K1 | K3 time alike), 33 for the backward (K4's
    Hopper design is faster than K2 at every crossover row from 48 keys,
    bench_attention.CROSSOVER_BACKWARD, recorded in PERF.md)."""
    q, k, v, g, mask = _t(*_inputs(1, 2, 8, 30, 8, seed=7))
    single = fa.flash_attention_forward(q, k, v, mask)
    streamed = fa.flash_attention_stream(q, k, v, mask)
    for a, b in zip(single, streamed):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    out, lse = single
    fused = fa.flash_attention_backward(q, k, v, mask, out, lse, g)
    tiled = fa.flash_attention_tiled_backward(q, k, v, mask, out, lse, g)
    for a, b in zip(fused, tiled):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert fa.flash_attention_stream.launches == fa.flash_attention_tiled_backward.launches == 0
    assert (fa.STREAM_THRESHOLD, fa.BWD_FUSED_MAX, fa.BLOCK_K) == (4096, 33, 512)


def test_dispatch_thresholds_equal_mer_tpu(jax_side):
    """The port's thresholds rest on the card's crossover rows
    (``bench_attention --crossover``): K1 and K3 time alike on either side,
    so the forward keeps mer_tpu's 4,096 keys (and the plain tiles its 512);
    K4's Hopper design beats K2 at every row from 48 keys ([16, 12, S, 64] at
    S = 48-499, [8-2, 12, 512-2,048, 64]; dropout 0 and 0.1), so the
    backward switches at the fusion buckets' 33 keys, below mer_tpu's 2,048."""
    from mer_tpu.ops import flash_attention as jax_fa

    assert (fa.STREAM_THRESHOLD, fa.BLOCK_K) == (jax_fa.STREAM_THRESHOLD, jax_fa.BLOCK_K)
    assert fa.BWD_FUSED_MAX == 33 < jax_fa.BWD_FUSED_MAX == 2048


# -- dropout -------------------------------------------------------------------------


def test_tiled_versions_draw_the_single_pass_masks_exactly():
    """With v = I the forward's out is P o D, with g = I the backward's dv^T
    is: the streaming and tiled plain versions, over two 512-key tiles, read
    off the single-pass versions' masks exactly."""
    b, h, sq, sk, rate, seed = 1, 2, 24, 600, 0.3, (99, 12345)
    rng = np.random.default_rng(8)
    want = fa.dropout_factor(seed, (b, h, sq, sk), rate) > 0
    q, k = (torch.from_numpy(rng.normal(size=(b, h, n, sk))) for n in (sq, sk))
    eye = lambda n: torch.eye(n, dtype=torch.float64).expand(b, h, n, n).contiguous()
    out, _ = fa.flash_attention_stream_reference(q, k, eye(sk), None, seed, rate)
    assert torch.equal(out > 0, want)
    single, _ = fa.flash_attention_reference(q, k, eye(sk), None, seed, rate)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=0, atol=1e-12)
    q = torch.from_numpy(rng.normal(size=(b, h, sq, sq)))
    k, v = (torch.from_numpy(rng.normal(size=(b, h, sk, sq))) for _ in range(2))
    out, lse = fa.flash_attention_reference(q, k, v, None, seed, rate)
    _, _, dv = fa.flash_attention_tiled_backward_reference(q, k, v, None, out, lse, eye(sq), seed, rate)
    assert torch.equal(dv.transpose(2, 3) > 0, want)
    fused = fa.flash_attention_backward_reference(q, k, v, None, out, lse, eye(sq), seed, rate)
    tiled = fa.flash_attention_tiled_backward_reference(q, k, v, None, out, lse, eye(sq), seed, rate)
    for a, b_ in zip(tiled, fused):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=1e-12)


# -- the path: wav2vec2 on long clips ---------------------------------------------------------


def test_narrow_wav2vec2_beyond_4096_frames_matches_jax(jax_side):
    """Forward (eval mode) and backward of a 2-layer, 2-head wav2vec2 with
    8-channel convs on a clip of 4,100 frames: the port's CPU path streams
    the forward (K3's algebra) and takes the tiled backward (K4's); mer_tpu's
    takes _attention_reference off the TPU (jitted here, for time). Logits
    within 1e-4, the attention projections' gradients within 1e-4 of their
    largest entry."""
    import jax
    import jax.numpy as jnp

    from mer_tpu.models import wav2vec2 as jax_w2v
    from mer_tpu_torch.models import audio_state_dict_from_jax
    from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config

    narrow = dict(conv_dim=(8,) * 7, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=32, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    cfg, jax_cfg = Wav2Vec2Config(**narrow), jax_w2v.Wav2Vec2Config(**narrow)
    lengths = np.array([(4100 - 1) * 320 + 400], np.int32)
    assert cfg.feat_extract_output_lengths(int(lengths[0])) == 4100
    rng = np.random.default_rng(9)
    waves = (0.1 * rng.normal(size=(1, lengths[0]))).astype(np.float32)
    jax_model = jax_w2v.AudioERC(jax_cfg)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 800)),
                                     jnp.full((1,), 800, jnp.int32))["params"]
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    labels = np.array([5])

    def jax_loss(p):
        logits = jax_model.apply({"params": p}, jnp.asarray(waves), jnp.asarray(lengths))
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], 1).mean(), logits

    (_, want_logits), jax_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    want_grads = audio_state_dict_from_jax(jax.tree.map(np.asarray, jax_grads))

    port = AudioERC(cfg)
    port.load_state_dict(audio_state_dict_from_jax(params), strict=True)
    port.eval()
    launches = fa.flash_attention_stream.launches, fa.flash_attention_tiled_backward.launches
    logits = port(torch.from_numpy(waves), torch.from_numpy(lengths))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    checked = 0
    for name, p in port.named_parameters():
        if ".attention." in name and name.endswith("weight"):
            want = want_grads[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
            checked += 1
    assert checked == 4 * cfg.num_hidden_layers
    assert (fa.flash_attention_stream.launches, fa.flash_attention_tiled_backward.launches) == launches


@pytest.fixture(scope="module")
def long_clip_root(tmp_path_factory):
    """A synthetic MELD root of one 45-90 s clip a dialogue: 8 train, 4 dev and 4 test clips."""
    from mer_tpu_torch.data import write_synthetic_meld

    root = str(tmp_path_factory.mktemp("long_clips"))
    counts = write_synthetic_meld(root, split_dialogues={"train_sent_emo.csv": 8, "dev_sent_emo.csv": 4,
                                                         "test_sent_emo.csv": 4},
                                  clip_seconds=(45.0, 90.0), max_utterances=1)
    assert list(counts.values()) == [8, 4, 4]
    return root


@pytest.mark.parametrize("shuffle", [False, True])
def test_long_clip_batches_equal_jax(long_clip_root, shuffle):
    from mer_tpu.data.wav2vec2_fe import Wav2Vec2Batcher as JaxBatcher
    from mer_tpu.data.wav2vec2_fe import Wav2Vec2FeatureDataset as JaxDataset
    from mer_tpu_torch.data.wav2vec2_fe import SECONDS_BUCKETS, Wav2Vec2Batcher, Wav2Vec2FeatureDataset

    buckets = (*SECONDS_BUCKETS, 60.0, 90.0)
    port_ds = Wav2Vec2FeatureDataset("train", data_root=long_clip_root, max_seconds=90.0)
    jax_ds = JaxDataset("train", data_root=long_clip_root, max_seconds=90.0)
    assert (port_ds.sample_rate, port_ds.max_seconds) == (jax_ds.sample_rate, jax_ds.max_seconds)
    lengths = port_ds.waveform_lengths()
    np.testing.assert_array_equal(lengths, jax_ds.waveform_lengths())
    assert lengths.min() >= 45 * 16000 and lengths.max() <= 90 * 16000
    got = list(Wav2Vec2Batcher(port_ds, 2, shuffle=shuffle, seed=4, seconds_buckets=buckets))
    want = list(JaxBatcher(jax_ds, 2, shuffle=shuffle, seed=4, seconds_buckets=buckets, process_index=0,
                           process_count=1))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["audio"].shape[1] in (60 * 16000, 90 * 16000)
        for key in ("idx", "audio", "lengths", "emotion"):
            np.testing.assert_array_equal(g[key], w[key])
    # the default ladder cuts such clips to 10 s, as mer_tpu's does
    assert next(iter(Wav2Vec2Batcher(Wav2Vec2FeatureDataset("test", data_root=long_clip_root), 2)))[
        "audio"].shape == (2, 160000)


def test_dataset_takes_a_waveform_store_and_max_seconds(long_clip_root):
    from mer_tpu_torch.data.audio_io import WaveformStore
    from mer_tpu_torch.data.mel_fe import wav_dir_for
    from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2FeatureDataset

    store = WaveformStore(wav_dir_for("val", long_clip_root), max_seconds=50.0)
    ds = Wav2Vec2FeatureDataset("val", data_root=long_clip_root, max_seconds=50.0, waveform_store=store)
    assert ds.store is store and ds.max_seconds == 50.0
    assert max(len(ds.waveform(i)) for i in range(len(ds))) == 50 * 16000
    np.testing.assert_array_equal(ds.waveform_lengths(), np.full(len(ds), 50 * 16000))


# -- the entry points: the attention bench and the probes P ------------------------------------


def test_bench_attention_names_the_dispatch_and_runs_on_cpu():
    from mer_tpu_torch.scripts import bench_attention

    assert [bench_attention.kernel_names(s) for s in (33, 34, 2048, 2049, 4096, 4097)] == [
        ("K1", "K2"), ("K1", "K4"), ("K1", "K4"), ("K1", "K4"), ("K1", "K4"), ("K3", "K4")]
    assert ("long_16384", 1, 12, 16384, 64) in bench_attention.SHAPES
    # [2, 12, 8192, 8192, 64] bf16: 412 GFLOP forward at 989 TFLOP/s; f32 at 67 TFLOP/s
    fwd, by = bench_attention.bound_ms(2, 12, 8192, 64, torch.bfloat16, backward=False)
    assert by == "operations" and fwd == pytest.approx(4 * 2 * 12 * 8192 ** 2 * 64 / 989e12 * 1e3)
    assert bench_attention.bound_ms(32, 12, 64, 64, torch.float32, backward=True)[1] == "bytes"
    (row,) = bench_attention.main(["--device", "cpu", "--shapes", "roberta_b32_s64", "--dtypes", "float32"])
    assert row["clock"] == "host (cpu)" and row["kernels"] == "K1 + K4"
    assert all(row[k] > 0 for k in ("kernel_fwd_ms", "kernel_fwdbwd_ms", "sdpa_fwd_ms", "sdpa_fwdbwd_ms"))


def test_probe_script_checks_every_probe_on_cpu(capsys):
    from mer_tpu_torch.scripts import probe_strided

    results = probe_strided.main(["--device", "cpu"])
    assert list(results) == list(probe_strided.PROBES) and all(r["ok"] for r in results.values())
    assert capsys.readouterr().out.count(" OK ") == len(probe_strided.PROBES)
    x, w = probe_strided.probe_input("cpu")
    # the TPU probe's expectations (scripts/probe_pallas_strided.py), in numpy
    xn = x.numpy()
    want = {"even_rows": xn[0::2], "odd_rows": xn[1::2], "fold_pairs": xn.reshape(128, 1024),
            "unfold_halves": xn.reshape(512, 256), "grid_reduce": xn.sum(0, keepdims=True)}
    for name, w_np in want.items():
        np.testing.assert_array_equal(probe_strided.probe_reference(name, x, w).numpy(), w_np)
    # each probe's library call (timed on the card) computes the probe's function; the product rounds to bf16
    for name in probe_strided.PROBES:
        got, ref = probe_strided.library_call(name, x, w)().float(), probe_strided.probe_reference(name, x, w)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2.0 ** -8 * ref.abs().max().item())
    assert probe_strided.run_probe.launches == 0


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel against plain version, same inputs: f32 |got - want| <= atol + rtol |want| (chip_smoke.py's TOL);
# bf16 |got - want| <= CARD_BF16_REL x the plain version's largest |value| (chip_smoke.py's ATTENTION_BF16_REL:
# out is about 0.005 at these key counts, under an absolute bf16 tolerance of 1e-2)
CARD_TOL = {"fwd": (2e-5, 0.0), "bwd": (1e-4, 1e-5)}
CARD_BF16_REL = 2e-2
# B = 2: batch element 0 ignores every key, element 1 attends to three quarters of them
CARD_CASES = [(1, 2, 300, 4097, 64), (2, 2, 130, 2049, 72), (1, 1, 64, 5000, 7), (2, 1, 1, 4100, 128)]


def _excess(got, want, key, dtype) -> float:
    """Largest excess over the limit (<= 0 passes)."""
    err, want = (got.float() - want.float()).abs(), want.float()
    if dtype == torch.bfloat16:
        return (err.max() - CARD_BF16_REL * want.abs().max()).item()
    atol, rtol = CARD_TOL[key]
    return (err - atol - rtol * want.abs()).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_k3_k4_match_plain_versions(case, dtype, rate, cuda):
    fully_masked = 0 if case[0] > 1 else None
    q, k, v, g, mask = (x.to(cuda) for x in _t(*_inputs(*case, seed=10, fully_masked=fully_masked)))
    q, k, v, g = (x.div(math.sqrt(3)).to(dtype) for x in (q, k, v, g))
    seed = (0xBEEF, 5) if rate else None
    g_lse = torch.randn(case[:3], device=cuda)
    launches = fa.flash_attention_stream.launches, fa.flash_attention_tiled_backward.launches
    out, lse = fa.flash_attention_stream(q, k, v, mask, seed, rate)
    grads = fa.flash_attention_tiled_backward(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_stream_reference(q, k, v, mask, seed, rate)
    ref = fa.flash_attention_tiled_backward_reference(q, k, v, mask, out, lse, g, seed, rate, g_lse)
    assert _excess(out, ref_out, "fwd", dtype) <= 0
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for got, want in zip(grads, ref):
        assert got.dtype == dtype and _excess(got, want, "bwd", dtype) <= 0
    assert (fa.flash_attention_stream.launches, fa.flash_attention_tiled_backward.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
def test_k4_reproduces_bitwise_and_backward_no_longer_raises(cuda):
    q, k, v, g, mask = (x.to(cuda) for x in _t(*_inputs(1, 2, 100, 3000, 64, seed=11)))
    out, lse = fa.flash_attention_forward(q, k, v, mask, (3, 4), 0.1)
    first = fa.flash_attention_backward(q, k, v, mask, out, lse, g, (3, 4), 0.1)
    second = fa.flash_attention_backward(q, k, v, mask, out, lse, g, (3, 4), 0.1)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_probes_run_exact(cuda):
    from mer_tpu_torch.scripts import probe_strided

    results = probe_strided.main([])
    assert results and all(r["ok"] for r in results.values()), results
