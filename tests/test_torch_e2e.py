"""The port's end-to-end streaming slice against the JAX package's, on the CPU.

On ``conftest.py::meld_like_root_with_wavs`` (0.25-0.75 s clips) with narrow
models (width 32, one layer; wav2vec2 on the base conv schedule at 32
channels) in both packages, holding the same numpy-perturbed weights:

- μ-law: the encoder's codes bit-equal to ``mer_tpu``'s, the decoder within
  2e-7 of ``mer_tpu``'s ``mulaw_decode`` and ``mulaw_decode_np``, code 128
  exactly 0.0;
- the native wav decoder (built into ``mer_tpu_torch/_build/``; a failed
  build raises): the same bits as ``mer_tpu``'s decoder and the port's
  ``load_wav``, the -1, -2 and -3 codes; ``waveform_batch`` bit-equal to ``mer_tpu``'s, with and without the
  decoder, and a rate mismatch raising in the store;
- ``mixed_utterance_batches`` array-equal to ``mer_tpu``'s: both wires,
  sorted and corpus order, the (0.5, 1.0) s ladder;
- ``StreamingPipeline`` f32 tables within 1e-4 of the largest |value| of
  ``mer_tpu``'s on the wav2vec2 branch and 1e-3 on the mel branch (the
  uint8 log-mel levels differ there by one step at a few bins); the μ-law
  wire's audio embeddings within 0.05 relative of the int16 wire's;
  device-resident and host-table runs with equal metrics; the wire check and
  the mel branch's refusals;
- ``python -m mer_tpu_torch.e2e_stream`` on the CPU with narrow models, both
  wires, the int8 engines and the mel branch; ``--int8 --audio mel`` raises.
"""

import fcntl
import os
import tempfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mer_tpu.data import native_wavio as jax_native
from mer_tpu.data import TextFeatureDataset as JaxTextDataset
from mer_tpu.data import ToyWhitespaceTokenizer as JaxToyTokenizer
from mer_tpu.data import Wav2Vec2FeatureDataset as JaxW2VDataset
from mer_tpu.models import roberta as jax_roberta
from mer_tpu.models import wav2vec2 as jax_w2v
from mer_tpu.models.m2fnet import M2FNet as JaxM2FNet
from mer_tpu.ops import mulaw as jax_mulaw
from mer_tpu.pipelines import E2EModels as JaxE2EModels
from mer_tpu.pipelines import StreamingPipeline as JaxPipeline
from mer_tpu.pipelines import mixed_utterance_batches as jax_mixed_batches
from mer_tpu_torch import e2e_stream
from mer_tpu_torch.core import CONFIG_PATH, get_text, load_config, map_emotions
from mer_tpu_torch.data import native_wavio
from mer_tpu_torch.data.audio_io import load_wav, save_wav
from mer_tpu_torch.data.text_fe import TextFeatureDataset, ToyWhitespaceTokenizer
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2FeatureDataset
from mer_tpu_torch.models import (M2FNet, audio_state_dict_from_jax, mel_state_dict_from_jax, state_dict_from_jax,
                                  text_state_dict_from_jax)
from mer_tpu_torch.models.resnet import AudioMelFeatureExtractor
from mer_tpu_torch.models.roberta import RobertaConfig, TextERC
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config
from mer_tpu_torch.ops import mulaw
from mer_tpu_torch.ops.logmel import MelConfig
from mer_tpu_torch.pipelines import E2EModels, StreamingPipeline, mixed_utterance_batches

D = 32
TEXT = dict(vocab_size=1000, hidden_size=D, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=520)
W2V = dict(conv_dim=(32,) * 7, hidden_size=D, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
LADDER = (1.0,)  # every clip of the root fits one second
MEL_CFG = MelConfig(max_seconds=1.0)
BATCH, DIALOGUES = 8, 4


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def fusion_block(d_audio: int = D, n_head_audio: int = 4):
    """The narrow fusion ``model:`` block (one layer of each kind)."""
    return load_config(CONFIG_PATH).model.override(
        TEXT__embedding_size=D, AUDIO__embedding_size=d_audio, FAM__embedding_size=D, TEXT__n_head=4,
        AUDIO__n_head=n_head_audio, FAM__n_head=4, TEXT__n_encoder_layers=1, AUDIO__n_encoder_layers=1,
        FAM__n_layers=1, CLASSIFIER__hidden_size=D)


def _perturbed(params, seed: int):
    """``params`` (from a jitted ``init``: flax's eager init takes seconds a model) plus seeded noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _fusion(block, d_audio: int):
    jax_model = JaxM2FNet.from_config(block)
    params = _perturbed(jax.jit(jax_model.init)(jax.random.PRNGKey(2), jnp.zeros((2, 4, D)), jnp.zeros((2, 4, d_audio)),
                                       jnp.zeros((2, 4), bool))["params"], 2)
    port = M2FNet.from_config(block)
    port.load_state_dict(state_dict_from_jax(params, block), strict=True)
    return jax_model, params, port


def _text():
    jax_model = jax_roberta.TextERC(jax_roberta.RobertaConfig(**TEXT))
    params = _perturbed(jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                                       jnp.ones((2, 8), jnp.int32))["params"], 0)
    port = TextERC(RobertaConfig(**TEXT))
    port.load_state_dict(text_state_dict_from_jax(params), strict=True)
    return jax_model, params, port


def _datasets(root, mode: str = "val"):
    return ((TextFeatureDataset(mode, ToyWhitespaceTokenizer(), data_root=root),
             Wav2Vec2FeatureDataset(mode, data_root=root)),
            (JaxTextDataset(mode, JaxToyTokenizer(), data_root=root), JaxW2VDataset(mode, data_root=root)))


@pytest.fixture(scope="module")
def w2v_slice(meld_like_root_with_wavs):
    """Both packages' wav2vec2-branch pipelines over the same weights, and
    ``mer_tpu``'s f32 tables of the dev split (one run)."""
    root, sizes = meld_like_root_with_wavs
    text_jax, text_params, text_port = _text()
    audio_jax = jax_w2v.AudioERC(jax_w2v.Wav2Vec2Config(**W2V))
    audio_params = _perturbed(jax.jit(audio_jax.init)(jax.random.PRNGKey(1), jnp.zeros((2, 16000)),
                                             jnp.full((2,), 16000))["params"], 1)
    audio_port = AudioERC(Wav2Vec2Config(**W2V))
    audio_port.load_state_dict(audio_state_dict_from_jax(audio_params), strict=True)
    block = fusion_block()
    fusion_jax, fusion_params, fusion_port = _fusion(block, D)
    jax_pipe = JaxPipeline(JaxE2EModels(text_jax, text_params, audio_jax, audio_params, fusion_jax, fusion_params),
                           utterance_batch=BATCH, dialogue_batch=DIALOGUES)
    (port_ds, jax_ds) = _datasets(root)
    want = jax_pipe.embed_utterances(jax_mixed_batches(*jax_ds, batch_size=BATCH, seconds_buckets=LADDER))
    port = StreamingPipeline(E2EModels(text_port, audio_port, fusion_port), utterance_batch=BATCH,
                             dialogue_batch=DIALOGUES, device="cpu")
    return {"root": root, "sizes": sizes, "port": port, "port_ds": port_ds, "want": want,
            "models": (text_port, audio_port, fusion_port)}


# -- μ-law ------------------------------------------------------------------------------


def test_mulaw_encode_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(scale=0.3, size=20000), np.linspace(-1.5, 1.5, 4097), [0.0, -0.0, 1.0, -1.0]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(mulaw.mulaw_encode_np(x), jax_mulaw.mulaw_encode_np(x))
    assert mulaw.MU == jax_mulaw.MU and mulaw.MULAW_ZERO == jax_mulaw.MULAW_ZERO == 128


def test_mulaw_decode_matches():
    codes = np.arange(256, dtype=np.uint8)
    got = mulaw.mulaw_decode(torch.from_numpy(codes))
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(jax_mulaw.mulaw_decode(jnp.asarray(codes))), rtol=0, atol=2e-7)
    np.testing.assert_allclose(got, jax_mulaw.mulaw_decode_np(codes), rtol=0, atol=2e-7)
    np.testing.assert_allclose(mulaw.mulaw_decode_np(codes), jax_mulaw.mulaw_decode_np(codes), rtol=0, atol=2e-7)
    assert got[mulaw.MULAW_ZERO] == 0.0 and mulaw.mulaw_decode_np(codes)[128] == 0.0
    assert mulaw.mulaw_encode_np(np.zeros(3, np.float32)).tolist() == [128] * 3


# -- the native wav decoder and the batch decode ----------------------------------------


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e_wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        n = int(rng.integers(1000, 20000))
        save_wav(d / f"clip{i}.wav", (0.5 * np.sin(np.arange(n) * 0.12) + 0.1 * rng.normal(size=n)), 16000)
        paths.append(str(d / f"clip{i}.wav"))
    save_wav(d / "rate8k.wav", 0.1 * rng.normal(size=4000), 8000)
    (d / "bad.wav").write_bytes(b"RIFF\x00\x00\x00\x00JUNKnot a wav file")
    return d, paths


def test_native_decoder_builds_into_the_package():
    path = native_wavio.library_path()
    assert os.path.dirname(path) == native_wavio.BUILD_DIR
    assert os.path.basename(path).startswith("libwavio_") and path.endswith(".so")
    assert native_wavio.SOURCE.endswith(os.path.join("native", "wavio.cc"))
    native_wavio.load()
    assert os.path.exists(path)


def test_failed_decoder_build_raises(monkeypatch, tmp_path):
    """No silent fallback to the stdlib reader: a compiler that fails raises."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native_wavio, "library_path", lambda: str(tmp_path / "libwavio_test.so"))
    with pytest.raises(RuntimeError, match="failed for wavio.cc"):
        native_wavio.build()
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def jax_native_loaded():
    """``mer_tpu``'s decoder, loaded from a complete ``native/libwavio.so``.

    Its first use builds the library with ``make`` into ``native/``, where the
    linker writes the file in place. Under pytest-xdist every worker imports
    ``tests/test_native_wavio.py``, whose collection calls ``available()``: a
    worker that opens the file while another worker's linker is still writing
    it fails to load it and keeps ``_build_failed`` set for the rest of its
    life. So clear the flag and load again, under a lock that keeps this
    file's own workers from building at once, until a complete library loads."""
    lock = os.path.join(tempfile.gettempdir(), f"mer_tpu_libwavio_{os.getuid()}.lock")
    deadline = time.monotonic() + 180.0
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            while True:
                jax_native._build_failed = False
                if jax_native._load() is not None:
                    return jax_native
                if time.monotonic() > deadline:
                    pytest.fail(f"mer_tpu's native decoder did not load from {jax_native._SO_PATH}")
                time.sleep(0.5)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.mark.parametrize("width", [16000, 2000])
def test_decode_wav_batch_bit_equal(wav_files, width, jax_native_loaded):
    _, paths = wav_files
    out, lengths = native_wavio.decode_wav_batch(paths, width, expect_rate=16000)
    want, want_lengths = jax_native.decode_wav_batch(paths, width, expect_rate=16000)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(lengths, want_lengths)
    assert lengths.dtype == np.int32 and out.dtype == np.float32
    for i, p in enumerate(paths):
        ref = load_wav(p)[0][:width]
        assert lengths[i] == len(ref)
        np.testing.assert_array_equal(out[i, : len(ref)], ref)
        assert not out[i, len(ref):].any()


def test_decode_wav_batch_error_codes(wav_files):
    d, paths = wav_files
    names = [paths[0], str(d / "missing.wav"), str(d / "bad.wav"), str(d / "rate8k.wav")]
    _, lengths = native_wavio.decode_wav_batch(names, 4000, expect_rate=16000)
    assert lengths.tolist()[1:] == [native_wavio.ERR_OPEN, native_wavio.ERR_FORMAT, native_wavio.ERR_RATE]
    assert lengths[0] > 0
    assert native_wavio.decode_wav_batch(names[3:], 4000)[1].tolist() == [4000]  # no rate asked: decoded


@pytest.mark.parametrize("native", [True, False])
def test_waveform_batch_bit_equal(meld_like_root_with_wavs, monkeypatch, native, jax_native_loaded):
    root, _ = meld_like_root_with_wavs
    if not native:
        monkeypatch.setenv("MER_TPU_NATIVE", "0")
        monkeypatch.setattr(native_wavio, "load", lambda: pytest.fail("MER_TPU_NATIVE=0 still decoded natively"))
    port, ref = Wav2Vec2FeatureDataset("val", data_root=root), JaxW2VDataset("val", data_root=root)
    indices = np.array([3, 0, 5, 5, 1])
    for width in (16000, 6000):
        got, lengths = port.waveform_batch(indices, width)
        want, want_lengths = ref.waveform_batch(indices, width)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(lengths, want_lengths)
        assert lengths.dtype == np.int32


def test_waveform_batch_rate_mismatch_raises(meld_like_root_with_wavs, tmp_path):
    """An 8 kHz file: the native decoder rejects it (-3), the store resamples
    it as ``mer_tpu``'s does (within 1e-6), and a store told not to
    resample raises."""
    root, _ = meld_like_root_with_wavs
    ds, ref = Wav2Vec2FeatureDataset("val", data_root=root), JaxW2VDataset("val", data_root=root)
    dia, utt = ds.dia_utt[2]
    tone = 0.5 * np.sin(2 * np.pi * 440 * np.arange(4000) / 8000)
    save_wav(tmp_path / f"dia{dia}_utt{utt}.wav", tone.astype(np.float32), 8000)
    ds.store.audio_dir = ref.store.audio_dir = str(tmp_path)  # row 2 now reads an 8 kHz file
    assert native_wavio.decode_wav_batch([ds.store.path_for(dia, utt)], 16000, 16000)[1][0] == native_wavio.ERR_RATE
    got, lengths = ds.waveform_batch(np.array([2]), 16000)
    want, want_lengths = ref.waveform_batch(np.array([2]), 16000)
    assert lengths.tolist() == want_lengths.tolist() == [8000]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ds.store.resample_if_needed = False
    ds.store._load.cache_clear()
    with pytest.raises(ValueError, match="sample rate"):
        ds.waveform_batch(np.array([2]), 16000)


# -- batching ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
@pytest.mark.parametrize("sort", [True, False])
def test_mixed_batches_equal(meld_like_root_with_wavs, wire, sort):
    root, _ = meld_like_root_with_wavs
    (port_ds, jax_ds) = _datasets(root)
    got = list(mixed_utterance_batches(*port_ds, batch_size=BATCH, seconds_buckets=(0.5, 1.0), sort_by_length=sort,
                                       wire=wire))
    want = list(jax_mixed_batches(*jax_ds, batch_size=BATCH, seconds_buckets=(0.5, 1.0), sort_by_length=sort,
                                  wire=wire))
    assert len(got) == len(want) == -(-len(port_ds[0]) // BATCH)
    widths = set()
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        widths.add(g["audio"].shape[1])
        assert g["audio"].dtype == (np.uint8 if wire == "mulaw" else np.int16)
    assert (got[-1]["emotion"] == -1).any()
    assert widths <= {8000, 16000}


def test_mixed_batches_token_ladder_and_truncation(meld_like_root_with_wavs):
    """Past the last rung the tokenizer truncates, as ``mer_tpu``'s generator does."""
    root, _ = meld_like_root_with_wavs
    (port_ds, jax_ds) = _datasets(root)
    port_ds[0].texts = [t + " word" * (40 + 17 * i) for i, t in enumerate(port_ds[0].texts)]
    jax_ds[0].texts = list(port_ds[0].texts)
    for ladder in ((64, 128, 256, 512), (64, 128)):
        got = list(mixed_utterance_batches(*port_ds, batch_size=BATCH, seconds_buckets=LADDER, token_buckets=ladder))
        want = list(jax_mixed_batches(*jax_ds, batch_size=BATCH, seconds_buckets=LADDER, token_buckets=ladder))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["text"], w["text"])
            np.testing.assert_array_equal(g["attention_mask"], w["attention_mask"])
            assert g["text"].shape[1] in ladder
    assert max(b["text"].shape[1] for b in got) == 128


def test_mixed_batches_bad_wire(meld_like_root_with_wavs):
    root, _ = meld_like_root_with_wavs
    (port_ds, _) = _datasets(root)
    with pytest.raises(ValueError, match="wire"):
        next(mixed_utterance_batches(*port_ds, wire="float32"))


# -- the pipeline -----------------------------------------------------------------------


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def test_w2v_tables_match_mer_tpu(w2v_slice):
    s = w2v_slice
    text, audio = s["port"].embed_utterances(mixed_utterance_batches(*s["port_ds"], batch_size=BATCH,
                                                                     seconds_buckets=LADDER))
    want_text, want_audio = s["want"]
    assert text.shape == want_text.shape == (s["sizes"]["val"], D) and text.dtype == np.float32
    assert audio.shape == want_audio.shape
    assert _rel(text, want_text) < 1e-4
    assert _rel(audio, want_audio) < 1e-4


def test_device_resident_and_host_tables_agree(w2v_slice):
    s = w2v_slice
    df = map_emotions(get_text("val", data_root=s["root"]))
    batches = lambda **kw: mixed_utterance_batches(*s["port_ds"], batch_size=BATCH, seconds_buckets=(0.5, 1.0), **kw)
    resident = s["port"].run(batches(), df)
    host = s["port"].run(batches(), df, device_resident=False)
    corpus = s["port"].run(batches(sort_by_length=False), df)
    assert resident["n_utterances"] == host["n_utterances"] == corpus["n_utterances"] == s["sizes"]["val"]
    for other in (host, corpus):
        assert other["accuracy"] == resident["accuracy"] and other["weighted_f1"] == resident["weighted_f1"]
    stages = resident["stages"]
    for key in ("embed_host_prep_s", "embed_dispatch_s", "embed_fetch_s", "stage1_embed_s", "stage1_device_wait_s",
                "group_s", "stage2_fusion_s"):
        assert stages[key] >= 0.0, key
    wire = list(batches())
    assert stages["embed_h2d_bytes"] == sum(b[k].nbytes for b in wire
                                            for k in ("text", "attention_mask", "audio", "lengths"))
    assert stages["stage1_embed_s"] + stages["group_s"] + stages["stage1_device_wait_s"] \
        + stages["stage2_fusion_s"] <= resident["seconds"] + 1e-6
    table_t, table_a, pos = s["port"].embed_utterances(batches(), fetch=False)
    text, audio = s["port"].embed_utterances(batches())
    np.testing.assert_allclose(table_t[torch.from_numpy(pos)].numpy(), text, rtol=0, atol=1e-6)
    np.testing.assert_allclose(table_a[torch.from_numpy(pos)].numpy(), audio, rtol=0, atol=1e-6)


def test_missing_rows_raise(w2v_slice):
    s = w2v_slice
    first_only = list(mixed_utterance_batches(*s["port_ds"], batch_size=BATCH, seconds_buckets=LADDER))[:1]
    with pytest.raises(ValueError, match="never appeared"):
        s["port"].embed_utterances(iter(first_only), fetch=False)


def test_mulaw_wire_envelope_and_wire_check(w2v_slice):
    s = w2v_slice
    pipe = StreamingPipeline(E2EModels(*s["models"]), utterance_batch=BATCH, dialogue_batch=DIALOGUES,
                             wire="mulaw", device="cpu")
    batches = lambda wire: mixed_utterance_batches(*s["port_ds"], batch_size=BATCH, seconds_buckets=LADDER,
                                                   wire=wire)
    _, audio = pipe.embed_utterances(batches("mulaw"))
    _, exact = s["port"].embed_utterances(batches("int16"))
    assert float(np.linalg.norm(audio - exact) / np.linalg.norm(exact)) < 0.05
    with pytest.raises(ValueError, match="wire"):
        pipe.embed_utterances(batches("int16"))
    with pytest.raises(ValueError, match="wire"):
        s["port"].embed_utterances(batches("mulaw"))
    with pytest.raises(ValueError, match="wire"):
        StreamingPipeline(E2EModels(*s["models"]), wire="float32", device="cpu")


@pytest.fixture(scope="module")
def mel_slice(meld_like_root_with_wavs):
    root, sizes = meld_like_root_with_wavs
    from mer_tpu.models.resnet import AudioMelFeatureExtractor as JaxMel
    from mer_tpu.ops.logmel import MelConfig as JaxMelConfig

    text_jax, text_params, text_port = _text()
    mel_jax = JaxMel()
    variables = jax.jit(mel_jax.init)(jax.random.PRNGKey(3), jnp.zeros((2, MEL_CFG.max_frames, MEL_CFG.n_mels, 3)))
    mel_port = AudioMelFeatureExtractor()
    mel_port.load_state_dict(mel_state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]),
                                                     jax.tree.map(np.asarray, variables["batch_stats"])), strict=True)
    block = fusion_block(300, 6)
    fusion_jax, fusion_params, fusion_port = _fusion(block, 300)
    jax_pipe = JaxPipeline(JaxE2EModels(text_jax, text_params, mel_jax, variables["params"], fusion_jax,
                                        fusion_params, audio_batch_stats=variables["batch_stats"]),
                           utterance_batch=BATCH, dialogue_batch=DIALOGUES, mel_cfg=JaxMelConfig(max_seconds=1.0))
    (port_ds, jax_ds) = _datasets(root)
    want = jax_pipe.embed_utterances(jax_mixed_batches(*jax_ds, batch_size=BATCH, seconds_buckets=LADDER))
    return {"root": root, "sizes": sizes, "port_ds": port_ds, "want": want,
            "models": (text_port, mel_port, fusion_port)}


def test_mel_tables_match_mer_tpu(mel_slice):
    s = mel_slice
    pipe = StreamingPipeline(E2EModels(*s["models"]), utterance_batch=BATCH, dialogue_batch=DIALOGUES,
                             mel_cfg=MEL_CFG, device="cpu")
    assert pipe.audio_kind == "mel"
    text, audio = pipe.embed_utterances(mixed_utterance_batches(*s["port_ds"], batch_size=BATCH,
                                                                seconds_buckets=LADDER))
    assert audio.shape == (s["sizes"]["val"], 300)
    assert _rel(text, s["want"][0]) < 1e-4
    assert _rel(audio, s["want"][1]) < 1e-3
    result = pipe.run(mixed_utterance_batches(*s["port_ds"], batch_size=BATCH, seconds_buckets=LADDER),
                      map_emotions(get_text("val", data_root=s["root"])))
    assert result["n_utterances"] == s["sizes"]["val"] and 0.0 <= result["accuracy"] <= 1.0


def test_mel_branch_refusals(mel_slice):
    text, mel, fusion = mel_slice["models"]
    with pytest.raises(ValueError, match="int8"):
        StreamingPipeline(E2EModels(text, mel, fusion), engine="int8", device="cpu")
    bare = AudioMelFeatureExtractor()
    bare.resnet18.bn1.running_mean = None
    with pytest.raises(ValueError, match="batch_stats"):
        StreamingPipeline(E2EModels(text, bare, fusion), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        StreamingPipeline(E2EModels(text, mel, fusion), engine="fp8", device="cpu")


# -- the entry point --------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--wire", "mulaw", "--corpus-order"], ["--int8", "--per-batch-stage1"],
                                   ["--audio", "mel", "--no-coalesce"]])
def test_e2e_stream_entry(meld_like_root_with_wavs, tmp_path, monkeypatch, capsys, flags):
    root, sizes = meld_like_root_with_wavs
    monkeypatch.chdir(tmp_path)  # no checkpoints here: seeded weights
    mel = "mel" in flags
    block = fusion_block()
    result = e2e_stream.main(["--data-root", root, "--toy-tokenizer", "--utterance-batch", "8", "--device", "cpu",
                              *flags], model_configs=(RobertaConfig(**TEXT), Wav2Vec2Config(**W2V), block))
    out = capsys.readouterr().out
    assert result["n_utterances"] == sizes["test"] and 0.0 <= result["accuracy"] <= 1.0
    assert result["utterances_per_sec"] > 0 and result["stages"]["embed_h2d_bytes"] > 0
    assert "seeded random weights" in out and out.count("e2e streaming: ") == 1 and "e2e stages: {" in out
    assert ("mel extractor" in out) == mel


def test_e2e_stream_int8_mel_raises(meld_like_root_with_wavs, tmp_path, monkeypatch):
    root, _ = meld_like_root_with_wavs
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="int8"):
        e2e_stream.main(["--data-root", root, "--toy-tokenizer", "--device", "cpu", "--int8", "--audio", "mel"],
                        model_configs=(RobertaConfig(**TEXT), Wav2Vec2Config(**W2V), fusion_block()))
