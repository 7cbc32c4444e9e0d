"""The port's ``utils/profiling.py`` against ``mer_tpu/utils/profiling.py``:
the FLOP models equal ``mer_tpu``'s for the same dims (the fusion model of
``src/config.yaml``, RoBERTa-base, wav2vec2-base on 10 s clips), ``mfu``
against the H100 peaks, ``trace`` on the CPU, and the card's peaks defined
in one place."""

import glob
import json
import os
import re

import pytest
import torch

from mer_tpu_torch.utils import trace
from mer_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the data-sheet rates as literals: HBM bytes/s, bf16, f32, TF32, int8
PEAK_LITERAL = re.compile(r"(?<![\w.])(3\.35e12|989(?:\.0*)?e12|67(?:\.0*)?e12|495(?:\.0*)?e12|1979(?:\.0*)?e12|"
                          r"1_?979e12|3_?350_?000_?000_?000)(?![\w.])")


@pytest.fixture(scope="module")
def jax_profiling():
    pytest.importorskip("jax")
    from mer_tpu.utils import profiling as jax_profiling

    return jax_profiling


def test_fusion_flops_equal_mer_tpu(jax_profiling):
    """M2FNet as ``src/config.yaml`` builds it (the port's modules on the meta device, ``mer_tpu``'s flax
    dataclass), at the dialogue buckets."""
    from mer_tpu.core.config import load_config as jax_load_config
    from mer_tpu.models.m2fnet import M2FNet as JaxM2FNet

    from mer_tpu_torch.core import CONFIG_PATH, load_config
    from mer_tpu_torch.models import M2FNet

    with torch.device("meta"):
        model = M2FNet.from_config(load_config(CONFIG_PATH).model)
    jax_model = JaxM2FNet.from_config(jax_load_config(CONFIG_PATH).model)
    for batch, length in [(32, 8), (32, 33), (1, 1)]:
        want = jax_profiling.m2fnet_forward_flops(jax_model, batch, length)
        assert profiling.m2fnet_forward_flops(model, batch, length) == want > 0


def test_narrow_fusion_variants_equal_mer_tpu(jax_profiling):
    """Other widths, layer counts and stacks, and each modality alone (no FAM)."""
    from mer_tpu.models.m2fnet import M2FNet as JaxM2FNet

    from mer_tpu_torch.models import M2FNet

    for dims in [dict(d_model_audio=48, d_model_text=32, d_model_fam=40, n_layers_audio=2, n_layers_text=3,
                      n_layers_fam=2, n_transformers_audio=2, hidden_size_classifier=24),
                 dict(text_enabled=False, fam_enabled=False, d_model_audio=64, n_layers_audio=1),
                 dict(audio_enabled=False, fam_enabled=False, d_model_text=16, n_head_text=4)]:
        with torch.device("meta"):
            model = M2FNet(**dims)
        jax_model = JaxM2FNet(**dims)
        assert profiling.m2fnet_forward_flops(model, 4, 24) == jax_profiling.m2fnet_forward_flops(jax_model, 4, 24)


def test_roberta_and_wav2vec2_flops_equal_mer_tpu(jax_profiling):
    from mer_tpu.models.roberta import RobertaConfig as JaxRobertaConfig
    from mer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxWav2Vec2Config

    from mer_tpu_torch.models.roberta import RobertaConfig
    from mer_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    for batch, seq, head in [(32, 256, False), (16, 64, True)]:
        want = jax_profiling.roberta_forward_flops(JaxRobertaConfig.base(), batch, seq, with_head=head)
        assert profiling.roberta_forward_flops(RobertaConfig.base(), batch, seq, with_head=head) == want
    for batch, samples in [(32, 160000), (2, 40005)]:
        want = jax_profiling.wav2vec2_forward_flops(JaxWav2Vec2Config.base(), batch, samples)
        assert profiling.wav2vec2_forward_flops(Wav2Vec2Config.base(), batch, samples) == want
    # the encoder of wav2vec2-base at 10 s: 499 frames, 12 layers of width 768
    assert profiling.transformer_encoder_flops(499, 499, 768, 3072, 12) == \
        jax_profiling.transformer_encoder_flops(499, 499, 768, 3072, 12)


def test_mfu_against_the_h100_peaks():
    """The default peak is the card's dense bf16 rate; the others name theirs."""
    assert profiling.mfu(989e12 / 2, 1.0) == pytest.approx((494.5, 0.5))
    assert profiling.mfu(1e12, 1e-3, profiling.PEAK_TF32X3) == pytest.approx((1000.0, 1000.0 / 165.0))
    assert profiling.mfu(67e9, 1e-3, profiling.PEAK_F32) == pytest.approx((67.0, 1.0))
    assert profiling.mfu(1.0, 0.0) == pytest.approx((1.0, 1e12 / 989e12))  # a zero time counts as 1e-12 s
    peaks = (profiling.HBM_BYTES_PER_S, profiling.PEAK_BF16, profiling.PEAK_F32, profiling.PEAK_TF32,
             profiling.PEAK_INT8)
    assert peaks == (3.35e12, 989e12, 67e12, 495e12, 1979e12)
    assert profiling.PEAK_FLOPS == {torch.bfloat16: 989e12, torch.float32: 67e12}
    assert profiling.PEAK_TF32X3 == 495e12 / 3 and "H100" in profiling.CARD


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(None) as prof:
        assert prof is None
    assert not list(tmp_path.iterdir())
    out = tmp_path / "traces"
    with trace(str(out)) as prof:
        assert prof is not None
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(out / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_card_peaks_are_defined_once():
    """No module of the port nor ``chip_smoke.py`` writes a data-sheet rate but ``utils/profiling.py``; the
    scripts and the smoke import it."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + sorted(glob.glob(os.path.join(REPO, "mer_tpu_torch", "**", "*.py"),
                                                                     recursive=True))
    found = {}
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if PEAK_LITERAL.search(line.split("#")[0]):
                    found.setdefault(os.path.relpath(path, REPO), []).append(n)
    assert list(found) == [os.path.join("mer_tpu_torch", "utils", "profiling.py")], found
    assert len(found[os.path.join("mer_tpu_torch", "utils", "profiling.py")]) == 5
    for user in ["chip_smoke.py", "mer_tpu_torch/scripts/bench_attention.py",
                 "mer_tpu_torch/scripts/probe_gn_designs.py", "mer_tpu_torch/scripts/profile_w2v_conv.py"]:
        with open(os.path.join(REPO, user)) as f:
            assert "from mer_tpu_torch.utils.profiling import" in f.read(), user
