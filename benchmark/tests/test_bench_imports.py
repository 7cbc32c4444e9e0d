"""Nothing the benchmark runs loads JAX or the JAX package, and a run
without a card, or without the program, prints no result."""

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|mer_tpu)(\s|\.|$|,)", re.M)


def test_sources_import_no_jax():
    for base, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    assert not FORBIDDEN.search(fh.read()), f


def test_import_closure_of_a_run():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.tests.tiny_cells import cell, run\n"
        "from benchmark.harness.cell import loaded_forbidden, reader\n"
        "for name in ('wav2vec2-base.finetune', 'mer-meld.label'):\n"
        "    c = cell(name)\n"
        "    run(c, trace=True)\n"
        "    [reader(m['name']) for m in c.per_layer]\n"
        "import benchmark.controls\n"
        "print('FOUND', loaded_forbidden())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert "FOUND []" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mer-meld.label", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout
