"""Operational tools (counterpart of ``mer_tpu/tools.py``).

    python -m mer_tpu_torch.tools inspect <checkpoint>
    python -m mer_tpu_torch.tools export-torch <checkpoint> <out.pth> [config.yaml]
    python -m mer_tpu_torch.tools preflight [data_root] [--pretrained-text PATH] [--pretrained-wav2vec2 PATH]

``inspect`` prints a checkpoint's epoch, parameter and optimizer-state
counts, scalar ``extra`` entries and top-level names without building a
model: for a ``mer_tpu`` msgpack file or shard directory the dict
``mer_tpu``'s ``inspect_checkpoint`` prints, for the port's torch files the
same fields. ``export-torch`` writes the reference's ``{'epoch',
'model_state_dict'}`` ``.pth`` (reference src/test.py:35-41) from a
``mer_tpu`` fusion checkpoint, in either encoder layout, or from a port
checkpoint. Both run on the host.

``preflight`` checks local things only and fetches nothing: the card (name
and power limit from ``nvidia-smi``), ``nvcc``, a built library in
``mer_tpu_torch/_build/`` for every kernel source in ``csrc/``, the MELD
CSVs and wavs, a local pretrained RoBERTa and wav2vec2 (a ``torch.save``'d
Hugging Face ``state_dict`` file, or a directory holding one as
``pytorch_model.bin``) and the stage-1 embedding pickles the fusion config
reads. It prints ``[ok]`` / ``[MISSING]`` lines and the command that would
produce each missing item, and exits 0 only when everything is present.
Without a card it reports the card missing and raises nothing.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from mer_tpu_torch.core import CONFIG_PATH, load_config
from mer_tpu_torch.models.convert import is_mer_tpu_payload, port_payload, read_checkpoint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _count(tree) -> int:
    """Elements over every leaf of a nested dict / list tree (None is no
    leaf, a Python scalar is one), as ``jax.tree.leaves`` counts them."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return int(np.size(tree))


def inspect_checkpoint(path: str) -> dict:
    """The checkpoint's summary dict (``mer_tpu``'s ``inspect_checkpoint``)."""
    ckpt = read_checkpoint(path)
    if is_mer_tpu_payload(ckpt):
        params, opt_state, extra = ckpt["params"], ckpt.get("opt_state", {}), ckpt.get("extra", {})
        top_level = sorted(params.keys()) if isinstance(params, dict) else type(params).__name__
    else:
        params = ckpt.get("model_state_dict", ckpt)
        opt_state = (ckpt.get("optimizer_state_dict") or {}).get("state", {})
        extra = ckpt.get("extra", {})
        top_level = sorted({k.split(".")[0] for k in params})
    return {
        "path": path,
        "epoch": int(ckpt.get("epoch", 0)),
        "n_params": _count(params),
        "n_opt_state": _count(opt_state),
        "extra": {k: v for k, v in extra.items() if not hasattr(v, "shape")},
        "top_level": top_level,
    }


def export_torch(ckpt_path: str, out_path: str, config_path: str | None = None) -> None:
    """Write ``{'epoch', 'model_state_dict'}`` of the fusion model in
    ``ckpt_path`` (``mer_tpu``'s, either layout, or the port's) to ``out_path``."""
    cfg = load_config(config_path or CONFIG_PATH)
    payload = read_checkpoint(ckpt_path)
    epoch = int(payload["epoch"])
    sd = (port_payload(payload, "fusion", cfg.model)["model_state_dict"] if is_mer_tpu_payload(payload)
          else payload["model_state_dict"])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save({"epoch": epoch, "model_state_dict": {k: v.detach().cpu().contiguous() for k, v in sd.items()}},
               out_path)
    print(f"wrote {out_path} (epoch {epoch}, torch model_state_dict layout)")


# -- preflight -------------------------------------------------------------------


def card_summary() -> str | None:
    """``name, power limit`` of the first card as ``nvidia-smi`` reports it;
    the torch device name where ``nvidia-smi`` is missing; None without a card."""
    if not torch.cuda.is_available():
        return None
    smi = shutil.which("nvidia-smi")
    if smi:
        proc = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
        if proc.returncode == 0 and proc.stdout.strip():
            return proc.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0)


def _nvcc_path() -> str | None:
    from mer_tpu_torch.ops import _build

    try:
        return _build._nvcc()
    except RuntimeError:
        return None


def kernel_sources() -> list[str]:
    """The names of the kernel sources ``csrc/<name>.cu``."""
    from mer_tpu_torch.ops import _build

    return sorted(os.path.splitext(os.path.basename(p))[0] for p in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))


def _pretrained_present(path: str | None) -> bool:
    if not path:
        return False
    return os.path.isfile(path) or os.path.isfile(os.path.join(path, "pytorch_model.bin"))


def preflight(data_root: str | None = None, pretrained_text: str | None = None,
              pretrained_wav2vec2: str | None = None) -> int:
    """Print what the real-assets chain on the card has and lacks, with the
    command to run for each missing item; 0 when nothing is missing."""
    from mer_tpu_torch.ops import _build

    root = os.path.abspath(data_root or "data")
    raw = os.path.join(root, "MELD.Raw")
    checks: list[tuple[str, bool, str]] = []  # (label, present, fix command)

    card = card_summary()
    checks.append((f"card ({card or 'torch.cuda.is_available() is false'})", card is not None,
                   "run on a machine with an NVIDIA card: the entry points default to --device cuda"))
    nvcc = _nvcc_path()
    checks.append((f"nvcc ({nvcc or 'not on PATH or under $CUDA_HOME/bin'})", nvcc is not None,
                   "install the CUDA toolkit or set CUDA_HOME: the kernels are built from csrc/ at first use"))
    for name in kernel_sources():
        lib = _build.library_path(name)
        checks.append((f"kernel {name} ({os.path.relpath(lib, REPO_ROOT)})", os.path.exists(lib),
                       "python3 chip_smoke.py   # builds every kernel of csrc/ into mer_tpu_torch/_build/"))

    csvs = {"train": "train_sent_emo.csv", "val": "dev_sent_emo.csv", "test": "test_sent_emo.csv"}
    for split, name in csvs.items():
        p = os.path.join(raw, name)
        checks.append((f"{split} CSV ({p})", os.path.exists(p),
                       "bash scripts/MELD_download.sh   # downloads + unpacks MELD.Raw"))
    wav_dirs = {"train": "train_splits/wav", "val": "dev_splits_complete/wav",
                "test": "output_repeated_splits_test/wav"}
    for split, sub in wav_dirs.items():
        p = os.path.join(raw, sub)
        n = len([f for f in os.listdir(p) if f.endswith(".wav")]) if os.path.isdir(p) else 0
        checks.append((f"{split} wavs ({p}: {n} files)", n > 0,
                       f"python scripts/mp4towav.py {os.path.dirname(p)}   # mp4 -> 16 kHz wav"))

    for label, path, flag in (("roberta-base", pretrained_text, "--pretrained-text"),
                              ("facebook/wav2vec2-base", pretrained_wav2vec2, "--pretrained-wav2vec2")):
        checks.append((f"pretrained {label} ({path or 'no local file given'})", _pretrained_present(path),
                       f"stage a torch.save'd Hugging Face state_dict of {label} locally and pass {flag} "
                       "<file or directory with pytorch_model.bin>   # nothing is downloaded"))

    config = load_config(CONFIG_PATH)
    for key, stage in (("text", "text"), ("audio", "audio_wav2vec2")):
        d = os.path.join(REPO_ROOT, str(config.embeddings[key]))
        have = all(os.path.exists(os.path.join(d, f"{s}.pkl")) for s in ("train", "val", "test"))
        checks.append((f"stage-1 embeddings ({d})", have,
                       f"python -m mer_tpu_torch.feature_extractors.{stage}.train --data-root {root} && "
                       f"python -m mer_tpu_torch.feature_extractors.{stage}.embeddings --data-root {root}"))

    missing = [(label, fix) for label, ok, fix in checks if not ok]
    for label, ok, _ in checks:
        print(f"  [{'ok' if ok else 'MISSING'}] {label}")
    if not missing:
        print("\nAll assets present. Full chain:")
        print(f"  python -m mer_tpu_torch.train --data-root {root}   # stage-2 fusion training")
        print("  python -m mer_tpu_torch.test                        # MELD-test weighted F1")
        return 0
    print(f"\n{len(missing)} missing. Commands to run once each asset is stageable:")
    seen = set()
    for _, fix in missing:
        if fix not in seen:
            seen.add(fix)
            print(f"  {fix}")
    return 1


USAGE = ("usage: python -m mer_tpu_torch.tools inspect <checkpoint>\n"
         "       python -m mer_tpu_torch.tools export-torch <checkpoint> <out.pth> [config.yaml]\n"
         "       python -m mer_tpu_torch.tools preflight [data_root] [--pretrained-text PATH] "
         "[--pretrained-wav2vec2 PATH]")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in {"inspect", "export-torch", "preflight"}:
        print(USAGE, file=sys.stderr)
        return 1
    if argv[0] == "inspect":
        print(json.dumps(inspect_checkpoint(argv[1]), indent=2, default=str))
    elif argv[0] == "export-torch":
        export_torch(argv[1], argv[2], argv[3] if len(argv) > 3 else None)
    else:
        p = argparse.ArgumentParser(prog="python -m mer_tpu_torch.tools preflight")
        p.add_argument("data_root", nargs="?", default=None)
        p.add_argument("--pretrained-text", default=None)
        p.add_argument("--pretrained-wav2vec2", default=None)
        args = p.parse_args(argv[1:])
        return preflight(args.data_root, args.pretrained_text, args.pretrained_wav2vec2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
