#!/usr/bin/env python3
"""`chip_smoke.py`'s export phase alone, on one card, on models that were
not trained.

    python3 tools/torch_export_check.py [--seed S]

Writes the three models of `chip_smoke.EXPORT_PATHS` (ResNet32 TK@3x,
ResNet-50 TT@3x, DeiT-tiny TT@2x) at their initialisation from --seed as
the JAX package's msgpack into a temporary directory, where
`chip_smoke.phase_main` would have written the fine-tuned ones, then runs
`chip_smoke.phase_export` on them: the CLI's ONNX and torch.export files
run again on the card against the eager models, the `.pth` round trip,
the refused MobileNetV2 export and the TT-LSTM demo. Prints the card's
`nvidia-smi` name and power limit, then the phase's JSON line; exits
non-zero where a check fails. A quick check of the export path that
needs none of the script's ADMM phases.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.models import create_model  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import (  # noqa: E402
    save_variables)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (  # noqa: E402
    state_dict_to_jax)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_export_check: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        for key in chip_smoke.EXPORT_PATHS:
            path = chip_smoke.PATHS[key]
            model = create_model(
                path["model"], ratio=path["ratio_arg"],
                num_classes=path["classes"],
                generator=torch.Generator().manual_seed(args.seed))
            save_variables(chip_smoke.ft_checkpoint(workdir, key),
                           state_dict_to_jax(model.state_dict()))
        chip_smoke.phase_export(args.seed, smi, workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
