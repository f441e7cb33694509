#!/usr/bin/env python3
"""Which stage of the DeiT-tiny recipe path slows the later steps of its
process, on one card.

    python3 tools/torch_step_drift.py [--sequences NAME ...] [--seed S]
        [--out FILE]

The parent writes `synthetic-imagenet` as DCTA shards (512 train, 128
val images, as `chip_smoke.py`'s recipe path). Each sequence then runs
in a process of its own: a probe is one untraced epoch of 20 steps of
the dense DeiT-tiny X-step from the shards read whole (batch 128, bf16,
AdamW, Mixup 0.8 / CutMix 1.0), ms a step; the other stages run as the
path runs them, through the CLI:

* `probes`: eight probes in a row (the drift of a process that does
  nothing else);
* `cli`: the ADMM run of TT@2x (2 epochs x 20 streamed steps,
  `--save-model`) without `--profile-dir`, then with it, then
  `--decompose` and 20 fine-tune steps with RandAugment, erasing and
  repeated views; a probe before and after each;
* `traced_probe`: probes, one of them traced by `--profile-dir`'s
  `utils/profiling.trace`; `traced_probe_teardown1` and
  `traced_probe_teardown0` the same with the environment variable
  TEARDOWN_CUPTI set to 1 or 0, `traced_probe_cpu_only` with a trace of
  CPU activity alone.

Prints one JSON line per sequence, with the card's name and power limit,
and writes them to --out (default build/step_drift.jsonl).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEQUENCES = {"probes": {}, "cli": {}, "traced_probe": {},
             "traced_probe_teardown1": {"TEARDOWN_CUPTI": "1"},
             "traced_probe_teardown0": {"TEARDOWN_CUPTI": "0"},
             "traced_probe_cpu_only": {}}
STEPS = 20


def child(sequence: str, shards: str, seed: int) -> list:
    sys.path.insert(0, str(ROOT))
    import torch
    from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli
    from dnn_compression_tensor_admm_tpu_torch.train import (TrainConfig,
                                                              engine,
                                                              train_model)
    if sequence == "traced_probe_cpu_only":
        @contextlib.contextmanager
        def cpu_trace(logdir):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                yield p
            p.export_chrome_trace(os.path.join(logdir, "trace.json"))
        engine.trace = cpu_trace
    work = tempfile.mkdtemp(dir=shards)
    stages = []

    def probe(profile_dir=None):
        cfg = TrainConfig(model="deit_tiny_patch16_224",
                          dataset="synthetic-imagenet", shard_dir=shards,
                          shard_cache="hbm", epochs=1, steps_per_epoch=STEPS,
                          batch_size=128, opt="adamw", lr=5e-4, mixup=0.8,
                          cutmix=1.0, smoothing=0.1, seed=seed,
                          profile_dir=profile_dir, device="cuda",
                          print_fn=lambda line: None)
        row = train_model(cfg)[1][-1]
        stages.append({"stage": "probe" if profile_dir is None
                       else "traced_probe",
                       "ms_per_step": 1000 * row["x_step_s"] / STEPS})

    def run_cli(name, argv):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            cli(argv)
        torch.cuda.synchronize()
        stages.append({"stage": name, "s": time.perf_counter() - t0})

    common = ["--dataset", "synthetic-imagenet", "--shard-dir", shards,
              "--batch-size", "128", "--opt", "adamw", "--lr", "5e-4",
              "--sched", "cosine", "--mixup", "0.8", "--cutmix", "1.0",
              "--smoothing", "0.1", "--seed", str(seed)]
    admm = ["--model", "deit_tiny_patch16_224", "--admm", "--format", "tt",
            "--ratio", "2", "--warmup-epochs", "1", "--epochs", "2",
            "--steps-per-epoch", str(STEPS), "--loader-workers", "4",
            "--save-model", *common]
    if sequence == "probes":
        for _ in range(8):
            probe()
    elif sequence.startswith("traced_probe"):
        for _ in range(3):
            probe()
        probe(os.path.join(work, "profile"))
        for _ in range(3):
            probe()
    else:
        probe()
        probe()
        run_cli("admm_cli", [*admm, "--output-dir",
                             os.path.join(work, "plain")])
        probe()
        run_cli("admm_cli_profiled", [
            *admm, "--output-dir", os.path.join(work, "traced"),
            "--profile-dir", os.path.join(work, "profile")])
        probe()
        (ckpt,) = Path(work, "traced").glob("*_model.msgpack")
        run_cli("finetune_cli", [
            "--model", "ttm_deit_tiny_patch16_224", "--ratio", "2",
            "--decompose", "--model-path", str(ckpt), "--shard-cache", "hbm",
            "--aa", "rand-m9-mstd0.5", "--reprob", "0.25",
            "--repeated-aug", "3", "--sampling", "shuffle", "--epochs", "1",
            "--steps-per-epoch", str(STEPS), *common])
        probe()
        probe()
    return stages


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "step_drift.jsonl"))
    ap.add_argument("--sequences", nargs="+", choices=list(SEQUENCES),
                    default=["probes", "cli", "traced_probe"])
    ap.add_argument("--child", choices=list(SEQUENCES),
                    help=argparse.SUPPRESS)
    ap.add_argument("--shards", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.shards, args.seed)))
        return 0
    sys.path.insert(0, str(ROOT))
    from dnn_compression_tensor_admm_tpu_torch.data.datasets import (
        load_dataset)
    from dnn_compression_tensor_admm_tpu_torch.data.records import (
        write_shards)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        stdin=subprocess.DEVNULL).stdout.strip()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    failed = 0
    with tempfile.TemporaryDirectory() as shards, open(args.out, "w") as f:
        for train, prefix, n in ((True, "train", 512), (False, "val", 128)):
            x, y, _ = load_dataset("synthetic-imagenet", train, n)
            write_shards(x, y, shards, 128, prefix)
        for sequence in args.sequences:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", sequence, "--shards",
                 shards, "--seed", str(args.seed)], capture_output=True,
                env={**os.environ, **SEQUENCES[sequence]}, text=True,
                stdin=subprocess.DEVNULL, timeout=900)
            if proc.returncode != 0:
                failed += 1
                print(f"{sequence} failed ({proc.returncode}):\n"
                      f"{proc.stderr[-3000:]}", file=sys.stderr)
                continue
            row = {"sequence": sequence, "card": card, "stages": json.loads(
                proc.stdout.strip().splitlines()[-1])}
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
