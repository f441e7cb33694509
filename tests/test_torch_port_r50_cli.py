"""The port's command line on ImageNet ResNet-50 TT@3x end to end on the
CPU, as `results/run_r50tt.sh` runs the JAX package's: ADMM of the dense
`resnet50` with the TT@3x (general) plan, a linear warmup and gradients
clipped by global norm, then `ttm_resnet50 --decompose` of its
checkpoint and `--eval` of the fine-tuned one; the synthetic hard
ImageNet set at full geometry (224 x 224, 1000 classes), held in memory,
at batch 2 and 2 steps.
"""

import json

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers, and oversubscribed OpenMP threads ran these tests 15x
    slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_r50_tt_admm_decompose_eval_on_cpu(tmp_path, capsys):
    common = ["--device", "cpu", "--dataset", "synthetic-hard-imagenet",
              "--synthetic-size", "8", "--batch-size", "2", "--ratio", "3",
              "--tt-type", "general", "--smoothing", "0.1", "--fp32"]
    cli_main(["--model", "resnet50", "--admm", "--format", "tt",
              "--epochs", "2", "--steps-per-epoch", "1", "--lr", "0.1",
              "--warmup-epochs", "1", "--clip-grad", "1.0", "--save-model",
              "--save-log", "--output-dir", str(tmp_path / "admm"), *common])
    (dense,) = (tmp_path / "admm").glob("resnet50_*_admm_tt_*_model.msgpack")
    (log,) = (tmp_path / "admm").glob("*.log")
    rows = [json.loads(r) for r in log.read_text().splitlines()]
    assert len(rows) == 2
    for row in rows:
        assert np.isfinite(row["train_loss"]) and len(row["admm_residuals"]) == 34
    cli_main(["--model", "ttm_resnet50", "--decompose", "--model-path",
              str(dense), "--epochs", "1", "--steps-per-epoch", "1",
              "--lr", "0.01", "--save-model", "--output-dir",
              str(tmp_path / "ft"), *common])
    assert "compression 2.51x" in capsys.readouterr().out
    (ft,) = (tmp_path / "ft").glob("ttm_resnet50_*_model.msgpack")
    r = cli_main(["--model", "ttm_resnet50", "--eval", "--model-path",
                  str(ft), *common])
    assert set(r) == {"acc1", "acc5", "loss"} and np.isfinite(r["loss"])
