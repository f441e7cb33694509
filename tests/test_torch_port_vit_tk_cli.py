"""The PyTorch port's command line on the DeiT-tiny TK@2x path, end to end
on the CPU at a tiny size: --admm (AdamW, Tucker-2 plan) -> --decompose ->
--eval / --runtime, on synthetic ImageNet geometry (224 x 224, 1000
classes)."""

import json

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_deit_tk_admm_decompose_eval_on_cpu(tmp_path, capsys):
    common = ["--device", "cpu", "--dataset", "synthetic-imagenet",
              "--synthetic-size", "8", "--batch-size", "4", "--ratio", "2",
              "--opt", "adamw", "--lr", "5e-4", "--fp32"]
    cli_main(["--model", "deit_tiny_patch16_224", "--admm", "--format", "tk",
              "--epochs", "1", "--steps-per-epoch", "1", "--smoothing", "0.1",
              "--save-model", "--save-log", "--output-dir",
              str(tmp_path / "admm"), *common])
    (dense,) = (tmp_path / "admm").glob("*_admm_tk_*_model.msgpack")
    (log,) = (tmp_path / "admm").glob("*.log")
    (row,) = [json.loads(r) for r in log.read_text().splitlines()]
    assert np.isfinite(row["train_loss"]) and len(row["admm_residuals"]) == 48
    cli_main(["--model", "tkc_deit_tiny_patch16_224", "--decompose",
              "--model-path", str(dense), "--epochs", "1",
              "--steps-per-epoch", "1", "--save-model", "--output-dir",
              str(tmp_path / "ft"), *common])
    assert "compression 1.17x" in capsys.readouterr().out
    (ft,) = (tmp_path / "ft").glob("*_model.msgpack")
    r = cli_main(["--model", "tkc_deit_tiny_patch16_224", "--eval",
                  "--model-path", str(ft), *common])
    assert set(r) == {"acc1", "acc5", "loss"} and np.isfinite(r["loss"])
    rt = cli_main(["--model", "tkc_deit_tiny_patch16_224", "--runtime",
                   "--model-path", str(ft), *common])
    assert rt["ms_per_image"] > 0
