"""The port's command line on the DeiT-small TT@2x recipe, end to end on
the CPU at a tiny size (full width, 224 x 224, 1000 classes, batch 2):
`--admm --adjust-rho` over 7 epochs (the least at which the boost fires),
its dense model as the msgpack `--save-model` writes, which the JAX
package reads back, then
`--decompose` from that file with hard distillation from the dense
teacher read from it too."""

import json

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.utils.checkpoint import load_variables as jax_load
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import load_any_variables
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_deit_small_recipe_through_a_msgpack(tmp_path, capsys):
    common = ["--device", "cpu", "--dataset", "synthetic-hard-imagenet",
              "--synthetic-size", "8", "--batch-size", "2", "--ratio", "2",
              "--opt", "adamw", "--smoothing", "0.1", "--fp32",
              "--steps-per-epoch", "1"]
    # the Z-step by exact SVD: the kernel route's plain version is held
    # against the JAX package elsewhere, and costs 3.5x as much here
    dense, _ = cli_main(
        ["--model", "deit_small_patch16_224", "--admm", "--format", "tt",
         "--admm-method", "svd", "--adjust-rho", "--epochs", "7",
         "--eval-every", "7", "--warmup-epochs", "1", "--clip-grad", "1.0",
         "--lr", "5e-4", "--verbose", "--save-model", "--save-log",
         "--output-dir", str(tmp_path / "admm"), *common])
    out = capsys.readouterr().out
    # --verbose: one row of per-layer residuals a Z-step
    assert sum('"admm_residuals"' in line and '"epoch"' not in line
               for line in out.splitlines()) == 7
    (log,) = (tmp_path / "admm").glob("*.log")
    rows = [json.loads(r) for r in log.read_text().splitlines()]
    assert [r["rho"] for r in rows] == [1e-3] * 6 + [5e-3]
    assert [r["epoch"] for r in rows if "test_loss" in r] == [7]
    (ckpt,) = (tmp_path / "admm").glob("*_admm_tt_*_model.msgpack")
    sd = dense.state_dict()
    mine = load_any_variables(str(ckpt))
    back = jax_to_state_dict(jax_load(str(ckpt)))  # the JAX package's reader
    assert sorted(mine) == sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) and torch.equal(mine[k], sd[k])
               for k in sd)

    model, hist = cli_main(
        ["--model", "ttm_deit_small_patch16_224", "--decompose",
         "--model-path", str(ckpt), "--distillation-type", "hard",
         "--teacher-model", "deit_small_patch16_224", "--teacher-path",
         str(ckpt), "--epochs", "1", "--lr", "1e-4", *common])
    assert "compression 1.53x" in capsys.readouterr().out
    assert np.isfinite(hist[-1]["train_loss"])
    assert np.isfinite(hist[-1]["test_loss"])
