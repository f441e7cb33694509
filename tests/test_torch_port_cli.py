"""The PyTorch port's command line end to end on the CPU (--admm ->
--decompose -> --eval / --runtime), and the two properties the card's
machine relies on: the port and chip_smoke.py import without JAX, and
chip_smoke.py fails, printing nothing, without CUDA."""

import json
import subprocess
import sys
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]


def test_cli_admm_decompose_eval_on_cpu(tmp_path, capsys):
    common = ["--device", "cpu", "--dataset", "synthetic-cifar10",
              "--synthetic-size", "128", "--batch-size", "32", "--ratio", "3",
              "--fp32"]
    cli_main(["--model", "resnet32", "--admm", "--epochs", "2",
              "--steps-per-epoch", "2", "--smoothing", "0.1", "--save-model",
              "--save-log", "--output-dir", str(tmp_path / "admm"), *common])
    (dense,) = (tmp_path / "admm").glob("*_model.msgpack")
    (log,) = (tmp_path / "admm").glob("*.log")
    rows = [json.loads(r) for r in log.read_text().splitlines()]
    assert len(rows) == 2 and all(np.isfinite(r["train_loss"]) for r in rows)
    assert len(rows[-1]["admm_residuals"]) == 30
    cli_main(["--model", "tkc_resnet32", "--decompose", "--model-path",
              str(dense), "--epochs", "1", "--steps-per-epoch", "2",
              "--save-model", "--output-dir", str(tmp_path / "ft"), *common])
    assert "compression 2.83x" in capsys.readouterr().out
    (ft,) = (tmp_path / "ft").glob("*_model.msgpack")
    r = cli_main(["--model", "tkc_resnet32", "--eval", "--model-path", str(ft),
                  *common])
    assert set(r) == {"acc1", "acc5", "loss"} and np.isfinite(r["loss"])
    rt = cli_main(["--model", "tkc_resnet32", "--runtime", "--model-path",
                   str(ft), *common])
    assert rt["ms_per_image"] > 0
    with pytest.raises(SystemExit):
        cli_main(["--model", "tkc_resnet32", "--admm", *common])


def test_cli_tt_admm_decompose_eval_on_cpu(tmp_path, capsys):
    common = ["--device", "cpu", "--dataset", "synthetic-cifar10",
              "--synthetic-size", "128", "--batch-size", "32", "--ratio", "3",
              "--fp32"]
    cli_main(["--model", "resnet32", "--admm", "--format", "tt", "--epochs",
              "1", "--steps-per-epoch", "2", "--save-model", "--save-log",
              "--output-dir", str(tmp_path / "admm"), *common])
    (dense,) = (tmp_path / "admm").glob("*_admm_tt_*_model.msgpack")
    (log,) = (tmp_path / "admm").glob("*.log")
    (row,) = [json.loads(r) for r in log.read_text().splitlines()]
    assert np.isfinite(row["train_loss"]) and len(row["admm_residuals"]) == 30
    # layer1 is full rank in TT (ranks [1, 16, 16, 1]): Z = W, residual ~0
    assert row["admm_residuals"]["layer1.0.conv1.weight"] < 1e-4
    assert row["admm_residuals"]["layer3.4.conv2.weight"] > 1e-2
    cli_main(["--model", "ttm_resnet32", "--decompose", "--model-path",
              str(dense), "--epochs", "1", "--steps-per-epoch", "1",
              "--save-model", "--output-dir", str(tmp_path / "ft"), *common])
    assert "compression 2.78x" in capsys.readouterr().out
    (ft,) = (tmp_path / "ft").glob("*_model.msgpack")
    r = cli_main(["--model", "ttm_resnet32", "--eval", "--model-path", str(ft),
                  *common])
    assert set(r) == {"acc1", "acc5", "loss"} and np.isfinite(r["loss"])


_NO_JAX = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'optax',\n"
           "          'dnn_compression_tensor_admm_tpu'):\n"
           "    sys.modules[m] = None\n")


def test_port_and_chip_smoke_import_without_jax():
    """The card's machine has no JAX: the port and chip_smoke.py must not
    need it, nor anything of the JAX package."""
    pkg = ROOT / "dnn_compression_tensor_admm_tpu_torch"
    mods = sorted(".".join((p.parent if p.name == "__init__.py" else
                            p.with_suffix("")).relative_to(ROOT).parts)
                  for p in pkg.rglob("*.py") if p.name != "__main__.py")
    assert len(mods) > 30
    # the ViT recipe's modules and the shard route among them, and
    # chip_smoke.py's tenth path able to run its pieces without JAX
    pkg_name = "dnn_compression_tensor_admm_tpu_torch"
    assert {f"{pkg_name}.{m}" for m in (
        "data.augment", "data.records", "data.native_loader",
        "utils.flops", "utils.profiling")} <= set(mods)
    code = (_NO_JAX + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            + "assert chip_smoke.DEIT_R['ratio'] == 1.88\n"
            + f"from {pkg_name}.data.augment import parse_randaugment\n"
            + "assert parse_randaugment('rand-m9-mstd0.5') == (9.0, 0.5)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   stdin=subprocess.DEVNULL, timeout=120)


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this checks the path taken without a card")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
