"""Checkpoint and resume in the PyTorch port, and the JAX package's CIFAR
recipe chain through its command line, on the CPU at a tiny size:

* a ResNet32 TK@3x ADMM run of 3 epochs x 2 steps equals, bit for bit, a
  run stopped after 2 (`max_epochs`) and resumed from its checkpoint: the
  targets Z, the duals U, the parameters and BatchNorm buffers, the
  optimizer's state, the EMA shadow, the step, the generators and the
  history;
* a checkpoint of another run, a missing one, or one that cannot be read
  raises, and a save that fails leaves the last good checkpoint;
* ResNet56 TK@3x as `chip_smoke.py` runs it on the card: ADMM with a
  checkpoint stopped after epoch 2, `--resume` to epoch 3 with
  `--save-model` (a msgpack the port's reader and the JAX package's read
  to the model's tensors), then `--decompose --model-path` of that file
  into `tkc_resnet56` and a fine-tune with `--ema-decay --sched step
  --opt sgd`.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.utils.checkpoint import load_variables as jax_load
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
from dnn_compression_tensor_admm_tpu_torch.train import TrainConfig, train_model
from dnn_compression_tensor_admm_tpu_torch.train import state as train_state
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import load_variables
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    base = dict(model="resnet32", dataset="synthetic-cifar10",
                synthetic_size=64, batch_size=8, epochs=3, steps_per_epoch=2,
                admm=True, fmt="tk", ratio="3", admm_method="kernel",
                smoothing=0.1, ema_decay=0.9, compute_dtype=None,
                device="cpu", print_fn=lambda *a: None)
    return TrainConfig(**{**base, **kw})


def _raw(ckpt_dir):
    return torch.load(os.path.join(ckpt_dir, train_state.CHECKPOINT_NAME),
                      weights_only=True)


def _assert_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _untimed(history):
    return [{k: v for k, v in row.items() if not k.endswith("_s")}
            for row in history]


@pytest.mark.parametrize("opt,sched", [("momentum", "cosine"),
                                       ("adam", "step")])
def test_resumed_admm_run_equals_the_uninterrupted_run(tmp_path, opt, sched):
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    kw = dict(opt=opt, sched=sched, decay_epochs=1, lr=0.01)
    m_full, h_full = train_model(_cfg(checkpoint_dir=full, **kw))
    _, h1 = train_model(_cfg(checkpoint_dir=part, **kw), max_epochs=2)
    assert [r["epoch"] for r in h1] == [1, 2]
    assert _raw(part)["epoch"] == 1 and _raw(part)["step"] == 4
    m_res, h2 = train_model(_cfg(checkpoint_dir=part, resume=part, **kw))
    assert [r["epoch"] for r in h2] == [3]
    a, b = _raw(full), _raw(part)
    assert a["step"] == 6 and a["admm"]["z"] and a["ema"]
    assert a["optimizer"]["state"]  # momentum buffers or Adam moments
    _assert_equal(a, b)
    _assert_equal(m_full.state_dict(), m_res.state_dict())
    assert _untimed(h_full) == _untimed(h1 + h2)


def test_resume_refuses_what_it_cannot_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cfg = _cfg(epochs=1, steps_per_epoch=1, checkpoint_dir=ckpt)
    train_model(cfg)
    with pytest.raises(ValueError, match="do not match"):  # another model
        train_model(_cfg(model="resnet56", resume=ckpt))
    with pytest.raises(ValueError, match="none in the run"):
        train_model(_cfg(ema_decay=0.0, resume=ckpt, admm=False,
                         checkpoint_dir=None))
    with pytest.raises(FileNotFoundError):
        train_model(_cfg(resume=str(tmp_path / "nowhere")))
    path = os.path.join(ckpt, train_state.CHECKPOINT_NAME)
    good = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(good[:len(good) // 2])  # torn
    with pytest.raises((RuntimeError, pickle.UnpicklingError, EOFError)):
        train_model(_cfg(resume=ckpt))


def test_a_failed_save_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    ckpt = str(tmp_path)
    train_model(_cfg(epochs=1, steps_per_epoch=1, checkpoint_dir=ckpt))
    before = open(os.path.join(ckpt, train_state.CHECKPOINT_NAME), "rb").read()

    def dies_mid_write(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(train_state.torch, "save", dies_mid_write)
    with pytest.raises(OSError, match="disk full"):
        train_model(_cfg(epochs=1, steps_per_epoch=1, checkpoint_dir=ckpt))
    assert os.listdir(ckpt) == [train_state.CHECKPOINT_NAME]
    assert open(os.path.join(ckpt, train_state.CHECKPOINT_NAME),
                "rb").read() == before


def test_cli_resnet56_recipe_chain(tmp_path, capsys):
    """ADMM stopped after epoch 2, `--resume` to 3 and `--save-model`,
    then `--decompose --model-path` of that msgpack and an EMA fine-tune
    on the step schedule with Nesterov SGD."""
    common = ["--device", "cpu", "--dataset", "synthetic-cifar10",
              "--synthetic-size", "16", "--batch-size", "4", "--fp32",
              "--steps-per-epoch", "1", "--smoothing", "0.1"]
    ckpt = str(tmp_path / "ckpt")
    train_model(TrainConfig(model="resnet56", dataset="synthetic-cifar10",
                            synthetic_size=16, batch_size=4, epochs=3,
                            steps_per_epoch=1, smoothing=0.1, admm=True,
                            fmt="tk", ratio="3", admm_method="kernel",
                            compute_dtype=None, device="cpu",
                            checkpoint_dir=ckpt, print_fn=lambda *a: None),
                max_epochs=2)
    dense, hist = cli_main(["--model", "resnet56", "--admm", "--format", "tk",
                            "--ratio", "3", "--epochs", "3", "--resume", ckpt,
                            "--checkpoint-dir", ckpt, "--save-model",
                            "--output-dir", str(tmp_path / "admm"), *common])
    assert [r["epoch"] for r in hist] == [3]
    assert "resumed from" in capsys.readouterr().out
    (path,) = (tmp_path / "admm").glob("resnet56_*_admm_tk_*_model.msgpack")
    sd = {k: v for k, v in dense.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    for reader in (lambda p: jax_to_state_dict(load_variables(p)),
                   lambda p: jax_to_state_dict(jax_load(p))):
        back = reader(str(path))
        assert {k for k in back if not k.endswith("num_batches_tracked")} == set(sd)
        assert all(torch.equal(back[k], v) for k, v in sd.items())

    model, ft = cli_main(["--model", "tkc_resnet56", "--ratio", "3",
                          "--decompose", "--model-path", str(path),
                          "--epochs", "2", "--lr", "0.003", "--ema-decay",
                          "0.999", "--sched", "step", "--decay-epochs", "1",
                          "--opt", "sgd", "--orthogonal", *common])
    assert "compression 3.10x" in capsys.readouterr().out
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["ema_test_loss"])
               for r in ft)
    assert ft[-1]["ema_test_loss"] != ft[-1]["test_loss"]
