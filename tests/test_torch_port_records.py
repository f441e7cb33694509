"""The port's shard input path and reports against the JAX package's:
`data/records.py` (the DCTA bytes), `data/native_loader.py` (its own
build of `native/dataloader.cc` against the JAX binding of the committed
library, batch for batch), `utils/flops.py` (`--flops`), and one CPU run
of the CLI from 32 x 32 shards with every flag of the ViT recipe."""

import functools
import itertools
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from dnn_compression_tensor_admm_tpu.data import native_loader as jloader
from dnn_compression_tensor_admm_tpu.data import records as jrecords
from dnn_compression_tensor_admm_tpu_torch.data import native_loader as nl
from dnn_compression_tensor_admm_tpu_torch.data import records

ROOT = Path(__file__).resolve().parents[1]


def _set(n=37, h=5, w=6, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, h, w, c)).astype(np.uint8),
            rng.randint(-3, 1000, n).astype(np.int32))


def test_write_shards_bytes_equal_the_jax_writer(tmp_path):
    images, labels = _set()
    jpaths = jrecords.write_shards(images, labels, str(tmp_path / "j"),
                                   samples_per_shard=10, prefix="train")
    paths = records.write_shards(images, labels, str(tmp_path / "t"),
                                 samples_per_shard=10, prefix="train")
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths]
    assert len(paths) == 4
    for p, jp in zip(paths, jpaths):
        assert Path(p).read_bytes() == Path(jp).read_bytes()
        assert records.shard_sample_count(p) == jrecords.shard_sample_count(jp)
        x, y = records.read_shard(p)
        jx, jy = jrecords.read_shard(jp)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == np.uint8 and y.dtype == np.int32
    with pytest.raises(ValueError):
        records.write_shards(images.astype(np.float32), labels, str(tmp_path))


def test_native_loader_matches_the_jax_binding(tmp_path):
    images, labels = _set(n=53)
    paths = records.write_shards(images, labels, str(tmp_path), 20, "train")
    # the JAX binding loads the committed native/libdcta_loader.so
    assert Path(jloader._SO_PATH).exists()
    committed = Path(jloader._SO_PATH).read_bytes()
    # one worker: the same batches in the same order, past the epoch's end
    # (looping, the loader keeps each pass's short last batch: 53 = 6 x 8 + 5)
    ours = nl.NativeLoader(paths, 8, workers=1, seed=3, drop_last=True,
                           loop=True)
    theirs = jloader.NativeLoader(paths, 8, workers=1, seed=3,
                                  drop_last=True, loop=True)
    assert ours.shape == theirs.shape == (5, 6, 3)
    assert ours.total == theirs.total == 53
    mine, jaxs = iter(ours), iter(theirs)
    for _ in range(9):
        (x, y, n), (jx, jy, jn) = next(mine), next(jaxs)
        assert n == jn == (5 if _ == 6 else 8)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    ours.close()
    theirs.close()
    # four workers race for the queue: one epoch holds the same batches
    batches = []
    for loader in (nl.NativeLoader(paths, 8, workers=4, seed=3),
                   jloader.NativeLoader(paths, 8, workers=4, seed=3)):
        got = sorted((y[:n].tobytes(), x[:n].tobytes())
                     for x, y, n in loader)
        loader.close()
        batches.append(got)
    assert batches[0] == batches[1] and len(batches[0]) == 7
    # the rows are the shards' rows, each once an epoch
    rows = sorted(lab for ys, _ in batches[0]
                  for lab in np.frombuffer(ys, np.int32))
    assert rows == sorted(labels.tolist())
    assert Path(jloader._SO_PATH).read_bytes() == committed


def test_device_prefetcher_yields_the_loaders_full_batches(tmp_path):
    """The prefetcher's thread fills its ring from the loader in the
    loader's order: on the CPU it yields a copy of each full batch (the
    looped pass's short last batch skipped), labels as int64; an error on
    the thread (the loader runs out) reaches the caller."""
    import torch
    from dnn_compression_tensor_admm_tpu_torch.data.device_pipeline import (
        DevicePrefetcher)
    images, labels = _set(n=53)
    paths = records.write_shards(images, labels, str(tmp_path), 20, "train")
    want = [(x.copy(), y.copy()) for x, y, n in itertools.islice(
        nl.NativeLoader(paths, 8, workers=1, seed=3, drop_last=True,
                        loop=True), 12) if n == 8]
    loader = nl.NativeLoader(paths, 8, workers=1, seed=3, drop_last=True,
                             loop=True)
    stream = DevicePrefetcher(loader, torch.device("cpu"))
    for x, y in want:
        xb, yb = next(stream)
        assert yb.dtype == torch.int64
        np.testing.assert_array_equal(xb.numpy(), x)
        np.testing.assert_array_equal(yb.numpy(), y)
    assert stream.batches >= len(want) + 1  # the short batch was read
    stream.close()
    assert not stream.thread.is_alive()
    loader.close()
    once = nl.NativeLoader(paths, 8, workers=1, seed=3, drop_last=True)
    stream = DevicePrefetcher(once, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="ran out of batches"):
        for _ in range(7):
            next(stream)
    stream.close()
    once.close()


def test_loader_builds_into_the_gitignored_directory(tmp_path, monkeypatch):
    so = nl.build()
    assert so == nl.library_path() and so.exists()
    assert so.parent == ROOT / "build" / "native_loader"
    assert so != Path(jloader._SO_PATH)
    if shutil.which("git") and (ROOT / ".git").exists():
        ignored = subprocess.run(["git", "check-ignore", "-q", str(so)],
                                 cwd=ROOT, stdin=subprocess.DEVNULL)
        assert ignored.returncode == 0, f"{so} is not gitignored"
    # a source that does not compile raises, with the compiler's words
    bad = tmp_path / "dataloader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "SOURCE", bad)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the shard loader"):
        nl.build()


@functools.cache
def _jax_flops(name: str) -> dict:
    """The JAX package's report of `name` at CIFAR geometry, batch 1."""
    import jax
    import jax.numpy as jnp

    from dnn_compression_tensor_admm_tpu.models import create_model
    from dnn_compression_tensor_admm_tpu.utils.flops import model_flops_params

    x = jnp.zeros((1, 32, 32, 3))
    m = create_model(name, num_classes=10,
                     **({"ratio": "3"} if name != "resnet32" else {}))
    v = m.init(jax.random.PRNGKey(0), x, train=False)
    return model_flops_params(m, v, x.shape)


@pytest.mark.parametrize("model", ["tkc_resnet32", "ttm_resnet32"])
def test_flops_report_matches_the_jax_package(model, capsys):
    from dnn_compression_tensor_admm_tpu_torch.cli.main import main

    rep = main(["--model", model, "--ratio", "3", "--flops", "--device",
                "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    theirs, dense = _jax_flops(model), _jax_flops("resnet32")
    assert rep["params"] == theirs["params"]
    assert rep["dense_params"] == dense["params"]
    assert rep["param_ratio"] == dense["params"] / theirs["params"]
    # The two counters differ: torch's counts only the products (2 a
    # multiply-add) and counts a 3x3 conv's products at its zero-padded
    # border too; XLA's cost analysis counts the elementwise ops (BN, ReLU,
    # adds) beside the products, and not the border's. Measured: dense
    # ResNet32 137.7 M against 129.0 M (+6.8%), the flop ratio 1.452
    # against 1.370 (tkc) and 1.519 against 1.428 (ttm): within 8%
    assert abs(rep["dense_flops"] / dense["flops"] - 1) < 0.08
    jax_ratio = dense["flops"] / theirs["flops"]
    assert abs(rep["flop_ratio"] / jax_ratio - 1) < 0.08, (rep, jax_ratio)


def test_cli_streams_shards_with_the_vit_recipe_flags(tmp_path, capsys):
    """Every flag of the recipe on a small CIFAR model, 2 steps each: the
    streamed route (mixup, cutmix, RandAugment, erasing, 2 loader threads,
    a profile), the shards read whole (`--shard-cache hbm`, repeated
    augmentation over a shuffled copy), and `--flops`."""
    import torch

    from dnn_compression_tensor_admm_tpu_torch.cli.main import main
    from dnn_compression_tensor_admm_tpu_torch.data.datasets import (
        load_dataset)
    from dnn_compression_tensor_admm_tpu_torch.utils.profiling import (
        trace_summary)

    shards = tmp_path / "shards"
    x, y, _ = load_dataset("synthetic-cifar10", True, 48)
    records.write_shards(x, y, str(shards), 24, "train")
    x, y, _ = load_dataset("synthetic-cifar10", False, 16)
    records.write_shards(x, y, str(shards), 16, "val")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    common = ["--device", "cpu", "--model", "resnet20", "--dataset",
              "synthetic-cifar10", "--batch-size", "8", "--epochs", "1",
              "--steps-per-epoch", "2", "--fp32", "--shard-dir", str(shards),
              "--mixup", "0.8", "--cutmix", "1.0", "--smoothing", "0.1",
              "--aa", "rand-m9-mstd0.5", "--reprob", "0.25"]
    try:
        _, streamed = main([*common, "--admm", "--format", "tt", "--ratio",
                            "3", "--loader-workers", "2", "--profile-dir",
                            str(tmp_path / "prof")])
        _, cached = main([*common, "--shard-cache", "hbm", "--repeated-aug",
                          "3", "--sampling", "shuffle"])
    finally:
        torch.set_num_threads(threads)
    for rows in (streamed, cached):
        assert np.isfinite(rows[-1]["train_loss"])
        assert np.isfinite(rows[-1]["test_loss"])  # on the val shards
    assert streamed[0]["loader_host_ms_per_batch"] > 0
    assert "loader_host_ms_per_batch" not in cached[0]
    summary = trace_summary(streamed[0]["profile_trace"])
    assert summary["span_ms"] > 0 and summary["device_events"] == 0
    rep = main(["--model", "ttm_resnet20", "--ratio", "3", "--flops",
                "--device", "cpu"])
    assert rep["flop_ratio"] > 1 and rep["params"] < rep["dense_params"]
    out = capsys.readouterr().out
    assert '"phase_timings"' in out
