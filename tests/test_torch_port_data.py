"""Data path of the PyTorch port against the JAX package's: synthetic
datasets byte for byte, batch slicing, and crop/flip/normalise with the
crop offsets and flip bits the JAX pipeline draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.data import datasets as jds
from dnn_compression_tensor_admm_tpu.data import device_pipeline as jdp
from dnn_compression_tensor_admm_tpu_torch.data import datasets as tds
from dnn_compression_tensor_admm_tpu_torch.data import device_pipeline as tdp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["synthetic-cifar10", "synthetic-hard-cifar10"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_dataset_is_byte_identical(name, train):
    xj, yj, info_j = jds.load_dataset(name, train, synthetic_size=300)
    xt, yt, info_t = tds.load_dataset(name, train, synthetic_size=300)
    assert xt.dtype == np.uint8 and xt.shape == (300, 32, 32, 3)
    assert xt.tobytes() == xj.tobytes() and yt.tobytes() == yj.tobytes()
    assert (info_t.name, info_t.num_classes, info_t.input_size, info_t.mean,
            info_t.std) == (info_j.name, info_j.num_classes, info_j.input_size,
                            info_j.mean, info_j.std)


def test_file_datasets_are_not_ported_yet():
    with pytest.raises(ValueError):
        tds.load_dataset("cifar10", True)


@pytest.mark.parametrize("n,step", [(1000, 0), (1000, 3), (1000, 7), (300, 5)])
def test_batch_at_matches_jax(n, step):
    x = np.arange(n, dtype=np.int32)
    xj, _ = jdp.batch_at(jnp.asarray(x), jnp.asarray(x), step, 128)
    xt = tdp.batch_at(torch.from_numpy(x), step, 128)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


def test_augment_batch_matches_jax_with_its_offsets_and_flips():
    x, _, info = jds.load_dataset("synthetic-cifar10", True, synthetic_size=16)
    key = jax.random.PRNGKey(3)
    out_j = np.asarray(jdp.augment_batch(jnp.asarray(x), key, mean=info.mean,
                                         std=info.std))
    # the crop offsets and flip bits augment_batch draws from `key`
    k_crop, k_flip, _, _ = jax.random.split(key, 4)
    offs = np.array(jax.random.randint(k_crop, (16, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(k_flip, 0.5, (16, 1, 1)))[:, 0, 0]
    assert 0 < flips.sum() < 16 and len(np.unique(offs)) > 1
    out_t = tdp.augment_batch(torch.from_numpy(x), torch.from_numpy(offs),
                              torch.from_numpy(flips), mean=info.mean,
                              std=info.std)
    assert out_t.shape == (16, 3, 32, 32) and out_t.dtype == torch.float32
    # identical uint8 pixels; normalisation in float32 on both sides
    np.testing.assert_allclose(out_t.permute(0, 2, 3, 1).numpy(), out_j,
                               rtol=0, atol=1e-6)


def test_random_crop_flip_ranges():
    offs, flips = tdp.random_crop_flip(4096, torch.Generator().manual_seed(0))
    assert offs.shape == (4096, 2) and int(offs.min()) == 0 and int(offs.max()) == 8
    assert 0.45 < flips.float().mean().item() < 0.55
