"""Tucker-2 factor kernel of the PyTorch port against the Pallas kernel.

The port's plain version (what its wrapper runs for a CPU tensor) is
held against the JAX package's `tucker2_factors_batched` in Pallas
interpret mode, on the same numpy inputs. The CUDA kernel itself is held
against the plain version on the card by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.ops.pallas import (
    tucker2_factors_batched as jax_factors, tucker2_project_batched as jax_project)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# Both sides run the same float32 iteration; they differ in summation
# order only (about 1e-6 relative seen), amplified a little by ~1000
# dependent products.
REL_TOL = 1e-5

# the five buckets of the main path (ResNet32 TK@3x): [L, K, O, I], r0, r1
MAIN_PATH_BUCKETS = [((10, 9, 16, 16), 16, 16), ((1, 9, 32, 16), 24, 16),
                     ((9, 9, 32, 32), 20, 20), ((1, 9, 64, 32), 32, 25),
                     ((9, 9, 64, 64), 25, 23)]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("L,K,O,I,r0,r1", [
    (3, 9, 16, 8, 5, 3),     # rectangular conv bucket, both modes truncated
    (2, 1, 24, 16, 6, 6),    # linear bucket (K=1)
    (2, 9, 8, 8, 8, 3),      # full-rank mode 0
    (2, 9, 8, 8, 8, 8),      # both modes full rank: identity factors
])
def test_plain_matches_pallas_interpret(L, K, O, I, r0, r1):
    x = np.random.RandomState(L * 100 + O).standard_normal(
        (L, K, O, I)).astype(np.float32)
    u0_j, u1_j = jax_factors(jnp.asarray(x), r0, r1, interpret=True)
    u0_t, u1_t = tk.tucker2_factors_batched(torch.from_numpy(x), r0, r1)
    assert u0_t.shape == (L, O, min(r0, O)) and u1_t.shape == (L, I, min(r1, I))
    assert _rel(u0_t.numpy(), u0_j) < REL_TOL
    assert _rel(u1_t.numpy(), u1_j) < REL_TOL
    z_j = jax_project(jnp.asarray(x), r0, r1, interpret=True)
    z_t = tk.tucker2_project_batched(torch.from_numpy(x), r0, r1)
    assert _rel(z_t.numpy(), z_j) < REL_TOL


def test_plain_exact_on_low_rank_input():
    rng = np.random.RandomState(2)
    u = rng.standard_normal((2, 16, 4))
    v = rng.standard_normal((2, 4, 12))
    core = rng.standard_normal((2, 9, 4, 4))
    x = np.einsum("lor,lkrs,lsi->lkoi", u, core, v).astype(np.float32)
    z = tk.tucker2_project_batched(torch.from_numpy(x), 4, 4).numpy()
    assert _rel(z, x) < 1e-3


def test_shared_memory_gate_on_main_path_buckets():
    # floats: n^2 + O r0 + I r1 + n r + max(O r1, r0 I) + 5 r^2, n = max(O, I),
    # r = max(r0, r1); the compiled library reports the same plan on the card
    expected = [10240, 24832, 22336, 62848, 53972]
    got = [tk.smem_bytes(s[2], s[3], r0, r1) for s, r0, r1 in MAIN_PATH_BUCKETS]
    assert got == expected
    assert all(tk.kernel_supported(s, r0, r1) for s, r0, r1 in MAIN_PATH_BUCKETS)
    # two of them need more than the 48 KB default: the launcher opts in
    assert sum(b > 48 * 1024 for b in got) == 2
    assert not tk.kernel_supported((4, 9, 256, 256), 64, 64)  # Gram alone 256 KiB
    assert not tk.kernel_supported((4, 64, 64), 8, 8)         # not [L, K, O, I]


def test_main_path_work_and_bound():
    flops = sum(tk.factor_flops(s, r0, r1) for s, r0, r1 in MAIN_PATH_BUCKETS)
    assert tk.factor_flops(*MAIN_PATH_BUCKETS[0]) == 0  # full rank: no work
    # about 0.84 GFLOP per Z-step: ~13 us at 67 TFLOP/s float32
    assert 0.8e9 < flops < 0.9e9


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 9, 8, 8, dtype=torch.float64), TypeError),
    (torch.zeros(2, 9, 8, 8).transpose(2, 3), ValueError),
    (torch.zeros(9, 8, 8), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        tk.tucker2_factors_batched(bad, 4, 4)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = tk.tucker2_factors_batched.launches
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 9, 8, 8)).astype(np.float32))
    u0, u1 = tk.tucker2_factors_batched(x, 3, 3)
    p0, p1 = tk.tucker2_factors_plain(x, 3, 3)
    assert torch.equal(u0, p0) and torch.equal(u1, p1)
    assert tk.tucker2_factors_batched.launches == before
