"""Decomposition ops of the PyTorch port against the JAX package's.

Factors are unique only up to rotation (and SVD signs), so the tests
compare reconstructions and projectors, which are not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.ops import svd as jsvd
from dnn_compression_tensor_admm_tpu.ops import tucker as jtucker
from dnn_compression_tensor_admm_tpu_torch.ops import svd as tsvd
from dnn_compression_tensor_admm_tpu_torch.ops import tucker as ttucker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# float32 on both sides; exact SVDs from different LAPACK paths agree to
# ~1e-6 relative, the iterative 'subspace' route a little less closely.
REL_TOL = {"svd": 1e-4, "subspace": 1e-4}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _random(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _low_rank(o, i, k, r0, r1, seed):
    rng = np.random.RandomState(seed)
    core = rng.standard_normal((r0, r1, k, k))
    a = rng.standard_normal((o, r0))
    b = rng.standard_normal((i, r1))
    return np.einsum("rskl,or,is->oikl", core, a, b).astype(np.float32)


@pytest.mark.parametrize("method", ["svd", "subspace"])
@pytest.mark.parametrize("shape,ranks", [
    ((16, 8, 3, 3), (5, 3)),
    ((32, 16, 3, 3), (24, 16)),   # mode 1 at full rank
    ((12, 10, 1, 1), (11, 9)),    # 1x1 kernel: the HOOI unfolding narrows
])
def test_tucker2_project_matches_jax(method, shape, ranks):
    x = _random(shape, seed=sum(shape))
    z_j = jtucker.tucker2_project(jnp.asarray(x), *ranks, n_iter=6, method=method)
    z_t = ttucker.tucker2_project(torch.from_numpy(x), *ranks, n_iter=6,
                                  method=method)
    assert z_t.shape == x.shape
    assert _rel(z_t.numpy(), z_j) < REL_TOL[method]


@pytest.mark.parametrize("method", ["svd", "subspace"])
def test_tucker2_project_exact_on_low_rank_input(method):
    x = _low_rank(16, 12, 3, 4, 3, seed=3)
    z_t = ttucker.tucker2_project(torch.from_numpy(x), 4, 3, n_iter=6,
                                  method=method)
    assert _rel(z_t.numpy(), x) < 1e-4


def test_partial_tucker_core_and_factor_shapes_with_rank_overflow():
    # out rank 11 > in_rank * kh * kw = 9: the HOOI factor is zero-padded
    x = _random((12, 9, 1, 1), seed=5)
    core_j, (u0_j, u1_j) = jtucker.partial_tucker(jnp.asarray(x), (11, 9))
    core_t, (u0_t, u1_t) = ttucker.partial_tucker(torch.from_numpy(x), (11, 9))
    assert core_t.shape == core_j.shape == (11, 9, 1, 1)
    assert u0_t.shape == u0_j.shape and u1_t.shape == u1_j.shape
    rec_j = jtucker.tucker_to_tensor(core_j, [u0_j, u1_j])
    rec_t = ttucker.tucker_to_tensor(core_t, [u0_t, u1_t])
    assert _rel(rec_t.numpy(), rec_j) < 1e-4


@pytest.mark.parametrize("method", ["svd", "subspace"])
def test_truncated_left_sv_projector_matches_jax(method):
    a = _random((20, 45), seed=7)
    u_j = np.asarray(jsvd.truncated_left_sv(jnp.asarray(a), 6, method=method))
    u_t = tsvd.truncated_left_sv(torch.from_numpy(a), 6, method=method).numpy()
    assert _rel(u_t @ u_t.T, u_j @ u_j.T) < 1e-4


def test_svd_project_matches_jax():
    a = _random((24, 30), seed=9)
    assert _rel(tsvd.svd_project(torch.from_numpy(a), 5).numpy(),
                jsvd.svd_project(jnp.asarray(a), 5)) < 1e-5


def test_full_f32_turns_tf32_off_inside_and_restores_the_caller_setting():
    from dnn_compression_tensor_admm_tpu_torch.ops.precision import full_f32
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    seen = []

    @full_f32()
    def probe():
        seen.append((matmul.allow_tf32, cudnn.allow_tf32))

    try:
        cudnn.allow_tf32 = True  # torch's default for convolutions
        probe()
        with full_f32():
            probe()
        assert seen == [(False, False), (False, False)]
        assert cudnn.allow_tf32 is True
        assert matmul.allow_tf32 == saved[0]
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
