"""The Z/U step's finite guard on every route of the PyTorch port, against
the JAX package's `admm_update`.

ResNet20 TK@2 and TT@2, the same weights in both packages
(`utils/jax_weights.py`), with two planted layers: a NaN in one layer's
dual U, and a finite rank-1 W + U at scale 1e4 in another (an outer
product of four vectors: every Gram the solvers form is singular, and the
Cholesky QR of the 'subspace' method fails on it, as
`jnp.linalg.cholesky` does). For each method one `admm_update` on both
sides (the JAX one jitted): no raise, the layers the JAX guard skipped
keep their previous Z on both sides and the port's `nonfinite` counts
them, the NaN layer's U is U + (W - Z_prev), the rank-1 layer projects to
itself, and the other layers match within the Z-step tolerance. The
kernel route is held the same way in `test_torch_port_zstep_guard_kernel.py`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.ops import svd as svd_ops
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import state_dict_to_jax

# the Z-step tolerance and the residuals' of tests/test_torch_port_admm.py;
# the exact methods by tests/test_torch_port_ops.py's for 'svd' (LAPACK's
# eigh and SVD on each side; near the truncation the spectrum's gaps
# are small: 2e-5 measured on layer3.0.conv2 by 'gram' and 'svd')
REL_TOL, RES_RTOL = 1e-5, 1e-4
EXACT_REL_TOL = 1e-4
# the rank-1 layer's Z against its exact projection, W itself, on each
# side: its residual ||W - Z|| is rounding (~1e-7 ||W||), too small to
# compare across packages, and the kernel routes' Newton-Schulz steps
# leave up to 1.3e-5 of ||W|| there (the others 1e-6)
RANK_ONE_TOL = 1e-4
NAN_U = "layer2.2.conv1.weight"     # a NaN in its U
RANK_ONE = "layer2.1.conv1.weight"  # W = 1e4 a x b x c x d, U = 0
N_ITER = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hwio(t):
    return t.detach().permute(2, 3, 1, 0).numpy()


def _plan(plan, names):
    if names is None:
        return plan
    return dataclasses.replace(plan, layers={n: plan.spec(n) for n in names})


def planted_inputs(fmt: str, names=None):
    """(port params, program, state; JAX params, program, state): ResNet20
    @2 in `fmt` from seed 0, U = 0.01 N(0, 1) and Z = W + 0.05 N(0, 1)
    (numpy seed 1), with the two planted layers; with `names`, the plan's
    specs of those layers alone."""
    model = create_model("resnet20", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        w = model.get_parameter(RANK_ONE)
        vecs = [rng.standard_normal(n).astype(np.float32) for n in w.shape]
        w.copy_(torch.from_numpy(1e4 * np.einsum("o,i,h,w->oihw", *vecs)))
    params = dict(model.named_parameters())
    program = teng.build_program(
        params, _plan(get_rank_plan("resnet20", fmt, "2"), names))
    u, z = {}, {}
    for n in [n for n, _ in model.named_parameters()
              if n in get_rank_plan("resnet20", fmt, "2")]:
        shape = tuple(params[n].shape)
        u[n] = (0.01 * rng.standard_normal(shape)).astype(np.float32)
        z[n] = (params[n].detach().numpy()
                + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    u[RANK_ONE][:] = 0.0
    u[NAN_U][1, 2, 0, 1] = np.nan
    state = teng.AdmmState(
        u={n: torch.from_numpy(u[n]) for n in program.names},
        z={n: torch.from_numpy(z[n]) for n in program.names})
    jparams = state_dict_to_jax(model.state_dict())["params"]
    jprog = jeng.build_program(jparams,
                               _plan(jax_plan("resnet20", fmt, "2"), names))
    jstate = jeng.AdmmState(
        u={n: jnp.asarray(u[n].transpose(2, 3, 1, 0)) for n in jprog.paths},
        z={n: jnp.asarray(z[n].transpose(2, 3, 1, 0)) for n in jprog.paths})
    return params, program, state, jparams, jprog, jstate


@pytest.fixture(scope="module")
def inputs():
    return {fmt: planted_inputs(fmt) for fmt in ("tk", "tt")}


def check_guard(inputs, js, jr, method: str, n_iter: int = N_ITER) -> None:
    """The port's `admm_update` by `method` against the JAX step's result
    (js, jr) on the same planted inputs."""
    params, program, state, _, jprog, jstate = inputs
    ts, tr = teng.admm_update(params, state, program, update_u=True,
                              method=method, n_iter=n_iter)
    tol = EXACT_REL_TOL if method in ("gram", "svd") else REL_TOL
    skipped = [n for n in jprog.paths
               if np.array_equal(np.asarray(js.z[n]),
                                 np.asarray(jstate.z[n]))]
    assert NAN_U in skipped
    if method == "subspace":  # its Cholesky QR fails on the rank-1 layer
        assert RANK_ONE in skipped
    assert int(ts.nonfinite) == len(skipped)
    for n in jprog.paths:
        z_t, z_j = _hwio(ts.z[n]), np.asarray(js.z[n])
        assert np.isfinite(z_t).all(), n
        if n in skipped:
            assert torch.equal(ts.z[n], state.z[n]), n
        elif n == RANK_ONE:
            w = _hwio(params[n])
            for z, res in ((z_t, tr[n]), (z_j, jr[n])):
                assert (np.linalg.norm(z - w)
                        <= RANK_ONE_TOL * np.linalg.norm(w)), n
                assert float(res) <= RANK_ONE_TOL * np.linalg.norm(w), n
        else:
            assert (np.linalg.norm(z_t - z_j)
                    <= tol * np.linalg.norm(z_j)), n
            np.testing.assert_allclose(float(tr[n]), float(jr[n]),
                                       rtol=RES_RTOL, err_msg=n)
    # the NaN layer's U is U + (W - Z_prev), its NaN included
    want = state.u[NAN_U] + (params[NAN_U].detach() - state.z[NAN_U])
    torch.testing.assert_close(ts.u[NAN_U], want, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("method", ["subspace", "gram", "svd", "ns"])
@pytest.mark.parametrize("fmt", ["tk", "tt"])
def test_guard_keeps_previous_z_as_jax_does(inputs, fmt, method):
    _, _, _, jparams, jprog, jstate = inputs[fmt]
    js, jr = jax.jit(functools.partial(
        jeng.admm_update, program=jprog, update_u=True, method=method,
        n_iter=N_ITER))(jparams, jstate)
    check_guard(inputs[fmt], js, jr, method)


def _unguarded_left_sv(a, rank, method):
    """`truncated_left_sv` as it was before the guard: torch.linalg calls
    that raise on a failed factorization (the iterations' 8 steps)."""
    m = a.shape[0]
    if method == "gram":
        return torch.linalg.eigh(a @ a.T)[1][:, m - rank:].flip(1)
    if method == "svd":
        if m < a.shape[1]:
            return torch.linalg.svd(a.T, full_matrices=False)[2][:rank].T
        return torch.linalg.svd(a, full_matrices=False)[0][:, :rank]

    def cholqr(x):
        eye = torch.eye(x.shape[1])
        r1 = torch.linalg.cholesky(x.T @ x + 1e-6 * eye)
        q = torch.linalg.solve_triangular(r1, x.T, upper=False).T
        r2 = torch.linalg.cholesky(q.T @ q + 1e-7 * eye)
        return torch.linalg.solve_triangular(r2, q.T, upper=False).T

    orth = cholqr if method == "subspace" else svd_ops._ns_orth
    g, q = a @ a.T, torch.eye(m, rank)
    for _ in range(8):
        q = orth(g @ q)
    return q


@pytest.mark.parametrize("method", ["svd", "subspace", "gram", "ns"])
@pytest.mark.parametrize("shape", [(24, 60), (60, 24)])
def test_finite_input_keeps_its_bits(method, shape):
    """The guard leaves a finite input's result bit for bit as the
    unguarded calls compute it; `truncated_svd` (which decompose also
    takes) too."""
    a = torch.from_numpy(np.random.RandomState(3).standard_normal(shape)
                         .astype(np.float32))
    got = svd_ops.truncated_left_sv(a, 8, method=method)
    assert torch.equal(got, _unguarded_left_sv(a, 8, method))
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    for g, w in zip(svd_ops.truncated_svd(a, 8), (u[:, :8], s[:8], vt[:8])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("method", ["svd", "subspace", "gram", "ns"])
def test_non_finite_input_gives_nan_not_a_raise(method):
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.standard_normal((24, 60)).astype(np.float32))
    a[3, 5] = float("nan")
    assert torch.isnan(svd_ops.truncated_left_sv(a, 8, method=method)).all()
    a[3, 5] = float("inf")
    assert all(torch.isnan(t).all() for t in svd_ops.truncated_svd(a, 8))
    x, y = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for n in (24, 60))
    rank_one = 1e4 * torch.outer(x, y)
    q = svd_ops.truncated_left_sv(rank_one, 8, method=method)
    if method == "subspace":  # the Cholesky QR fails: NaN, as in JAX
        assert torch.isnan(q).all()
        with pytest.raises(torch.linalg.LinAlgError):
            _unguarded_left_sv(rank_one, 8, method)
    else:
        assert torch.isfinite(q).all()
