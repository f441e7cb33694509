"""ADMM Z/U step and penalty of the PyTorch port against the JAX package's.

The JAX side runs with method='pallas' and DCTA_PALLAS_INTERPRET=1, the
JAX package's own switch that runs its Pallas kernel in interpret mode
on the CPU; the port runs method='kernel', whose wrapper takes the plain
version for CPU tensors. Same ResNet32 weights and duals on both sides.
"""

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
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import state_dict_to_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# same float32 iteration on both sides, summed in different orders
REL_TOL = 1e-5


def _hwio(t):
    return t.detach().permute(2, 3, 1, 0).numpy()


@pytest.fixture(scope="module")
def setup():
    tm = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    v = state_dict_to_jax(tm.state_dict())  # the same weights in JAX layout
    jprog = jeng.build_program(v["params"], jax_plan("resnet32", "tk", "3"))
    rng = np.random.RandomState(0)
    ju = {n: (0.01 * rng.standard_normal(
        jeng._get(v["params"], p).shape)).astype(np.float32)
        for n, p in jprog.paths.items()}
    jz = {n: np.asarray(jeng._get(v["params"], p)) for n, p in jprog.paths.items()}
    jstate = jeng.AdmmState(u={n: jnp.asarray(a) for n, a in ju.items()},
                            z={n: jnp.asarray(a) for n, a in jz.items()})
    params = dict(tm.named_parameters())
    tprog = teng.build_program(params, get_rank_plan("resnet32", "tk", "3"))
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))  # noqa: E731
    tstate = teng.AdmmState(u={n: to_t(a) for n, a in ju.items()},
                            z={n: to_t(a) for n, a in jz.items()})
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCTA_PALLAS_INTERPRET", "1")
        for update_u in (False, True):
            js, jr = jeng.admm_update(v["params"], jstate, jprog,
                                      update_u=update_u, method="pallas",
                                      n_iter=6)
            ts, tr = teng.admm_update(params, tstate, tprog, update_u=update_u,
                                      method="kernel", n_iter=6)
            results[update_u] = (js, jr, ts, tr)
    return dict(v=v, jprog=jprog, jstate=jstate, params=params, tprog=tprog,
                tstate=tstate, results=results)


def test_program_buckets_match_jax(setup):
    jg = [(g.names, g.spec) for g in setup["jprog"].groups]
    tg = [(g.names, g.spec.out_rank, g.spec.in_rank) for g in setup["tprog"].groups]
    assert [(n, s.out_rank, s.in_rank) for n, s in jg] == tg
    assert len(tg) == 5 and sum(len(n) for n, _, _ in tg) == 30


@pytest.mark.parametrize("update_u", [False, True])
def test_admm_update_matches_jax(setup, update_u):
    js, jr, ts, tr = setup["results"][update_u]
    assert set(tr) == set(jr)
    for n in jr:
        z_j, z_t = np.asarray(js.z[n]), _hwio(ts.z[n])
        assert np.linalg.norm(z_t - z_j) <= REL_TOL * np.linalg.norm(z_j), n
        u_j, u_t = np.asarray(js.u[n]), _hwio(ts.u[n])
        assert np.linalg.norm(u_t - u_j) <= REL_TOL * max(np.linalg.norm(u_j), 1.0), n
        np.testing.assert_allclose(float(tr[n]), float(jr[n]), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    if not update_u:  # U is left as it was
        for n in jr:
            assert torch.equal(ts.u[n], setup["tstate"].u[n])
    # full-rank layer1 projects exactly: Z = W + U
    n = "layer1.0.conv1.weight"
    w_u = setup["params"][n].detach() + setup["tstate"].u[n]
    torch.testing.assert_close(ts.z[n], w_u, rtol=1e-5, atol=1e-6)


def test_kernel_route_counts_no_launch_on_cpu(setup):
    from dnn_compression_tensor_admm_tpu_torch.ops.cuda.tucker_kernel import (
        tucker2_factors_batched)
    assert tucker2_factors_batched.launches == 0


def test_non_finite_projection_keeps_previous_z():
    z = torch.tensor([[1.0, float("nan")], [2.0, 3.0]])
    prev = torch.tensor([[5.0, 6.0], [7.0, 8.0]])
    out = teng._finite_or_prev(z, prev)
    assert torch.equal(out, torch.tensor([[5.0, 6.0], [2.0, 3.0]]))


def test_penalty_and_gradient_match_jax(setup):
    js = setup["results"][True][0]
    ts = setup["results"][True][2]
    rho = 1e-3
    jp, jg = jax.value_and_grad(
        lambda p: jeng.admm_penalty(p, js, setup["jprog"], rho))(setup["v"]["params"])
    params = setup["params"]
    for p in params.values():
        p.grad = None
    tp = teng.admm_penalty(params, ts, setup["tprog"], rho)
    tp.backward()
    np.testing.assert_allclose(tp.item(), float(jp), rtol=1e-5)
    for n, path in setup["jprog"].paths.items():
        g_j = np.asarray(jeng._get(jg, path))
        np.testing.assert_allclose(_hwio(params[n].grad), g_j, rtol=1e-4,
                                   atol=1e-9, err_msg=n)
    assert params["linear.weight"].grad is None  # not a plan layer


def test_adjust_rho_matches_jax():
    for e in (0, 84, 85, 86, 99):
        assert teng.adjust_rho(e, 100, 1e-3) == jeng.adjust_rho(e, 100, 1e-3)


def test_unknown_method_raises(setup):
    with pytest.raises(ValueError):
        teng.admm_update(setup["params"], setup["tstate"], setup["tprog"],
                         method="pallas")
