"""The Z/U step's finite guard on the port's kernel route (the CUDA
kernels' plain versions on the CPU) against the JAX package's `pallas`
route, run with DCTA_PALLAS_INTERPRET=1 as `test_torch_port_admm.py` runs
it, on the planted ResNet20 TK@2 and TT@2 inputs and by the checks of
`test_torch_port_zstep_guard.py`. The plan is cut to one bucket, the two
planted layers beside a sound one: on the CPU the JAX package takes
~8 s to trace and interpret its kernel for each bucket."""

import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from test_torch_port_zstep_guard import (N_ITER, NAN_U, RANK_ONE,
                                         check_guard, planted_inputs)

LAYERS = (RANK_ONE, "layer2.1.conv2.weight", NAN_U)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fmt", ["tk", "tt"])
def test_kernel_route_guard_keeps_previous_z_as_jax_pallas_does(monkeypatch,
                                                                 fmt):
    inputs = planted_inputs(fmt, LAYERS)
    _, _, _, jparams, jprog, jstate = inputs
    monkeypatch.setenv("DCTA_PALLAS_INTERPRET", "1")
    js, jr = jeng.admm_update(jparams, jstate, jprog, update_u=True,
                              method="pallas", n_iter=N_ITER)
    assert [len(g.names) for g in jprog.groups] == [3]
    check_guard(inputs, js, jr, "kernel")
