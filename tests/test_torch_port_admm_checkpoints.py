"""Decompose in the PyTorch port against the JAX package on the committed
ADMM-trained dense ResNet32 checkpoints (`results/flagship_r03`: 24
epochs of ADMM at TK@3x and TT@3x on `synthetic-cifar10`), whose plan
layers ADMM put near their rank manifold. Each package reads the file with
its own reader and decomposes it by its own exact-SVD route (TK: HOSVD +
10 HOOI sweeps; TT: TT-SVD); the reconstructed kernels of the first
layer of every bucket and both packages' compressed forward on the
port's factors are compared, in float32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.models import decompose_params as jax_decompose
from dnn_compression_tensor_admm_tpu.utils.checkpoint import load_variables as jax_load
from dnn_compression_tensor_admm_tpu_torch.admm import build_program
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.data.datasets import load_dataset
from dnn_compression_tensor_admm_tpu_torch.data.device_pipeline import normalize
from dnn_compression_tensor_admm_tpu_torch.models import create_model, decompose_params
from dnn_compression_tensor_admm_tpu_torch.ops.contractions import merge_tt_matrix
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import load_any_variables
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {  # format -> (file, compressed model)
    "tk": ("results/flagship_r03/resnet32_synthetic-cifar10_admm_tk_0821-014312"
           "_model.msgpack", "tkc_resnet32"),
    "tt": ("results/flagship_r03/resnet32_synthetic-cifar10_admm_tt_0821-021710"
           "_model.msgpack", "ttm_resnet32"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kernel(sd, prefix, fmt):
    """A factorized layer's OIHW kernel, rebuilt from its factors."""
    if fmt == "tk":
        return torch.einsum("oa,abhw,bi->oihw", sd[prefix + "last_factor"],
                            sd[prefix + "core_kernel"],
                            sd[prefix + "first_factor"])

    def chain(side):
        cores = []
        while f"{prefix}{side}_core_{len(cores)}" in sd:
            cores.append(sd[f"{prefix}{side}_core_{len(cores)}"])
        return cores

    w = torch.einsum("oa,abhw->obhw", merge_tt_matrix(chain("out")),
                     sd[prefix + "core_kernel"])
    ins = chain("in")
    return torch.einsum("obhw,bi->oihw", w, merge_tt_matrix(ins)) if ins else w


def _rel(a, b):
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.mark.parametrize("fmt", ["tk", "tt"])
def test_decompose_of_an_admm_trained_checkpoint_matches_jax(fmt):
    path, name = CHECKPOINTS[fmt]
    path = os.path.join(ROOT, path)
    dense_sd = load_any_variables(path)  # the port's own reader
    jv = jax_load(path)
    plan, jplan = get_rank_plan("resnet32", fmt, "3"), jax_plan("resnet32", fmt, "3")
    tsd = decompose_params(dense_sd, plan)
    # the JAX package decomposes the first layer of every bucket (its
    # decompose of all 30 TK layers costs minutes beside the other test
    # workers); the port decomposes all of them
    firsts = [g.names[0] for g in build_program(dense_sd, plan).groups]
    jsd = jax_to_state_dict(jax_decompose(
        jv, JaxRankPlan(fmt, {n: jplan.spec(n) for n in firsts})))
    fits = []
    for layer in plan.names():
        prefix = layer[:-len("weight")]
        w_t = _kernel(tsd, prefix, fmt)
        fits.append(_rel(w_t, dense_sd[layer]))
        if layer in firsts:
            # near the rank manifold the spectra have their gap at the
            # cut, so both exact-SVD routes find the same subspaces (1.8e-6
            # apart at most seen, float32 rounding)
            assert _rel(w_t, _kernel(jsd, prefix, fmt)) < 2e-5, layer
    # what ADMM bought: every plan layer within 2.7% of its rank-r fit
    # (the full-rank ones exactly)
    assert max(fits) < 0.05

    # both packages' compressed forward on the port's factors
    x, _, info = load_dataset("synthetic-cifar10", False, 16)
    xt = normalize(torch.from_numpy(x), info.mean, info.std)
    model = create_model(name, ratio="3")
    model.load_state_dict(tsd)
    with torch.no_grad():
        logits_t = model.eval()(xt).numpy()
    jm = jax_model(name, num_classes=10, ratio="3")
    logits_j = np.asarray(jax.jit(jm.apply)(
        state_dict_to_jax(tsd), jnp.asarray(xt.permute(0, 2, 3, 1).numpy())))
    assert np.isfinite(logits_t).all()
    # through 31 layers in two frameworks (2.3e-7 of the largest seen)
    scale = np.abs(logits_j).max()
    assert np.abs(logits_t - logits_j).max() <= 1e-5 * scale
    assert (logits_t.argmax(-1) == logits_j.argmax(-1)).all()
