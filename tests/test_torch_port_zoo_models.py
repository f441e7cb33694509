"""The zoo's new models in the PyTorch port against the JAX package's on the
same weights (the port's seeded init with random BN statistics, moved
across by the port's `utils/jax_weights.py`): logits in float32 in eval
mode, then one train-mode step: the logits and every BatchNorm's running
statistics after it, dense and compressed (on the port's factors).

* ImageNet MobileNetV2 at 2 x 64 x 64, dense and SVD@2x;
* VGG16-BN at one 224 x 224 image (the 7 x 7 `pre_logits.fc1` needs the
  7 x 7 map), dense and TK@2x (fc1 a Tucker-2 conv);
* DenseNet40 at 2 x 32 x 32, dense and TK@2x (reconstruct mode);
* an ImageNet DenseNet at block config (2, 2, 2, 2) and 2 x 64 x 64,
  dense and with DenseNet121's TK@2x plan, its dense layers recomputed in
  the backward pass (`torch.utils.checkpoint`, the JAX package's
  `nn.remat`): after a forward and a backward each running statistic has
  moved once, as in JAX, and the gradients are JAX's.

flax's BatchNorm folds the biased batch variance into its running
variance, torch the unbiased one: the running variances are compared
through torch's n / (n - 1), n the values a channel holds in the batch.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dnn_compression_tensor_admm_tpu.configs.resolver import (
    get_rank_plan as jax_plan)
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.models.densenet import (
    DenseNetInet as JaxDenseNetInet)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.models.densenet import (
    DenseNetInet)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Largest difference over the largest magnitude. Eval: float32 convolutions
# through 16 to 52 layers in two frameworks (1e-6 to 4e-6 seen). Train:
# flax takes the batch variance in one pass, torch in two; through up to
# 52 batch-normalised layers the logits agree within ~1e-4 of their scale
# (ResNet-50: 2.6e-4, test_torch_port_resnet_inet.py).
EVAL_TOL, TRAIN_TOL = 2e-5, 1e-3
# running means within this (absolute, on statistics of O(1)); running
# variances through n/(n-1) within rtol 5e-3 (flax's one-pass variance)
MEAN_TOL, VAR_RTOL = 1e-4, 5e-3
# gradients of the dense ImageNet DenseNet (float32, recomputed on each
# side): every parameter's within this of the largest gradient of any
# (2.9e-5 seen, at the stem's conv; the stem BN's scale has a gradient
# near 0, 7e-6, which float32 cancellation moves by 2e-6)
GRAD_TOL = 1e-4


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _port_weights(model, seed):
    """The port model's seeded init with N(0, 0.1) running means and
    U(0.5, 1.5) running variances (so eval mode reads them)."""
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    for k, t in sd.items():
        if k.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)
                                     .astype(np.float32)))
        elif k.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)
                                     .astype(np.float32)))
    return sd


@contextlib.contextmanager
def _bn_counts(model):
    """BN name -> the values a channel holds in the batch (B x H x W), as
    the forwards inside the block see them."""
    counts, hooks = {}, []

    def hook(name):
        def record(mod, inp, out):
            counts[name] = inp[0].numel() // inp[0].shape[1]
        return record

    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(hook(name)))
    try:
        yield counts
    finally:
        for h in hooks:
            h.remove()


def _check_stats(sd_after, prior, jax_stats, counts):
    """Every BN's running statistics after one train-mode step: the means
    JAX's, the variances JAX's through n / (n - 1)."""
    assert counts
    for name, n in counts.items():
        np.testing.assert_allclose(sd_after[f"{name}.running_mean"],
                                   jax_stats[f"{name}.running_mean"],
                                   rtol=0, atol=MEAN_TOL, err_msg=name)
        p = prior[f"{name}.running_var"].numpy()
        var_t = (sd_after[f"{name}.running_var"].numpy() - 0.9 * p) / 0.1
        var_j = (jax_stats[f"{name}.running_var"].numpy() - 0.9 * p) / 0.1
        np.testing.assert_allclose(var_t * (n - 1) / n, var_j,
                                   rtol=VAR_RTOL, atol=1e-5, err_msg=name)
        # one update a step: a recompute that updated again would count 2
        assert int(sd_after[f"{name}.num_batches_tracked"]) == 1, name


def _compare(tm, jm, x_nhwc, seed=0):
    """Eval logits, then one train-mode forward's logits and running
    statistics of the port model `tm` against the JAX model `jm` on
    `tm`'s weights."""
    sd = _port_weights(tm, seed)
    prior = {k: v.clone() for k, v in sd.items()}
    v = state_dict_to_jax(sd)
    x = jnp.asarray(x_nhwc)
    xt = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
    # one program for both modes: XLA compiles once (op by op, each new
    # shape of a dense block compiles again)
    logits_eval, (logits_j, upd) = jax.jit(lambda v, x: (
        jm.apply(v, x, train=False),
        jm.apply(v, x, train=True, mutable=["batch_stats"])))(v, x)
    tm.eval()
    with torch.no_grad():
        logits_t = tm(xt)
    _close(logits_t.numpy(), logits_eval, EVAL_TOL)

    tm.train()
    with torch.no_grad(), _bn_counts(tm) as counts:
        logits_t = tm(xt)
    _close(logits_t.numpy(), logits_j, TRAIN_TOL)
    stats = jax_to_state_dict({"batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])})
    _check_stats(tm.state_dict(), prior, stats, counts)


def _input(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["mobilenetv2", "svdc_mobilenetv2"])
def test_mobilenetv2_matches_jax(name):
    kw = {"ratio": "2"} if name != "mobilenetv2" else {}
    tm = create_model(name, generator=torch.Generator().manual_seed(0), **kw)
    _compare(tm, jax_model(name, **kw), _input((2, 64, 64, 3)))


@pytest.mark.parametrize("name", ["vgg16_bn", "tkc_vgg16_bn"])
def test_vgg16_bn_matches_jax(name):
    kw = {"ratio": "2"} if name != "vgg16_bn" else {}
    tm = create_model(name, generator=torch.Generator().manual_seed(0), **kw)
    if name == "tkc_vgg16_bn":  # fc1 is a Tucker-2 7 x 7 conv
        assert type(tm.pre_logits.fc1).__name__ == "TKConv2d"
    _compare(tm, jax_model(name, **kw), _input((1, 224, 224, 3)))


@pytest.mark.parametrize("name", ["densenet40", "tkr_densenet40"])
def test_densenet40_matches_jax(name):
    kw = {"ratio": "2"} if name != "densenet40" else {}
    tm = create_model(name, generator=torch.Generator().manual_seed(0), **kw)
    _compare(tm, jax_model(name, **kw), _input((2, 32, 32, 3)))


BLOCKS = (2, 2, 2, 2)


@pytest.mark.parametrize("compressed", [False, True])
def test_densenet_inet_matches_jax(compressed):
    # DenseNet121's plan holds every layer of the first two of each block
    plan = get_rank_plan("densenet121", "tk", "2") if compressed else None
    jplan = jax_plan("densenet121", "tk", "2") if compressed else None
    tm = DenseNetInet(BLOCKS, plan=plan,
                      generator=torch.Generator().manual_seed(0))
    _compare(tm, JaxDenseNetInet(block_config=BLOCKS, plan=jplan),
             _input((2, 64, 64, 3)))


def test_densenet_inet_checkpoint_updates_bn_once_and_matches_jax_grads():
    """A train step through the recomputed dense layers: forward and
    backward move each running statistic once (JAX's `nn.remat` leaves
    `batch_stats` alone on its recompute), and the gradients equal JAX's."""
    tm = DenseNetInet(BLOCKS, generator=torch.Generator().manual_seed(0))
    sd = _port_weights(tm, 0)
    prior = {k: v.clone() for k, v in sd.items()}
    v = state_dict_to_jax(sd)
    x_nhwc = _input((2, 64, 64, 3))
    labels = np.array([3, 7])
    xt = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
    tm.train()
    with _bn_counts(tm) as counts:
        loss = F.cross_entropy(tm(xt), torch.from_numpy(labels))
        loss.backward()
    sd_after = tm.state_dict()

    jm = JaxDenseNetInet(block_config=BLOCKS)  # remat on, as registered
    assert jm.remat

    def loss_fn(params):
        logits, upd = jm.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x_nhwc), train=True,
                               mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), labels]), upd

    (loss_j, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    stats = jax_to_state_dict({"batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])})
    _check_stats(sd_after, prior, stats, counts)
    grads_t = jax_to_state_dict({"params": jax.tree.map(np.asarray, grads)})
    scale = max(np.abs(g.numpy()).max() for g in grads_t.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_t[name].numpy(),
                                   rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)
