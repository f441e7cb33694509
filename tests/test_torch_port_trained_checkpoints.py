"""The PyTorch port on trained weights: the JAX package's two committed
fine-tuned Tensor-Train checkpoints (ResNet-50 TT@3x general and
ResNet-18 TT@2x special, both trained on `synthetic-hard-imagenet` by
`results/run_r50tt.sh` and `results/run_r18tt.sh`) are read with the JAX
package's `load_variables`, carried across with the port's
`jax_to_state_dict`, and both packages' eval-mode logits compared on
images of the same synthetic validation set at 224 x 224, in float32.
The committed DeiT-small TT@2x checkpoint (`results/run_deit_small.sh`)
is read by each package with its own reader: the port's
`utils/checkpoint.py`, without flax.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.utils.checkpoint import load_variables
from dnn_compression_tensor_admm_tpu_torch.data.datasets import load_dataset
from dnn_compression_tensor_admm_tpu_torch.data.device_pipeline import normalize
from dnn_compression_tensor_admm_tpu_torch.models import count_params, create_model
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import (
    load_variables as port_load_variables)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {  # name, ratio, tt_type -> (file, parameters)
    ("ttm_resnet50", "3", "general"): (
        "results/r50tt_r05/ttm_resnet50_synthetic-hard-imagenet_0821-213702"
        "_model.msgpack", 10_187_501),
    ("ttm_resnet18", "2", "special"): (
        "results/r18tt_r04/ttm_resnet18_synthetic-hard-imagenet_0821-115955"
        "_model.msgpack", 4_230_481),
}
# Largest difference over the largest logit: float32 convolutions through
# ~50 layers at 224 x 224 in two frameworks, the TT chains merged in
# another order (5.6e-7 of ~10 seen)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    """Eight images of the synthetic validation set, normalised, NCHW."""
    x, y, info = load_dataset("synthetic-hard-imagenet", False, 8)
    xt = normalize(torch.from_numpy(x), info.mean, info.std)
    return xt, y


@pytest.mark.parametrize("name,ratio,tt_type", list(CHECKPOINTS))
def test_trained_logits_match_jax(images, name, ratio, tt_type):
    path, n_params = CHECKPOINTS[(name, ratio, tt_type)]
    v = load_variables(os.path.join(ROOT, path))
    model = create_model(name, ratio=ratio, tt_type=tt_type)
    model.load_state_dict(jax_to_state_dict(v))  # strict: every name
    assert count_params(model) == n_params
    xt, labels = images
    with torch.no_grad():
        logits_t = model.eval()(xt).numpy()
    jm = jax_model(name, num_classes=1000, ratio=ratio, tt_type=tt_type)
    logits_j = np.asarray(jm.apply(v, jnp.asarray(
        xt.permute(0, 2, 3, 1).numpy())))
    assert logits_t.shape == (8, 1000) and np.isfinite(logits_t).all()
    scale = np.abs(logits_j).max()
    assert np.abs(logits_t - logits_j).max() <= TOL * scale
    # trained weights: the same classes, most of them the labels (the
    # runs' validation top-1 is 79%; 15% of the hard set's images are
    # drawn from another class)
    assert (logits_t.argmax(-1) == logits_j.argmax(-1)).all()
    assert (logits_t.argmax(-1) == labels).sum() >= 5


DEIT_SMALL = ("results/deit_small_r05/ttm_deit_small_patch16_224_synthetic-"
              "hard-imagenet_0822-011014_model.msgpack", 14_391_736)


def test_trained_deit_small_through_the_port_reader(images):
    path = os.path.join(ROOT, DEIT_SMALL[0])
    v_port, v_jax = port_load_variables(path), load_variables(path)
    sd, sd_jax = jax_to_state_dict(v_port), jax_to_state_dict(v_jax)
    assert sd.keys() == sd_jax.keys()
    assert all(torch.equal(sd[k], sd_jax[k]) for k in sd)  # the same bytes
    model = create_model("ttm_deit_small_patch16_224", ratio="2")
    model.load_state_dict(sd)  # strict: every name
    assert count_params(model) == DEIT_SMALL[1]
    xt, labels = images[0][:2], images[1][:2]
    with torch.no_grad():
        logits_t = model.eval()(xt).numpy()
    jm = jax_model("ttm_deit_small_patch16_224", num_classes=1000, ratio="2")
    logits_j = np.asarray(jm.apply(v_jax, jnp.asarray(
        xt.permute(0, 2, 3, 1).numpy())))
    assert logits_t.shape == (2, 1000) and np.isfinite(logits_t).all()
    assert np.abs(logits_t - logits_j).max() <= TOL * np.abs(logits_j).max()
    assert (logits_t.argmax(-1) == logits_j.argmax(-1)).all()
