"""The PyTorch port's learning-rate schedule and gradient clipping against
the JAX package's optax chains (`train/optim.py`): the cosine schedule
with and without its linear warmup at every step, and five steps of
clip-by-global-norm + SGD momentum (L2) and of clip + AdamW from the same
parameters and gradients, with gradients large enough that the clip
binds at every step.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_compression_tensor_admm_tpu.train.optim import (
    make_optimizer as jax_optimizer, make_schedule)
from dnn_compression_tensor_admm_tpu_torch.train.optim import (
    cosine_lr, make_optimizer)

LR, MIN_LR = 0.1, 1e-5


@pytest.mark.parametrize("warmup_epochs", [0, 1, 2])
def test_cosine_lr_matches_the_jax_schedule_at_every_step(warmup_epochs):
    epochs, steps = 5, 7
    sched = make_schedule("cosine", LR, epochs, steps, warmup_epochs, MIN_LR)
    if warmup_epochs:
        # the JAX package's schedule is optax's warmup cosine from 1e-6
        ref = optax.warmup_cosine_decay_schedule(
            1e-6, LR, warmup_epochs * steps, epochs * steps, MIN_LR)
        assert all(float(sched(s)) == float(ref(s)) for s in range(40))
    for step in range(epochs * steps + 5):  # past the end: min_lr
        got = cosine_lr(step, LR, epochs * steps, MIN_LR,
                        warmup_epochs * steps)
        # optax computes in float32: within 1e-6 relative, and near 0 by
        # float32 rounding of lr-sized terms (its warmup start,
        # (1e-6 - 0.1) + 0.1, rounds to 9.98e-7)
        np.testing.assert_allclose(got, float(sched(step)), rtol=1e-6,
                                   atol=1e-8, err_msg=str(step))
    if warmup_epochs:
        assert cosine_lr(0, LR, 35, MIN_LR, 7) == 1e-6
        assert cosine_lr(7, LR, 35, MIN_LR, 7) == LR


def test_warmup_longer_than_the_run_is_refused():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(1e-6, LR, 10, 10, MIN_LR)
    with pytest.raises(ValueError, match="warmup"):
        cosine_lr(10, LR, 10, MIN_LR, 10)


# each optimizer at its recipe's lr (ResNet SGD 0.1, DeiT AdamW 5e-4):
# optax takes Adam's bias correction 1 - 0.999^t in float32 (1.3e-5
# relative at t = 1), torch in float64, which at lr 0.1 moves AdamW's
# steps apart by ~6e-7 each
@pytest.mark.parametrize("opt,lr,wd", [("momentum", 0.1, 1e-4),
                                       ("adamw", 5e-4, 0.05)])
def test_clip_and_optimizer_match_optax_over_5_steps(opt, lr, wd):
    rng = np.random.RandomState(0)
    shapes = [(16, 8), (8,), (3, 5, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # global norms ~50 to 100 against a clip of 1
    grads = [[(10 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    epochs, steps, warm, clip = 5, 1, 2, 1.0
    tx = jax_optimizer(opt, make_schedule("cosine", lr, epochs, steps, warm,
                                          MIN_LR),
                       momentum=0.9, weight_decay=wd, clip_grad=clip)
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = make_optimizer(params, lr, opt=opt, momentum=0.9, weight_decay=wd)
    for step, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(a) for a in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        for group in topt.param_groups:
            group["lr"] = cosine_lr(step, lr, epochs * steps, MIN_LR,
                                    warm * steps)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        # as the train loop clips
        norm = torch.nn.utils.clip_grad_norm_(params, clip)
        assert norm.item() > 10 * clip  # the clip binds
        assert np.isclose(np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                                      for a in g)), norm.item(), rtol=1e-5)
        topt.step()
    for p, a in zip(params, pj):
        # float32 on both sides; torch divides by ||g|| + 1e-6 where optax
        # divides by ||g|| (5e-8 relative here)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-6)
    # the steps moved the parameters by more than the tolerance
    assert max(np.abs(p.detach().numpy() - a).max()
               for p, a in zip(params, p0)) > 1e-4
