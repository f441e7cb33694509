"""The port's distillation loss, late rho boost and evaluation cadence
against the JAX package: `distillation_loss` on the same logits, and the
rho each ADMM epoch's penalty uses and the epochs that evaluate, read
from `train_model`'s history rows, against the JAX package's
`adjust_rho` and its `(epoch + 1) % eval_every == 0 or last` rule; and
the count of layers the Z-step's finite guard keeps, which the rows
carry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm.engine import adjust_rho as jax_adjust_rho
from dnn_compression_tensor_admm_tpu.train.losses import (
    distillation_loss as jax_distillation_loss)
from dnn_compression_tensor_admm_tpu_torch.admm import (
    AdmmState, admm_init, admm_update, build_program)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.train import TrainConfig, train_model
from dnn_compression_tensor_admm_tpu_torch.train import engine as tengine
from dnn_compression_tensor_admm_tpu_torch.train.losses import distillation_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind,alpha,tau", [
    ("none", 0.5, 1.0), ("soft", 0.5, 1.0), ("soft", 0.3, 3.0),
    ("hard", 0.5, 1.0), ("hard", 0.9, 2.0)])
def test_distillation_loss_matches_jax(kind, alpha, tau):
    rng = np.random.RandomState(0)
    s = (3 * rng.standard_normal((16, 1000))).astype(np.float32)
    t = (3 * rng.standard_normal((16, 1000))).astype(np.float32)
    base = np.float32(2.75)
    want = float(jax_distillation_loss(jnp.asarray(base), jnp.asarray(s),
                                       jnp.asarray(t), kind, alpha, tau))
    got = distillation_loss(torch.tensor(base), torch.from_numpy(s),
                            torch.from_numpy(t), kind, alpha, tau).item()
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    # bfloat16 student logits, as the X-step's autocast gives them: the
    # loss is taken in float32 on both sides
    s16 = torch.from_numpy(s).bfloat16()
    want16 = float(jax_distillation_loss(
        jnp.asarray(base), jnp.asarray(s16.float().numpy(), jnp.bfloat16),
        jnp.asarray(t), kind, alpha, tau))
    got16 = distillation_loss(torch.tensor(base), s16, torch.from_numpy(t),
                              kind, alpha, tau).item()
    assert abs(got16 - want16) <= 1e-6 * max(1.0, abs(want16))


def test_distillation_needs_teacher_weights_and_a_known_type():
    cfg = TrainConfig(model="resnet32", distillation_type="hard",
                      teacher_model="resnet32", device="cpu")
    with pytest.raises(ValueError, match="teacher model and its weights"):
        tengine._make_teacher(cfg, 10, torch.device("cpu"))
    cfg.distillation_type = "kl"
    with pytest.raises(ValueError, match="unknown distillation type"):
        tengine._make_teacher(cfg, 10, torch.device("cpu"))
    cfg.distillation_type = "hard"
    cfg.teacher_state_dict = create_model("resnet32").state_dict()
    teacher = tengine._make_teacher(cfg, 10, torch.device("cpu"))
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())


@pytest.mark.parametrize("epochs,eval_every", [(7, 7), (20, 7), (20, 1)])
def test_rho_and_eval_rows_follow_the_jax_rule(monkeypatch, epochs,
                                               eval_every):
    """The Z-step is replaced by a stub (its cost is not what is tested);
    every X-step's penalty records the rho it was given, a 0-d float32
    tensor read at the step (a captured step reads it on the card)."""
    used = []

    def penalty(params, state, program, rho):
        used.append(float(rho))
        return torch.zeros(())

    def z_step(params, state, program, **kw):
        return (AdmmState(u=state.u, z=state.z, nonfinite=torch.tensor(0)),
                {n: torch.zeros(()) for n in program.names})

    monkeypatch.setattr(tengine, "admm_penalty", penalty)
    monkeypatch.setattr(tengine, "admm_update", z_step)
    cfg = TrainConfig(model="resnet32", dataset="synthetic-cifar10",
                      synthetic_size=8, batch_size=2, steps_per_epoch=1,
                      epochs=epochs, admm=True, rho=2e-3, adjust_rho_late=True,
                      eval_every=eval_every, compute_dtype=None, device="cpu",
                      print_fn=lambda _: None)
    _, hist = train_model(cfg)
    want = [jax_adjust_rho(e, epochs, 2e-3) for e in range(epochs)]
    assert [h["rho"] for h in hist] == want
    assert used == [float(np.float32(r)) for r in want]
    assert want.count(1e-2) == epochs - 1 - int(0.85 * epochs)
    evaluated = [h["epoch"] for h in hist if "test_loss" in h]
    assert evaluated == [e + 1 for e in range(epochs)
                         if (e + 1) % eval_every == 0 or e + 1 == epochs]
    assert all(h["admm_nonfinite_layers"] == 0 for h in hist)


def test_z_step_counts_the_layers_the_finite_guard_keeps():
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan("resnet32", "tt", "3"))
    state = admm_init(params, program)
    state, _ = admm_update(params, state, program, method="kernel", n_iter=6)
    assert int(state.nonfinite) == 0
    bad = "layer1.1.conv2.weight"  # one layer of a ten-layer bucket
    with torch.no_grad():
        params[bad][0, 0, 0, 0] = float("nan")
    new, _ = admm_update(params, state, program, method="kernel", n_iter=6)
    assert int(new.nonfinite) == 1
    assert torch.equal(new.z[bad], state.z[bad])
    assert all(torch.isfinite(new.z[n]).all() for n in program.names)
