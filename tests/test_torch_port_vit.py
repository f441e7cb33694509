"""The PyTorch port's DeiT-tiny TT@2x modules against the JAX package's:
the rank plan and the kernel gate on it, the TT linear layer, the
ViT's logits and weights (DeiT-tiny at full width and depth with the
full plan, at a 32 x 32 input), AdamW, and the synthetic ImageNet set.

Inputs are numpy arrays made from a seed; both packages take the same
weights (the port's, moved by its `utils/jax_weights.py`), in float32.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.data.datasets import load_dataset as jax_load
from dnn_compression_tensor_admm_tpu.layers.tt_linear import TTLinear as JaxTTLinear
from dnn_compression_tensor_admm_tpu.models.vit import VisionTransformer as JaxViT
from dnn_compression_tensor_admm_tpu.utils.torch_import import variables_to_torch
from dnn_compression_tensor_admm_tpu_torch.admm import build_program
from dnn_compression_tensor_admm_tpu_torch.configs import TTLinearSpec, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.data.datasets import load_dataset
from dnn_compression_tensor_admm_tpu_torch.layers import TTLinear
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from dnn_compression_tensor_admm_tpu_torch.ops.ttd import tt2ten
from dnn_compression_tensor_admm_tpu_torch.train.optim import cosine_lr, make_optimizer
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)

NAME = "deit_tiny_patch16_224"
# float32 through 12 transformer blocks in two frameworks
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _port(prefix="", seed=0):
    """The port's DeiT-tiny at a 32 x 32 input, no drop path."""
    name = f"{prefix}_{NAME}" if prefix else NAME
    return create_model(name, img_size=32, drop_path_rate=0.0,
                        generator=torch.Generator().manual_seed(seed),
                        **({"ratio": "2"} if prefix else {}))


def _jax(prefix=""):
    plan = jax_plan(NAME, "tt", "2") if prefix else None
    mode = "reconstruct" if prefix == "ttr" else "factorized"
    return JaxViT(img_size=32, embed_dim=192, depth=12, num_heads=3,
                  num_classes=1000, drop_path_rate=0.0, plan=plan, mode=mode)


def test_plan_matches_jax():
    plan_t = get_rank_plan(NAME, "tt", "2")
    plan_j = jax_plan(NAME, "tt", "2")
    assert list(plan_t.names()) == list(plan_j.names()) and len(plan_t.layers) == 48
    for name in plan_j.names():
        sj, st = plan_j.spec(name), plan_t.spec(name)
        assert isinstance(st, TTLinearSpec)
        assert (st.tt_shapes, st.tt_ranks, st.out_order, st.mid_rank) == (
            sj.tt_shapes, sj.tt_ranks, sj.out_order, sj.mid_rank), name
    # the compressed name resolves to the same plan
    assert get_rank_plan(f"ttm_{NAME}", "tt", "2") == plan_t


def test_gate_accepts_every_deit_bucket():
    program = build_program(dict(_port().named_parameters()),
                            get_rank_plan(NAME, "tt", "2"))
    assert len(program.groups) == 11 and len(program.names) == 48
    assert {g.kind for g in program.groups} == {"tt_linear"}
    assert all(sk.tt_supported(len(g.names), int(np.prod(g.param_shape)),
                               g.spec.tt_shapes, g.spec.tt_ranks)
               for g in program.groups)
    launches = [(rows, cols, r) for g in program.groups
                for rows, cols, r in sk.sweep_steps(g.spec.tt_shapes,
                                                    g.spec.tt_ranks)
                if r != rows]
    plans = [sk.plan_name(*s) for s in launches]
    assert len(launches) == 33 and plans.count("workspace") == 13
    # the 11 r = 96 launches and two of the three 2304 x 32 ones are past a
    # block; the rest keep the block plans (2304 x 32 at r = 22 fits the
    # unpadded one exactly)
    assert sorted(s for s, p in zip(launches, plans) if p == "workspace") == [
        (144, 192, 96), (144, 768, 96), (144, 768, 96), (180, 192, 96),
        (180, 768, 96), (384, 192, 96), (480, 192, 96), (528, 192, 96),
        (528, 192, 96), (672, 192, 96), (720, 192, 96), (2304, 32, 28),
        (2304, 32, 30)]
    assert sk.plan_name(2304, 32, 22) == "unpadded"
    for s, p in zip(launches, plans):
        assert (p == "workspace") == (not sk.block_plan_fits(*s))


@pytest.mark.parametrize("key", ["blocks.0.attn.qkv.weight",
                                 "blocks.5.mlp.fc2.weight"])
def test_tt_linear_matches_jax(key):
    spec = get_rank_plan(NAME, "tt", "2").spec(key)
    o, i = spec.out_features, spec.in_features
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, i)).astype(np.float32)
    for mode in ("factorized", "reconstruct"):
        jm = JaxTTLinear(i, o, jax_plan(NAME, "tt", "2").spec(key), mode=mode)
        v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, i)))
        v = jax.tree.map(np.asarray, v)
        v["params"]["bias"] = rng.normal(0, 0.1, o).astype(np.float32)
        tm = TTLinear(i, o, spec, mode=mode)
        tm.load_state_dict({k: torch.from_numpy(np.array(a))
                            for k, a in v["params"].items()})
        with torch.no_grad():
            y_t = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y_t, np.asarray(jm.apply(v, x)),
                                   rtol=1e-5, atol=1e-5)
    # factorize_dense: the matrix the cores stand for
    w = (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)
    cj = JaxTTLinear.factorize_dense(jnp.asarray(w), jax_plan(NAME, "tt", "2").spec(key))
    ct = TTLinear.factorize_dense(torch.from_numpy(w), spec)
    assert sorted(ct) == sorted(cj)
    for k in ct:
        assert tuple(ct[k].shape) == cj[k].shape, k
    dense_t = tt2ten([ct[f"core_{j}"] for j in range(len(ct))],
                     spec.tt_shapes).reshape(o, i).numpy()
    dense_j = tt2ten([torch.from_numpy(np.array(cj[f"core_{j}"]))
                      for j in range(len(cj))], spec.tt_shapes).reshape(o, i).numpy()
    # exact SVDs in two LAPACKs: cores may differ in sign, the matrices
    # they stand for only by float32 rounding at the rank cut
    assert _rel(dense_t, dense_j) < 1e-3


@pytest.mark.parametrize("prefix", ["", "ttm", "ttr"])
def test_logits_match_jax(prefix):
    tm = _port(prefix).eval()
    v = state_dict_to_jax(tm.state_dict())
    x = np.random.RandomState(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    logits_j = np.asarray(jax.jit(_jax(prefix).apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        logits_t = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert logits_t.shape == (2, 1000) and logits_t.dtype == np.float32
    np.testing.assert_allclose(logits_t, logits_j, **LOGIT_TOL)


@pytest.mark.parametrize("prefix", ["", "ttm"])
def test_weights_carry_across_both_ways(prefix):
    sd = _port(prefix).state_dict()
    v = state_dict_to_jax(sd)
    # the JAX model's own parameter tree, names and shapes
    shapes = jax.eval_shape(_jax(prefix).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    flat_s = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    assert [p for p, _ in flat_s] == [p for p, _ in flat_v]
    assert [s.shape for _, s in flat_s] == [a.shape for _, a in flat_v]
    # back again, and against the JAX package's own converter
    back = jax_to_state_dict(v)
    assert set(back) == set(sd)
    ref = variables_to_torch(v)
    assert set(ref) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy(), err_msg=k)
        np.testing.assert_array_equal(ref[k], t.numpy(), err_msg=k)


def test_drop_path_draws_from_the_given_generator():
    tm = create_model(NAME, img_size=32,
                      generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (4, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        a = tm(x, torch.Generator().manual_seed(5))
        b = tm(x, torch.Generator().manual_seed(5))
        c = tm(x, torch.Generator().manual_seed(6))
        with pytest.raises(ValueError, match="generator"):
            tm(x)
        ev = tm.eval()(x)  # no drop path in eval mode: no generator needed
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev)


def test_adamw_matches_optax_over_5_steps():
    rng = np.random.RandomState(0)
    shapes = [(16, 8), (8,), (3, 5, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    lr, wd, total = 5e-4, 0.05, 5
    sched = optax.cosine_decay_schedule(lr, total, alpha=1e-5 / lr)
    tx = optax.adamw(sched, weight_decay=wd)
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer(params, lr, opt="adamw", weight_decay=wd)
    for step, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(a) for a in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        for group in opt.param_groups:
            group["lr"] = cosine_lr(step, lr, total, 1e-5)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for p, a in zip(params, pj):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-6)
    # the decay reached every parameter: without it the result differs
    assert max(np.abs(p.detach().numpy() - a).max()
               for p, a in zip(params, p0)) > 0


def _digest(x, y):
    return hashlib.sha256(x.tobytes() + y.tobytes()).hexdigest()


def test_synthetic_imagenet_bytes_match_jax():
    for train, n in ((True, 512), (False, 128)):
        xt, yt, info = load_dataset("synthetic-imagenet", train, n)
        xj, yj, info_j = jax_load("synthetic-imagenet", train,
                                  synthetic_size=n)
        assert xt.shape == (n, 224, 224, 3) and xt.dtype == np.uint8
        assert _digest(xt, yt) == _digest(xj, yj), (train, n)
        assert (info.num_classes, info.input_size, info.mean, info.std) == (
            info_j.num_classes, info_j.input_size, info_j.mean, info_j.std)
