"""Small pieces of the zoo slice in the PyTorch port against the JAX
package on the same numpy inputs, in float32:

* `SVDLinear`: the forward in both modes, the decompose (the rank-r
  product, and both factors sqrt(s)-balanced), and one Z/U step of an
  `svd_linear` bucket by the port's kernel route (on the CPU its plain
  version: the Tucker-2 iteration at K = 1, r0 = r1) against the JAX
  package's Pallas route run in interpret mode, and by exact SVD on both
  sides;
* Riemannian SGD for the Stiefel factors beside the base optimizer, over
  5 steps on the same gradients, against the JAX package's
  `make_optimizer(..., stiefel=True)`: its `riemannian_sgd` on the 2-D
  first and last factors and the base chain (clip by global norm, L2
  decay, SGD momentum) on the rest, whose clip sees the rest alone; every
  factor stays orthonormal on its tall side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.hp import SVDSpec as JaxSVDSpec
from dnn_compression_tensor_admm_tpu.layers import SVDLinear as JaxSVDLinear
from dnn_compression_tensor_admm_tpu.train.optim import (
    make_optimizer as jax_optimizer)
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import RankPlan, SVDSpec
from dnn_compression_tensor_admm_tpu_torch.layers import SVDLinear
from dnn_compression_tensor_admm_tpu_torch.models import decompose_params
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk
from dnn_compression_tensor_admm_tpu_torch.train.optim import (
    RiemannianSGD, WithStiefel, make_train_optimizer, retract,
    tangent_project)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


O, I, R = 48, 32, 8  # an svd_linear layer [out, in] at rank R


@pytest.mark.parametrize("mode", ["chain", "reconstruct"])
def test_svd_linear_forward_matches_jax(mode):
    rng = np.random.RandomState(0)
    first = rng.standard_normal((R, I)).astype(np.float32)
    last = rng.standard_normal((O, R)).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    x = rng.standard_normal((4, 5, I)).astype(np.float32)
    layer = SVDLinear(I, O, SVDSpec(R), mode=mode)
    layer.load_state_dict({"first_factor": torch.from_numpy(first),
                           "last_factor": torch.from_numpy(last),
                           "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    want = JaxSVDLinear(I, O, JaxSVDSpec(R), mode=mode).apply(
        {"params": {"first_factor": first, "last_factor": last,
                    "bias": bias}}, jnp.asarray(x))
    # float32 products of 32 and 8 terms, in two libraries
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_svd_linear_decompose_matches_jax():
    rng = np.random.RandomState(1)
    w = rng.standard_normal((O, I)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    sd = decompose_params({"fc.weight": torch.from_numpy(w),
                           "fc.bias": torch.from_numpy(b)},
                          RankPlan("svd", {"fc.weight": SVDSpec(R)}))
    jp = JaxSVDLinear.factorize_dense(jnp.asarray(w), JaxSVDSpec(R))
    first, last = sd["fc.first_factor"].numpy(), sd["fc.last_factor"].numpy()
    assert first.shape == (R, I) and last.shape == (O, R)
    # the rank-R product (the factors' signs are each LAPACK's own): exact
    # SVDs in two LAPACKs cut a flat random spectrum by float32 rounding
    # (2.2e-4 of an element seen), so relative in the Frobenius norm; and
    # each factor's column / row norms: sqrt(s) on both sides
    assert _rel(last @ first, np.asarray(jp["last_factor"])
                @ np.asarray(jp["first_factor"])) < 1e-4
    np.testing.assert_allclose(np.linalg.norm(last, axis=0),
                               np.linalg.norm(first, axis=1), rtol=1e-5)
    np.testing.assert_array_equal(sd["fc.bias"].numpy(), b)


NAMES = [f"l{j}.weight" for j in range(2)]  # one bucket of 2 linears


@pytest.mark.parametrize("method", ["kernel", "svd"])
def test_svd_linear_zu_step_matches_jax(method):
    """One Z/U step from W with U away from 0. 'kernel': the port's route
    (the Tucker-2 iteration at K = 1, r0 = r1 = R, its plain version on
    the CPU) against the JAX package's Pallas kernel in interpret mode,
    the same float32 iteration summed in another order (1e-4, as the
    svd_conv route's test); 'svd': exact SVD on both sides."""
    rng = np.random.RandomState(2)
    ws = {n: rng.standard_normal((O, I)).astype(np.float32) / np.sqrt(I)
          for n in NAMES}
    us = {n: 0.01 * rng.standard_normal((O, I)).astype(np.float32)
          for n in NAMES}
    params_t = {n: torch.from_numpy(w) for n, w in ws.items()}
    tprog = teng.build_program(params_t, RankPlan(
        "svd", {n: SVDSpec(R) for n in NAMES}))
    assert [(g.kind, len(g.names)) for g in tprog.groups] == [
        ("svd_linear", 2)]
    assert tk.kernel_supported((2, 1, O, I), R, R)
    state = teng.AdmmState(u={n: torch.from_numpy(u) for n, u in us.items()},
                           z={n: p.clone() for n, p in params_t.items()})
    ts, tr = teng.admm_update(params_t, state, tprog, update_u=True,
                              method=method, n_iter=6)
    # flax Dense kernels are [in, out]
    params_j = {n[:-len(".weight")]: {"kernel": jnp.asarray(w.T)}
                for n, w in ws.items()}
    jprog = jeng.build_program(params_j, JaxRankPlan(
        "svd", {n: JaxSVDSpec(R) for n in NAMES}))
    jstate = jeng.AdmmState(u={n: jnp.asarray(u.T) for n, u in us.items()},
                            z={n: jnp.asarray(w.T) for n, w in ws.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCTA_PALLAS_INTERPRET", "1")
        js, jr = jeng.admm_update(
            params_j, jstate, jprog, update_u=True,
            method="pallas" if method == "kernel" else method, n_iter=6)
    for n in NAMES:
        z_j = np.asarray(js.z[n]).T
        assert _rel(ts.z[n].numpy(), z_j) < 1e-4, n
        assert np.linalg.norm(ts.u[n].numpy() - np.asarray(js.u[n]).T) <= \
            1e-4 * np.linalg.norm(z_j), n
        np.testing.assert_allclose(float(tr[n]), float(jr[n]), rtol=1e-4)
        assert np.linalg.matrix_rank(ts.z[n].numpy(), tol=1e-4) == R


# --- Riemannian SGD -------------------------------------------------------

STEPS, LR, CLIP, WD = 5, 0.05, 0.5, 1e-4
SHAPES = {"conv.first_factor": (6, 20),   # wide: [r_in, I]
          "conv.core_kernel": (8, 6, 3, 3),
          "conv.last_factor": (24, 8),    # tall: [O, r_out]
          "conv.bias": (24,)}


def _orthonormal(shape, rng):
    """A factor on the manifold: orthonormal columns (tall) or rows."""
    tall = shape[0] >= shape[1]
    q, _ = np.linalg.qr(rng.standard_normal(shape if tall else shape[::-1]))
    return (q if tall else q.T).astype(np.float32)


def _max_ortho_err(w):
    a = w if w.shape[0] >= w.shape[1] else w.T
    return float(np.abs(a.T @ a - np.eye(a.shape[1])).max())


def test_riemannian_sgd_matches_jax_over_five_steps():
    rng = np.random.RandomState(3)
    init = {n: (_orthonormal(s, rng) if n.endswith("factor")
                else rng.standard_normal(s).astype(np.float32))
            for n, s in SHAPES.items()}
    # gradients large enough that the base branch's clip acts
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(STEPS)]
    params = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
              for n, a in init.items()}
    opt, clipped = make_train_optimizer(params.items(), LR, opt="momentum",
                                        momentum=0.9, weight_decay=WD,
                                        stiefel=True)
    assert isinstance(opt, WithStiefel)
    assert {id(p) for p in clipped} == {id(params["conv.core_kernel"]),
                                        id(params["conv.bias"])}
    # the JAX side: factors by name, flax's layout (the core as HWIO); the
    # clip inside the base branch sees the core and the bias alone
    def to_jax(d):
        return {"conv": {"first_factor": d["conv.first_factor"],
                         "last_factor": d["conv.last_factor"],
                         "core_kernel": d["conv.core_kernel"].transpose(
                             2, 3, 1, 0),
                         "bias": d["conv.bias"]}}
    jparams = jax.tree.map(jnp.asarray, to_jax(init))
    tx = jax_optimizer("momentum", LR, momentum=0.9, weight_decay=WD,
                       clip_grad=CLIP, stiefel=True)
    jstate = tx.init(jparams)
    base_norms = []
    for g in grads:
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n].copy())
        base_norms.append(float(torch.nn.utils.clip_grad_norm_(clipped,
                                                               CLIP)))
        opt.step()
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, to_jax(g)),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert min(base_norms) > CLIP  # the clip acted at every step
    want = jax.tree.map(np.asarray, jparams)["conv"]
    got = {k.split(".")[1]: p.detach().numpy() for k, p in params.items()}
    got["core_kernel"] = got["core_kernel"].transpose(2, 3, 1, 0)
    # float32 QR and products in two libraries over 5 steps; torch's clip
    # divides by the norm + 1e-6, optax's by the norm (~2e-6 relative)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-5,
                                   err_msg=k)
    for k in ("first_factor", "last_factor"):
        assert _max_ortho_err(got[k]) < 1e-5, k
        assert not np.allclose(got[k], to_jax(init)["conv"][k], atol=1e-3)


def test_tangent_projection_and_retraction():
    rng = np.random.RandomState(4)
    for shape in ((12, 5), (5, 12)):
        w = torch.from_numpy(_orthonormal(shape, rng))
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = tangent_project(w, g)
        a, ta = (w, t) if shape[0] >= shape[1] else (w.T, t.T)
        # a tangent vector: a^T t is skew-symmetric
        s = a.T @ ta
        assert torch.allclose(s + s.T, torch.zeros_like(s), atol=1e-5)
        # the retraction of a point already on the manifold is the point
        assert torch.allclose(retract(w), w, atol=1e-5)
        assert _max_ortho_err(retract(w + 0.3 * g).numpy()) < 1e-5


def test_riemannian_sgd_momentum_buffer_holds_the_tangent_vector():
    rng = np.random.RandomState(5)
    w = torch.nn.Parameter(torch.from_numpy(_orthonormal((10, 4), rng)))
    g = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    opt = RiemannianSGD([w], lr=0.1, momentum=0.9)
    w0 = w.detach().clone()
    w.grad = g.clone()
    opt.step()
    buf = opt.state[w]["momentum_buffer"]
    assert torch.allclose(buf, tangent_project(w0, g), atol=1e-6)
    assert torch.allclose(w.detach(), retract(w0 - 0.1 * buf), atol=1e-6)


def test_cli_auto_plan_ratio_and_stiefel_fine_tune(tmp_path, capsys):
    """The command line at a numeric ratio without a table (the automatic
    TK plan of ResNet20 at 3.5): ADMM with `--save-model`, then
    `--decompose` of that msgpack into `stftkc_resnet20`, whose factors
    Riemannian SGD keeps orthonormal through the fine-tune's steps."""
    from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main
    common = ["--ratio", "3.5", "--dataset", "synthetic-cifar10",
              "--synthetic-size", "16", "--batch-size", "4", "--epochs", "1",
              "--steps-per-epoch", "2", "--fp32", "--device", "cpu"]
    cli_main(["--model", "resnet20", "--admm", "--format", "tk",
              "--save-model", "--output-dir", str(tmp_path), *common])
    (dense,) = tmp_path.glob("resnet20_*_admm_tk_*_model.msgpack")
    model, hist = cli_main(["--model", "stftkc_resnet20", "--decompose",
                            "--model-path", str(dense), "--lr", "0.1",
                            *common])
    assert "compression" in capsys.readouterr().out
    assert np.isfinite(hist[-1]["train_loss"])
    factors = {n: p.detach().numpy() for n, p in model.named_parameters()
               if n.endswith(("first_factor", "last_factor"))}
    # the auto plan's 12 3x3 convs of stages 2 and 3 (stage 1's 16 x 16
    # ones hold 2,304 weights, under its 4,096, and stay dense)
    assert len(factors) == 2 * 12
    for n, w in factors.items():
        assert _max_ortho_err(w) < 1e-5, n
