"""The PyTorch port's DeiT-tiny TK@2x slice against the JAX package, at a
small width: the tk_linear Z/U step (the port's kernel route, its plain
version on the CPU, against the JAX package's Pallas route in interpret
mode) on a 2-block ViT at embed 48 with a hand-made Tucker-2 plan and on
one 12-layer bucket at [12, 1, 96, 48], which also goes through the
`svd` and `subspace` methods on both sides; then decompose and the
logits of the decomposed model.

Both sides start from the same weights and ADMM state and take the same
numpy inputs, in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.hp import RankPlan as JaxRankPlan
from dnn_compression_tensor_admm_tpu.configs.hp import TKSpec as JaxTKSpec
from dnn_compression_tensor_admm_tpu.models import decompose_params as jax_decompose
from dnn_compression_tensor_admm_tpu.models.vit import VisionTransformer as JaxViT
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.configs import RankPlan, TKSpec
from dnn_compression_tensor_admm_tpu_torch.models import decompose_params
from dnn_compression_tensor_admm_tpu_torch.models.vit import VisionTransformer
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)

VIT = dict(img_size=32, embed_dim=48, depth=2, num_heads=3, num_classes=10)
# DeiT's four linears per block at embed 48 (hidden 192), each rank cut
RANKS = {"attn.qkv": (24, 16), "attn.proj": (16, 16), "mlp.fc1": (32, 16),
         "mlp.fc2": (16, 32)}
NAMES = [f"blocks.{b}.{m}.weight" for b in range(2) for m in RANKS]
BUCKET_LAYERS = [f"l{j}.weight" for j in range(12)]  # [96, 48] at (24, 16)


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


def _spec(name):
    return RANKS[".".join(name.split(".")[2:4])]


def _plans(names, spec_of):
    return (RankPlan("tk", {n: TKSpec(*spec_of(n)) for n in names}),
            JaxRankPlan("tk", {n: JaxTKSpec(*spec_of(n)) for n in names}))


def _zu_step(params_t, params_j, names, spec_of, rng, method="kernel"):
    """One Z/U step on both sides from the same weights and a state away
    from W, by the port's `method` (the JAX package's "pallas" for
    "kernel"): (port state, port residuals, JAX state, JAX residuals, the
    port's buckets and whether its gate takes each)."""
    plan_t, plan_j = _plans(names, spec_of)
    tprog = teng.build_program(params_t, plan_t)
    jprog = jeng.build_program(params_j, plan_j)
    state = teng.AdmmState(
        u={n: torch.from_numpy(0.01 * rng.standard_normal(
            params_t[n].shape).astype(np.float32)) for n in names},
        z={n: params_t[n].detach().clone() for n in names})
    jstate = jeng.AdmmState(  # Dense [in, out] on the JAX side
        u={n: jnp.asarray(t.numpy().T) for n, t in state.u.items()},
        z={n: jnp.asarray(t.numpy().T) for n, t in state.z.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCTA_PALLAS_INTERPRET", "1")
        js, jr = jeng.admm_update(
            params_j, jstate, jprog, update_u=True,
            method="pallas" if method == "kernel" else method, n_iter=6)
    ts, tr = teng.admm_update(params_t, state, tprog, update_u=True,
                              method=method, n_iter=6)
    buckets = [(g.kind, len(g.names), tuple(g.param_shape),
                tk.kernel_supported((len(g.names), 1, *g.param_shape),
                                    *spec_of(g.names[0])))
               for g in tprog.groups]
    return ts, tr, js, jr, buckets


@pytest.fixture(scope="module")
def slice_run(_one_torch_thread):
    rng = np.random.RandomState(0)
    tm = VisionTransformer(**VIT, generator=torch.Generator().manual_seed(0))
    params = dict(tm.named_parameters())
    v = state_dict_to_jax(tm.state_dict())
    out = {"vit": _zu_step(params, v["params"], NAMES, _spec, rng)}

    # one 12-layer bucket: [96, 48] linears (Dense [48, 96] on the JAX side),
    # by the kernel route and layer by layer by the other two methods
    ws = {n: rng.standard_normal((96, 48)).astype(np.float32) / np.sqrt(48)
          for n in BUCKET_LAYERS}
    for method in ("kernel", "svd", "subspace"):
        out[f"bucket_{method}"] = _zu_step(
            {n: torch.from_numpy(w) for n, w in ws.items()},
            {n[:-len(".weight")]: {"kernel": jnp.asarray(w.T)}
             for n, w in ws.items()},
            BUCKET_LAYERS, lambda n: (24, 16), rng, method)

    # decompose the dense model's weights on both sides, then the logits
    plan_t, plan_j = _plans(NAMES, _spec)
    jdec = jax.tree.map(np.asarray, jax_decompose(v, plan_j))
    tdec = decompose_params(jax_to_state_dict(v), plan_t)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jlogits = JaxViT(**VIT, plan=plan_j).apply(jdec, jnp.asarray(x))
    tc = VisionTransformer(**VIT, plan=plan_t, mode="chain")
    tc.load_state_dict(tdec)
    with torch.no_grad():
        tlogits = tc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    out["dec"] = (jax_to_state_dict(jdec), tdec, np.asarray(jlogits),
                  tlogits.numpy())
    return out


def _check_zu(run, names):
    ts, tr, js, jr, buckets = run
    assert all(kind == "tk_linear" and gated
               for kind, _, _, gated in buckets), buckets
    assert set(jr) == set(tr) == set(names)
    for n in names:
        z_t = ts.z[n].numpy().T
        # the same float32 iteration, summed in another order
        assert _rel(z_t, js.z[n]) < 1e-4, n
        u_t = ts.u[n].numpy().T
        assert np.linalg.norm(u_t - js.u[n]) <= 1e-4 * np.linalg.norm(js.z[n]), n
        np.testing.assert_allclose(float(tr[n]), float(jr[n]), rtol=1e-4,
                                   err_msg=n)


def test_zu_step_on_the_vit_matches_jax(slice_run):
    buckets = slice_run["vit"][4]
    assert sorted(b[:3] for b in buckets) == [
        ("tk_linear", 2, (48, 48)), ("tk_linear", 2, (48, 192)),
        ("tk_linear", 2, (144, 48)), ("tk_linear", 2, (192, 48))]
    _check_zu(slice_run["vit"], NAMES)


@pytest.mark.parametrize("method", ["kernel", "svd", "subspace"])
def test_zu_step_on_a_12_layer_bucket_matches_jax(slice_run, method):
    run = slice_run[f"bucket_{method}"]
    assert [b[:3] for b in run[4]] == [("tk_linear", 12, (96, 48))]
    _check_zu(run, BUCKET_LAYERS)


def test_decompose_matches_jax(slice_run):
    jdec, tdec, _, _ = slice_run["dec"]
    assert set(jdec) == set(tdec)
    for name in NAMES:
        p = name[:-len("weight")]
        w_t, w_j = ((sd[p + "last_factor"] @ sd[p + "core"]
                     @ sd[p + "first_factor"]).numpy() for sd in (tdec, jdec))
        # exact SVDs in two LAPACKs: factors may differ in sign, the
        # weights they stand for by float32 rounding at the rank cut
        assert _rel(w_t, w_j) < 1e-4, name
    for k in tdec:  # everything else is carried through
        if not k.endswith(("first_factor", "core", "last_factor")):
            np.testing.assert_array_equal(tdec[k].numpy(), jdec[k].numpy(),
                                          err_msg=k)


def test_decomposed_logits_match_jax(slice_run):
    _, _, jlogits, tlogits = slice_run["dec"]
    assert tlogits.shape == (4, 10) and np.isfinite(tlogits).all()
    # float32 through 2 blocks of Tucker-2 chains in two frameworks
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4)
