"""Tensor-Train pieces of the PyTorch port against the JAX package: TT
ops, core merging, the ResNet32 TT plan, the TT conv layer and the
compressed model, on the same numpy inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.configs.resolver import (
    get_rank_plan as jax_plan)
from dnn_compression_tensor_admm_tpu.layers.tt_conv import TTConv2d as JaxTTConv2d
from dnn_compression_tensor_admm_tpu.models import (
    compression_ratio as jax_ratio, create_model as jax_model)
from dnn_compression_tensor_admm_tpu.ops import contractions as jcon
from dnn_compression_tensor_admm_tpu.ops import ttd as jttd
from dnn_compression_tensor_admm_tpu_torch.configs import TTConvSpec, get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.layers import TTConv2d
from dnn_compression_tensor_admm_tpu_torch.models import (
    compression_ratio, count_params, create_model)
from dnn_compression_tensor_admm_tpu_torch.ops import contractions, ttd
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, state_dict_to_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# exact SVDs in two LAPACKs: singular vectors may flip sign, so
# reconstructions are compared, to float32 rounding through a few products
REC_TOL = 1e-4
# float32 convolutions in two frameworks
CONV_TOL = dict(rtol=1e-4, atol=1e-5)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("shapes,ranks", [
    ([16, 9, 16], [1, 16, 16, 1]),            # layer1: full rank
    ([8, 4, 9, 4, 8], [1, 8, 16, 16, 8, 1]),  # layer2 rest
    ([8, 8, 9, 4, 8], [1, 8, 40, 24, 8, 1]),  # layer3.0.conv1
    ([4, 5, 6], [1, 50, 50, 1]),              # ranks that the clamp lowers
])
def test_clamp_ten2tt_tt2ten_tt_project_match_jax(shapes, ranks):
    assert ttd.clamp_tt_ranks(shapes, ranks) == jttd.clamp_tt_ranks(shapes, ranks)
    x = np.random.RandomState(len(shapes)).standard_normal(shapes).astype(
        np.float32)
    cores_t = ttd.ten2tt(torch.from_numpy(x), shapes, ranks)
    cores_j = jttd.ten2tt(jnp.asarray(x), shapes, ranks)
    assert [tuple(c.shape) for c in cores_t] == [c.shape for c in cores_j]
    rec_t = ttd.tt2ten(cores_t, shapes).numpy()
    rec_j = np.asarray(jttd.tt2ten(cores_j, shapes))
    assert _rel(rec_t, rec_j) < REC_TOL
    # tt2ten alone, on the same cores
    np.testing.assert_allclose(
        ttd.tt2ten([torch.from_numpy(np.array(c)) for c in cores_j],
                   shapes).numpy(), rec_j, rtol=1e-5, atol=1e-5)
    for method in ("svd", "subspace"):
        z_t = ttd.tt_project(torch.from_numpy(x), shapes, ranks, method=method)
        z_j = jttd.tt_project(jnp.asarray(x), shapes, ranks, method=method)
        assert _rel(z_t.numpy(), z_j) < REC_TOL, method


def test_tt_project_is_exact_at_full_rank():
    x = np.random.RandomState(0).standard_normal((16, 9, 16)).astype(np.float32)
    z = ttd.tt_project(torch.from_numpy(x), [16, 9, 16], [1, 16, 16, 1])
    assert _rel(z.numpy(), x) < 1e-5


@pytest.mark.parametrize("ranks", [[1, 3, 5], [5, 3, 1], [1, 3, 1]])
def test_merge_tt_matrix_matches_jax(ranks):
    rng = np.random.RandomState(sum(ranks))
    cores = [rng.standard_normal((ranks[0], 4, ranks[1])).astype(np.float32),
             rng.standard_normal((ranks[1], 6, ranks[2])).astype(np.float32)]
    m_t = contractions.merge_tt_matrix([torch.from_numpy(c) for c in cores])
    m_j = jcon.merge_tt_matrix([jnp.asarray(c) for c in cores])
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5,
                               atol=1e-6)


def test_merge_tt_matrix_rejects_open_chain():
    with pytest.raises(ValueError):
        contractions.merge_tt_matrix([torch.zeros(2, 4, 3)])


def test_resnet32_tt3_plan_equals_jax():
    port = get_rank_plan("resnet32", "tt", "3")
    ref = jax_plan("resnet32", "tt", "3", "general")
    assert port.fmt == ref.fmt == "tt"
    assert list(port.layers) == list(ref.layers) and len(port.layers) == 30
    for name, spec in ref.layers.items():
        got = port.spec(name)
        assert isinstance(got, TTConvSpec), name
        assert (got.tt_shapes, got.tt_ranks, got.out_order) == (
            spec.tt_shapes, spec.tt_ranks, spec.out_order), name
    sp = port.spec("layer3.0.conv1.weight")
    assert (sp.out_shapes, sp.filter_dim, sp.in_shapes) == ((8, 8), 9, (4, 8))
    assert (sp.out_ranks, sp.in_ranks) == ((1, 8, 40), (24, 8, 1))
    assert sp.out_channels == 64 and sp.in_channels == 32


def test_tt_conv_spec_create_rejects_bad_split():
    with pytest.raises(ValueError):
        TTConvSpec.create((8, 4, 9, 4, 8), (1, 8, 16, 16, 8, 1), 24)


def _jax_spec(shapes, ranks):
    """The JAX plan's spec of a ResNet32 TT@3x layer with these shapes and
    (clamped) ranks."""
    return next(s for s in jax_plan("resnet32", "tt", "3").layers.values()
                if (s.tt_shapes, tuple(s.tt_ranks)) == (shapes, ranks))


LAYER_CASES = [  # (O, I, stride, tt_shapes, tt_ranks)
    (16, 16, 1, (16, 9, 16), (1, 16, 16, 1)),
    (32, 16, 2, (8, 4, 9, 4, 4), (1, 8, 32, 16, 4, 1)),
    (64, 64, 1, (8, 8, 9, 8, 8), (1, 8, 27, 27, 8, 1)),
]


@pytest.mark.parametrize("o,i,stride,shapes,ranks", LAYER_CASES)
@pytest.mark.parametrize("mode", ["factorized", "reconstruct"])
def test_tt_conv_forward_matches_jax_both_ways(o, i, stride, shapes, ranks,
                                               mode):
    spec = TTConvSpec.create(shapes, ranks, o)
    jm = JaxTTConv2d(i, o, 3, _jax_spec(shapes, ranks), stride=stride,
                     padding=1, mode=mode)
    x = np.random.RandomState(o + i).standard_normal((2, 8, 8, i)).astype(
        np.float32)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(o), jnp.asarray(x)))
    y_j = np.asarray(jm.apply(v, jnp.asarray(x)))
    # JAX -> port
    tm = TTConv2d(i, o, 3, spec, stride=stride, padding=1, mode=mode)
    sd = jax_to_state_dict(v)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y_t.numpy(), y_j, **CONV_TOL)
    # port -> JAX: the port's own random init, carried back
    tm2 = TTConv2d(i, o, 3, spec, stride=stride, padding=1, mode=mode,
                   generator=torch.Generator().manual_seed(1))
    v2 = state_dict_to_jax(tm2.state_dict())
    with torch.no_grad():
        y2_t = tm2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y2_t.numpy(),
                               np.asarray(jm.apply(v2, jnp.asarray(x))),
                               **CONV_TOL)


@pytest.mark.parametrize("o,i,stride,shapes,ranks", LAYER_CASES[1:])
def test_tt_conv_factorize_dense_matches_jax(o, i, stride, shapes, ranks):
    spec = TTConvSpec.create(shapes, ranks, o)
    w = np.random.RandomState(i).standard_normal((o, i, 3, 3)).astype(
        np.float32)
    jspec = _jax_spec(shapes, ranks)
    pj = JaxTTConv2d.factorize_dense(jnp.asarray(w), jspec)
    pt = TTConv2d.factorize_dense(torch.from_numpy(w), spec)
    assert set(pt) == set(pj)
    # the dense kernels the two parameter sets stand for agree (cores may
    # differ in sign); both modes of one layer give the same output
    x = np.random.RandomState(0).standard_normal((2, 8, 8, i)).astype(
        np.float32)
    ys = []
    for mode in ("factorized", "reconstruct"):
        jm = JaxTTConv2d(i, o, 3, jspec, padding=1, mode=mode, use_bias=False)
        tm = TTConv2d(i, o, 3, spec, padding=1, mode=mode, bias=False)
        tm.load_state_dict(pt)
        with torch.no_grad():
            y_t = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y_j = np.asarray(jm.apply({"params": pj}, jnp.asarray(x)))
        assert _rel(y_t.numpy(), y_j) < REC_TOL, mode
        ys.append(y_t.numpy())
    assert _rel(ys[0], ys[1]) < 1e-5


def test_tt_conv_core_kernel_layout_carries_across():
    spec = TTConvSpec.create((8, 4, 9, 4, 8), (1, 8, 16, 16, 8, 1), 32)
    tm = TTConv2d(32, 32, 3, spec, generator=torch.Generator().manual_seed(0))
    assert tuple(tm.core_kernel.shape) == (16, 16, 3, 3)  # OIHW [r_outL, r_in0]
    v = state_dict_to_jax(tm.state_dict())
    assert v["params"]["core_kernel"].shape == (3, 3, 16, 16)  # HWIO
    np.testing.assert_array_equal(
        v["params"]["core_kernel"], tm.core_kernel.detach().numpy().transpose(2, 3, 1, 0))
    assert v["params"]["out_core_1"].shape == (8, 4, 16)
    back = jax_to_state_dict(v)
    for k, t in tm.state_dict().items():
        assert torch.equal(back[k], t), k


@pytest.mark.parametrize("name", ["ttm_resnet32", "ttr_resnet32"])
def test_ttm_resnet32_params_and_ratio_match_jax(name):
    dense = create_model("resnet32")
    tt = create_model(name, ratio="3")
    jv_dense = jax_model("resnet32", num_classes=10).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    jv_tt = jax_model(name, num_classes=10, ratio="3").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    n_j = sum(np.size(a) for a in jax.tree.leaves(jv_tt["params"]))
    assert count_params(tt) == n_j
    ratio = compression_ratio(dense, tt)
    assert ratio == pytest.approx(jax_ratio(jv_dense, jv_tt), rel=1e-12)
    assert round(ratio, 2) == 2.78
    x = torch.zeros(2, 3, 32, 32)
    with torch.no_grad():
        assert tt.eval()(x).shape == (2, 10)


@pytest.mark.parametrize("method", ["svd", "subspace"])
@pytest.mark.parametrize("o,i,stride,shapes,ranks", LAYER_CASES[1:])
def test_layer_projection_matches_jax(method, o, i, stride, shapes, ranks):
    """One layer's TT Z-step on the [O, kh*kw, I] view, in each package's
    own weight layout (OIHW here, HWIO there)."""
    from dnn_compression_tensor_admm_tpu.admm.engine import _project_one as jproj
    from dnn_compression_tensor_admm_tpu_torch.admm.engine import (
        _Group, _project_one)
    w = np.random.RandomState(o * i).standard_normal((o, i, 3, 3)).astype(
        np.float32)
    spec = TTConvSpec.create(shapes, ranks, o)
    g = _Group(kind="tt_conv", names=("w",), spec=spec, param_shape=w.shape)
    z_t = _project_one(g, torch.from_numpy(w), method=method, n_iter=6)
    z_j = jproj("tt_conv", _jax_spec(shapes, ranks),
                jnp.asarray(w.transpose(2, 3, 1, 0)), method=method, n_iter=6)
    assert _rel(z_t.permute(2, 3, 1, 0).numpy(), z_j) < REC_TOL


def test_gate_refused_tt_bucket_takes_the_subspace_route(monkeypatch):
    from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
    params = dict(create_model(
        "resnet32", generator=torch.Generator().manual_seed(0)).named_parameters())
    program = teng.build_program(params, get_rank_plan("resnet32", "tt", "3"))
    state = teng.admm_init(params, program)
    monkeypatch.setattr(teng, "tt_supported", lambda *a: False)
    refused, _ = teng.admm_update(params, state, program, update_u=False,
                                  method="kernel", n_iter=6)
    subspace, _ = teng.admm_update(params, state, program, update_u=False,
                                   method="subspace", n_iter=6)
    for n in program.names:
        assert torch.equal(refused.z[n], subspace.z[n]), n
