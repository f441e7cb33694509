"""The port's `analysis/` and numeric examples against the JAX package's:
the cost models equal over a grid of specs (exact integers), the
compression report key for key, activation spectra and feature ranks from
the same weights, the TT-LSTM cell and its demo's counts, and the three
numeric examples' numbers."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu import analysis as jan
from dnn_compression_tensor_admm_tpu.configs import hp as jhp
from dnn_compression_tensor_admm_tpu.configs.resolver import (
    get_rank_plan as jax_rank_plan)
from dnn_compression_tensor_admm_tpu.layers import TTConv2d as JaxTTConv2d
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.nlp.factorization import (
    tt_linear_spec_from_ratio as jax_tt_spec)
from dnn_compression_tensor_admm_tpu_torch import analysis as tan
from dnn_compression_tensor_admm_tpu_torch.configs import hp as thp
from dnn_compression_tensor_admm_tpu_torch.configs.resolver import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.examples import numeric_examples as tex
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import jax_to_state_dict
from torch_port_jax import seeded_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (tt shapes, ranks, out channels) of TT convs; (out, in) of TK convs;
# (shapes, ranks, out features) of TT linears
TT_CONVS = [((8, 4, 9, 4, 8), (1, 8, 16, 16, 8, 1), 32),
            ((16, 9, 16), (1, 12, 10, 1), 16),
            ((4, 4, 4, 1, 4, 4, 8), (1, 3, 5, 7, 7, 6, 4, 1), 64),
            ((64, 1, 32), (1, 20, 20, 1), 64)]
TK = [((16, 16), (64, 64, 3, 3)), ((40, 8), (128, 64, 3, 3)),
      ((500, 500), (32, 16, 1, 1)), ((3, 7), (256, 512, 5, 5))]
TT_LINEARS = [((8, 8, 8, 8), (1, 8, 10, 8, 1), 64),
              ((12, 16, 6, 8), (1, 6, 8, 6, 1), 192),
              ((4, 8, 8, 4, 6, 8), (1, 3, 9, 27, 9, 3, 1), 256)]
HW = [(8, 8), (32, 32), (7, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cost_functions_equal_the_jax_package():
    for shapes, ranks, out in TT_CONVS:
        for hw, in_hw in [(h, None) for h in HW] + [((4, 4), (8, 8))]:
            want = jan.tt_conv_cost(jhp.TTConvSpec.create(shapes, ranks, out),
                                    hw, in_hw)
            got = tan.tt_conv_cost(thp.TTConvSpec.create(shapes, ranks, out),
                                   hw, in_hw)
            assert got == want and all(type(v) is int for v in got)
    for (ro, ri), (o, i, kh, kw) in TK:
        for hw in HW:
            for in_hw in (None, (2 * hw[0], 2 * hw[1])):
                want = jan.tk_conv_cost(jhp.TKSpec(ro, ri), hw, i, o, kh, kw,
                                        in_hw)
                got = tan.tk_conv_cost(thp.TKSpec(ro, ri), hw, i, o, kh, kw,
                                       in_hw)
                assert got == want
            assert (tan.svd_conv_cost(thp.SVDSpec(ro), hw, i, o)
                    == jan.svd_conv_cost(jhp.SVDSpec(ro), hw, i, o))
            assert (tan.dense_conv_cost(hw, i, o, kh, kw)
                    == jan.dense_conv_cost(hw, i, o, kh, kw))
    for shapes, ranks, out in TT_LINEARS:
        assert (tan.tt_linear_cost(thp.TTLinearSpec.create(shapes, ranks, out))
                == jan.tt_linear_cost(jhp.TTLinearSpec.create(shapes, ranks,
                                                              out)))
    for i, o, r in [((4, 8, 8), (8, 8, 12), (1, 4, 4, 1)),
                    ((16, 16), (32, 24), (1, 9, 1))]:
        assert tan.ttm_linear_cost(i, o, r) == jan.ttm_linear_cost(i, o, r)
    assert tan.dense_linear_cost(768, 3072) == jan.dense_linear_cost(768, 3072)


def _carried(name, seed, **kw):
    """(JAX seeded variables, the port model carrying them)."""
    jm = jax_model(name, num_classes=10, **kw)
    v = seeded_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False), seed)
    tm = create_model(name, num_classes=10, **kw)
    tm.load_state_dict(jax_to_state_dict(v))
    return jm, v, tm


def test_model_compression_report_equals_the_jax_dict():
    _, dv, dense = _carried("resnet32", 0)
    _, cv, comp = _carried("tkc_resnet32", 1, ratio="3")
    want = jan.model_compression_report(dv, cv, jax_rank_plan("resnet32", "tk",
                                                              "3"))
    plan = get_rank_plan("resnet32", "tk", "3")
    assert tan.model_compression_report(dense, comp, plan) == want
    assert tan.model_compression_report(dense.state_dict(), comp.state_dict(),
                                        plan) == want
    assert 2.5 < want["targeted_ratio"] < 3.6


def test_activation_spectra_and_feature_ranks():
    """Same keys, letter for letter, values within 1e-4 relative; equal
    effective ranks, dense ResNet32 against TK@3x."""
    jm, v, tm = _carried("resnet20", 0)
    x = np.random.RandomState(3).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    xt = x.transpose(0, 3, 1, 2)
    want = jan.activation_spectra(jm, v, jnp.asarray(x), top_k=8)
    got = tan.activation_spectra(tm, xt, top_k=8)
    assert list(got) == list(want) and "layer1.0.layer1.0.conv1" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * float(want[k][0]), err_msg=k)
    jd, dv, td = _carried("resnet32", 1)
    jc, cv, tc = _carried("tkc_resnet32", 2, ratio="3")
    want = jan.compare_feature_ranks(jd, dv, jc, cv, jnp.asarray(x))
    assert tan.compare_feature_ranks(td, tc, xt) == want
    assert len(want) == 30


def test_tt_lstm_cell_step_and_scan():
    """One step and an 8-step scan from carried weights within 1e-5."""
    jcell = jan.TTLSTMCell(64, 32, compression_ratio=4.0)
    carry = jcell.init_carry(2)
    v = seeded_variables(lambda: jcell.init(jax.random.PRNGKey(0), carry,
                                            jnp.zeros((2, 64))))
    tcell = tan.TTLSTMCell(64, 32, compression_ratio=4.0)
    want = jax_tt_spec(64, 128, 4.0, dim=3)
    assert (tcell.wx.spec.tt_shapes, tcell.wx.spec.tt_ranks) == (
        want.tt_shapes, want.tt_ranks)
    tcell.load_state_dict(jax_to_state_dict(v))
    xs = np.random.RandomState(4).standard_normal((2, 8, 64)).astype(
        np.float32)
    (h, c), y = jcell.apply(v, carry, jnp.asarray(xs[:, 0]))
    with torch.no_grad():
        (th, tc), ty = tcell(tcell.init_carry(2), torch.from_numpy(xs[:, 0]))
    for a, b in ((th, h), (tc, c), (ty, y)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)

    def step(carry, x):
        return jcell.apply(v, carry, x)

    _, ys = jax.lax.scan(step, carry, jnp.swapaxes(jnp.asarray(xs), 0, 1))
    with torch.no_grad():
        tys = tan.tt_lstm.run_sequence(tcell, torch.from_numpy(xs))
    np.testing.assert_allclose(tys.numpy(), np.asarray(ys), rtol=1e-5,
                               atol=1e-5)


def test_tt_lstm_demo_counts():
    kw = dict(input_size=256, hidden_size=64, seq_len=4, batch=2, ratio=8.0,
              iters=1)
    want = jan.tt_lstm_inference_demo(**kw)
    got = tan.tt_lstm_inference_demo(**kw, device="cpu")
    assert set(got) == set(want)
    assert (got["params"], got["dense_wx_params"]) == (
        want["params"], want["dense_wx_params"])
    assert got["params"] < got["dense_wx_params"] and got["ms_per_sequence"] > 0


def _jax_examples():
    spec = importlib.util.spec_from_file_location(
        "jax_numeric_examples", os.path.join(ROOT, "examples",
                                             "numeric_examples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_numeric_examples_equal_the_jax_script(capsys):
    """Examples 2 and 3 print the JAX script's lines; example 1's layer
    on its inputs gives the JAX layer's output on the same inputs, and
    both equal the three manual computations."""
    jex = _jax_examples()
    for name in ("example2_general_tt_conv_costs", "example3_tt_fc_costs"):
        getattr(jex, name)()
        want = capsys.readouterr().out
        got = getattr(tex, name)()
        assert capsys.readouterr().out == want
        assert all(str(n) in want for n in got.values())
    r = tex.example1_order1_tt_conv(0, "cpu")
    assert r["max_abs_err"] < 1e-4
    O, I, r1, r2 = 32, 16, 10, 24
    spec = jhp.TTConvSpec.create((O, 9, I), (1, r2, r1, 1), out_channels=O)
    params = {"params": {"in_core_0": r["in_core"],
                         "core_kernel": r["core"].transpose(2, 3, 1, 0),
                         "out_core_0": r["out_core"],
                         "bias": np.zeros(O, np.float32)}}
    y = JaxTTConv2d(I, O, 3, spec, stride=1, padding=1).apply(
        params, jnp.asarray(r["x"].transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(r["y"], np.asarray(y).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
