"""The port's measurement harnesses (`dnn_compression_tensor_admm_tpu_torch/
bench/`) against the JAX package's `bench/`, on the CPU.

What is arithmetic is held equal to JAX's: `flops_encoder_fwd`, the text
`ab_args.summarize` prints, the Z/U step's work model on ResNet32 TK@3x's
buckets (whose layer counts equal the JAX `build_program`'s) and the
scaling harness's efficiencies. Each harness's measuring path runs once
at a tiny size (`deit_breakdown` at depth 2, batch 2, 32 x 32;
`zstep_ab` in one process; `ab_args.run_once` at 2 epochs x 2 steps):
each row has the JAX row's keys and finite positive times (a CPU time
checks the code, not the card). Without CUDA each entry point raises
unless given `--device cpu`. The 2-rank runs are in
`test_torch_port_bench_ranks.py`.
"""

import argparse
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from dnn_compression_tensor_admm_tpu.admm.engine import (
    build_program as jax_build_program)
from dnn_compression_tensor_admm_tpu.bench import ab_args as jax_ab
from dnn_compression_tensor_admm_tpu.bench import deit_breakdown as jax_db
from dnn_compression_tensor_admm_tpu.configs.resolver import (
    get_rank_plan as jax_plan)
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu_torch.admm import build_program
from dnn_compression_tensor_admm_tpu_torch.bench import (ab_args,
                                                         deit_breakdown,
                                                         scaling, zstep_ab)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.models import create_model

# the JAX rows' keys (`bench/deit_breakdown.py:98-258`,
# `bench/zstep_ab.py:80-83` and `:123-124` there)
DEIT_ROWS = ("fwd", "fwd_bwd", "fwd_bwd_train", "fwd_bwd_opt", "fwd_bwd_pen",
             "penalty_grad", "input_pipe", "matmul_proxy", "ln_softmax")
DEIT_DERIVED = ("bwd_only_ms", "penalty_in_step_ms", "fwd_matmul_tflops",
                "fwd_eff_tflops_per_s", "train_eff_tflops_per_s",
                "matmul_proxy_tflops_per_s")
ZSTEP_KEYS = {"n_layer_shards", "method", "z_step_ms", "layers",
              "slots_inflation", "real_latency_model_x"}
ISOLATED_KEYS = {"n_layer_shards", "method", "isolated", "z_step_ms",
                 "layers"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _finite_positive(x) -> bool:
    return math.isfinite(x) and x > 0


def test_flops_encoder_fwd_matches_jax():
    assert deit_breakdown.flops_encoder_fwd() == jax_db.flops_encoder_fwd()
    assert (deit_breakdown.flops_encoder_fwd(2, 5, 192, 2)
            == jax_db.flops_encoder_fwd(2, 5, 192, 2))
    assert deit_breakdown.Sizes().tokens == jax_db.TOKENS


def _ab_rows():
    """2 rounds x args / perm x 196 and 98 steps, in the rotating order,
    with fixed epoch times."""
    rows = []
    for rnd in range(2):
        for j, variant in enumerate(("args", "perm")[rnd:] + ("args", "perm")[:rnd]):
            for steps in (196, 98):
                base = 0.5 * steps / 196 + 0.01 * j + 0.003 * rnd
                rows.append({"round": rnd, "variant": variant, "steps": steps,
                             "epoch_times": [round(base * f, 4) for f in
                                             (1.9, 1.01, 0.99, 1.02, 1.0)],
                             "wall_s": 1.0})
    return rows


def test_ab_args_summarize_prints_what_jax_prints(capsys):
    args = argparse.Namespace(warmup=2, steps=196, slope=True,
                              variants=["args", "perm"])
    rows = _ab_rows()
    jax_ab.summarize(rows, args)
    want = capsys.readouterr().out
    ab_args.summarize(rows, args)
    got = capsys.readouterr().out
    assert got == want
    assert "two-point decomposition" in got and "perm     - args" in got


def test_ab_args_closure_raises():
    with pytest.raises(ValueError, match="closure"):
        ab_args.run_once("closure", 1, 1, device="cpu")
    with pytest.raises(ValueError, match="closure"):
        ab_args.main(["--variants", "args", "closure", "--device", "cpu"])


def test_zstep_work_model_on_the_buckets_matches_jax():
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    program = build_program(dict(model.named_parameters()),
                            get_rank_plan("resnet32", "tk", "3"))
    jm = jax_model("resnet32")
    params = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))["params"]
    jprogram = jax_build_program(params, jax_plan("resnet32", "tk", "3"))
    sizes = [len(g.names) for g in program.groups]
    assert sizes == [len(g.names) for g in jprogram.groups]
    assert sizes == [10, 1, 9, 1, 9]
    for n in (1, 2, 4, 8):
        # `bench/zstep_ab.py:75-79` of the JAX package
        slots = sum(n * math.ceil(l / n) for l in sizes)
        inflation = slots / sum(sizes)
        real_model = sum(sizes) / sum(math.ceil(l / n) for l in sizes)
        assert zstep_ab.work_model(sizes, n) == {
            "slots_inflation": round(inflation, 3),
            "real_latency_model_x": round(real_model, 2)}
    assert zstep_ab.work_model(sizes, 2) == {"slots_inflation": 1.133,
                                             "real_latency_model_x": 1.76}


def test_scaling_efficiencies_are_jaxs_arithmetic():
    results = [{"devices": 1, "images_per_s": 1000.0, "route": "eager"},
               {"devices": 1, "images_per_s": 1600.0, "route": "captured"},
               {"devices": 2, "images_per_s": 1300.0, "route": "eager"}]
    controls = {1: {"control_s": 0.010, "control_gflops_s": 1.0},
                2: {"control_s": 0.019, "control_gflops_s": 2.0}}
    steps = {1: {"control_step_s": 0.040}, 2: {"control_step_s": 0.070}}
    out = scaling.efficiencies([dict(r) for r in results], controls, steps,
                               results[0])
    for r, got in zip(results, out):
        # `bench/scaling.py:172-191` of the JAX package, base = the 1-rank
        # eager row
        raw = (r["images_per_s"] / 1000.0) / (r["devices"] / 1)
        host = 0.010 / controls[r["devices"]]["control_s"]
        step = 0.040 / steps[r["devices"]]["control_step_s"]
        assert got["scaling_efficiency_vs_1dev"] == round(raw, 3)
        assert got["host_artifact_efficiency"] == round(host, 3)
        assert got["step_control_artifact_efficiency"] == round(step, 3)
        assert got["corrected_efficiency"] == round(raw / step, 3)
        assert got["corrected_efficiency_matmul_ctl"] == round(raw / host, 3)
        assert got["control_gflops_s"] == controls[r["devices"]]["control_gflops_s"]
    assert out[2]["scaling_efficiency_vs_1dev"] == 0.65
    assert out[2]["corrected_efficiency"] == round(0.65 / (0.04 / 0.07), 3)
    assert [scaling.n_layer_of(n, True) for n in (1, 2, 3, 4)] == [1, 2, 1, 2]
    assert scaling.n_layer_of(2, False) == 1


def test_deit_breakdown_runs_on_the_cpu():
    out = deit_breakdown.breakdown("cpu", deit_breakdown.Sizes(
        batch=2, img=32, depth=2, pipe_images=8))
    assert tuple(out["ms"]) == DEIT_ROWS
    assert all(_finite_positive(v) for v in out["ms"].values()), out["ms"]
    assert tuple(out["derived"]) == DEIT_DERIVED
    assert tuple(out["spread_ms"]) == DEIT_ROWS and out["repeats"] == 3
    assert all(v >= 0 for v in out["spread_ms"].values())
    assert out["card"] is None and out["backend"] == "cpu"
    assert out["sizes"]["tokens"] == 5 and out["batch"] == 2
    shares = out["shares_of_step"]
    parts = ("forward", "backward", "drop_path", "penalty", "optimizer",
             "input_pipeline")
    assert sum(shares[f"{p}_share"] for p in parts) == pytest.approx(1.0,
                                                                      abs=1e-3)


def test_step_shares():
    ms = {"fwd": 2.0, "fwd_bwd": 6.0, "fwd_bwd_train": 6.5, "fwd_bwd_pen": 7.0,
          "fwd_bwd_opt": 7.5, "input_pipe": 1.0, "matmul_proxy": 1.0}
    spread = {"fwd": 0.1, "fwd_bwd": 0.25, "fwd_bwd_train": 0.25,
              "fwd_bwd_pen": 0.5, "fwd_bwd_opt": 0.5, "input_pipe": 0.0,
              "matmul_proxy": 0.0}
    got = deit_breakdown.step_shares(ms, spread)
    assert got["step_ms"] == 2.0 + 4.0 + 0.5 + 1.0 + 1.5 + 1.0
    assert got["backward_share"] == 4.0 / 10.0
    assert got["matmul_ceiling_ms"] == 3.0
    # a part is a difference of two rows: their spreads add
    assert got["backward_spread_ms"] == 0.35
    assert got["drop_path_spread_ms"] == 0.5
    assert [got[f"{k}_resolved"] for k in deit_breakdown.PARTS] == [
        True, True, False, True, True, True]
    assert got["penalty_spread_ms"] == 0.75


def test_zstep_ab_measures_on_the_cpu():
    row = zstep_ab.measure(1, method="ns", iters=1, device="cpu")
    assert ZSTEP_KEYS <= set(row) and _finite_positive(row["z_step_ms"])
    assert row["layers"] == 30 and row["nonfinite"] == 0
    assert row["warmups"] >= zstep_ab.WARMUPS
    assert isinstance(row["steady"], bool)
    assert "ranks" not in row and row["card"] is None
    row = zstep_ab.measure_isolated(1, layers=4, ch=16, device="cpu")
    assert ISOLATED_KEYS <= set(row) and _finite_positive(row["z_step_ms"])
    assert row["block_layers_per_rank"] == [4]


def test_ab_args_run_once_on_the_cpu():
    for variant in ("args", "perm"):
        times = ab_args.run_once(variant, 2, 2, batch_size=8,
                                 synthetic_size=64, device="cpu")
        assert len(times) == 2 and all(_finite_positive(t) for t in times)


@pytest.mark.parametrize("main, argv", [
    (deit_breakdown.main, []),
    (zstep_ab.main, ["1"]),
    (ab_args.main, ["--rounds", "1"]),
    (scaling.main, ["1"]),
], ids=["deit_breakdown", "zstep_ab", "ab_args", "scaling"])
def test_entry_points_want_the_card(main, argv):
    if torch.cuda.is_available():
        pytest.skip("this checks the path taken without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
