"""The port's multi-rank harnesses (`bench/zstep_ab.py`, `bench/scaling.py`)
on 2 gloo ranks on the CPU, in one spawn (`parallel/launch.py::run_jobs`):
the layer-sharded Z/U step of ResNet32 TK@3x, `train_model` of ResNet20
TK@3x on a 1 x 2 mesh, and both controls at small sizes. The 1-rank
rows run in this process; the scaling rows then go through the
efficiency arithmetic with the 1-rank eager row as the base. Each row has
the JAX row's keys (`bench/zstep_ab.py:80-83`, `bench/scaling.py:59-62`
and `:97-98`, `:150` there), its ranks, backend and GPUs, and finite
positive times (a CPU time checks the code, not the card).
"""

import math

import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.bench import scaling, zstep_ab
from dnn_compression_tensor_admm_tpu_torch.parallel.launch import run_jobs

ZSTEP_KEYS = {"n_layer_shards", "method", "z_step_ms", "layers",
              "slots_inflation", "real_latency_model_x"}
SCALING_KEYS = {"devices", "mesh", "admm", "global_batch", "steps_per_s",
                "images_per_s"}
# small controls: a 64 x 64 chain, ResNet20 at 2 images a rank
CONTROL = dict(size=64, iters=2, reps=2)
CONTROL_STEP = dict(batch_per_device=2, iters=1, reps=1)
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here and in the ranks (they take this process's
    count): the tests share the CPU with other pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jobs(n):
    jobs = [scaling.control_job(n, **CONTROL),
            scaling.control_step_job(n, **CONTROL_STEP),
            scaling.train_job(n, steps=STEPS, device="cpu")]
    if n == 1:
        jobs.append(scaling.train_job(1, steps=STEPS, eager=True,
                                      device="cpu"))
    else:
        jobs.append(zstep_ab.zstep_job(n, method="ns", iters=1,
                                       device="cpu"))
    return jobs


@pytest.fixture(scope="module")
def rows():
    """{1: [control, step control, captured-route row, eager row],
    2: [control, step control, train row, Z/U row]}"""
    return {n: run_jobs(_jobs(n), n, "cpu", timeout=300) for n in (1, 2)}


def _finite_positive(x) -> bool:
    return math.isfinite(x) and x > 0


def test_sharded_zstep_row(rows):
    row = rows[2][3]
    assert ZSTEP_KEYS <= set(row)
    assert (row["ranks"], row["backend"], row["gpus_visible"]) == (2, "gloo", 0)
    assert row["n_layer_shards"] == 2 and row["layers"] == 30
    assert row["slots_inflation"] == 1.133 and row["real_latency_model_x"] == 1.76
    assert len(row["z_step_ms_per_rank"]) == 2
    assert all(_finite_positive(t) for t in row["z_step_ms_per_rank"])
    assert row["z_step_ms"] == round(max(row["z_step_ms_per_rank"]), 2)
    assert row["nonfinite"] == 0 and row["card"] is None
    assert row["warmups"] >= zstep_ab.WARMUPS
    # no kernel launches on the CPU: the wrappers run their plain versions
    assert row["launches_per_z_step_per_rank"] == [
        {"tucker2": 0.0, "subspace": 0.0}] * 2


def test_scaling_rows_and_efficiencies(rows):
    one, two = rows[1], rows[2]
    train = [one[2], one[3], two[2]]
    for r in train:
        assert SCALING_KEYS <= set(r) and r["route"] == "eager"
        assert _finite_positive(r["images_per_s"])
        assert r["images_per_s"] == pytest.approx(
            r["steps_per_s"] * r["global_batch"])
    assert two[2]["mesh"] == [1, 2] and two[2]["global_batch"] == 32
    assert (two[2]["ranks"], two[2]["backend"]) == (2, "gloo")
    assert one[2]["mesh"] == [1, 1] and "ranks" not in one[2]
    for n, (c, s) in ((1, one[:2]), (2, two[:2])):
        assert c["devices"] == s["devices"] == n
        assert len(c["control_s_per_rank"]) == n
        assert _finite_positive(c["control_s"])
        assert _finite_positive(s["control_step_s"])
    out = scaling.efficiencies(train, {1: one[0], 2: two[0]},
                               {1: one[1], 2: two[1]}, base=one[3])
    assert out[1]["scaling_efficiency_vs_1dev"] == 1.0
    for r in out:
        for k in ("scaling_efficiency_vs_1dev", "host_artifact_efficiency",
                  "step_control_artifact_efficiency", "corrected_efficiency",
                  "corrected_efficiency_matmul_ctl"):
            assert _finite_positive(r[k]), (k, r)
