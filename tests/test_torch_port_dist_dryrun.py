"""The port's multi-rank dry run (`parallel/dryrun.py`, the counterpart
of `__graft_entry__.py::dryrun_multichip`) at 4 gloo ranks on the CPU, a
2 x 2 (data x layer) grid: the data-parallel X-step, the layer-sharded
Z/U step and the evaluation over data ranks through 2 ADMM epochs of
ResNet32 TK@3x, then an epoch streamed from DCTA shards split across the
data ranks. Each rank checks its losses and that all ranks hold the same
weights after each leg; the test reads every rank's histories."""

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.parallel.dryrun import dryrun_multichip
from dnn_compression_tensor_admm_tpu_torch.parallel.launch import (
    file_init_method, spawn)


def _rank(rank, world, init_method, out_dir):
    torch.save(dryrun_multichip(rank, world, init_method, "cpu"),
               f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def histories(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun4")
    spawn(_rank, 4, file_init_method(str(d)), str(d), timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


def test_dryrun_at_four_ranks_runs_every_leg(histories):
    for hist in histories:
        assert len(hist["leg1"]) == 2 and len(hist["leg2"]) == 1
        assert all(np.isfinite(h["train_loss"])
                   for h in hist["leg1"] + hist["leg2"])
        assert "test_acc1" in hist["leg1"][-1]
        assert hist["leg1"][-1]["admm_nonfinite_layers"] == 0


def test_dryrun_ranks_report_the_same_run(histories):
    """Every rank reads the global loss, residuals and eval, not its own
    slice's."""
    keys = ("train_loss", "train_acc", "admm_residual_total")
    for hist in histories[1:]:
        for leg in ("leg1", "leg2"):
            for a, b in zip(hist[leg], histories[0][leg]):
                assert {k: a[k] for k in keys if k in a} == \
                    {k: b[k] for k in keys if k in b}
        assert hist["leg1"][-1]["test_acc1"] == \
            histories[0]["leg1"][-1]["test_acc1"]
