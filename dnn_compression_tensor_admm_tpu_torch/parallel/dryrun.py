"""The whole multi-rank program at tiny shapes (counterpart of the JAX
package's `__graft_entry__.py::dryrun_multichip`): every leg a real
multi-rank launch runs but epoch fusion, which the port does not have.

    python -m dnn_compression_tensor_admm_tpu_torch.parallel.dryrun 4 --device cpu

starts 4 ranks on a data x layer grid (layer 2 where the count is even)
and runs, in each:

1. ADMM ResNet32 TK@3x for 2 epochs x 4 steps: the data-parallel X-step
   (global-batch BatchNorm, averaged gradients), the layer-sharded Z/U
   step, and the evaluation over the data ranks after epoch 2;
2. one epoch streamed from temporary DCTA shards, each data rank reading
   its own files (the loader's partition) and the global batch gathered.

Each leg checks that its losses are finite, that the evaluation ran, and
that every rank ends with the same weights.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..data.datasets import load_dataset
from ..data.records import write_shards
from ..train import TrainConfig, train_model
from . import dist
from .launch import file_init_method, spawn
from .mesh import make_mesh


def _check_replicated(model: torch.nn.Module) -> None:
    if not dist.same_on_every_rank(list(model.state_dict().values())):
        raise AssertionError("the ranks' weights differ")


def dryrun_multichip(rank: int, world: int, init_method: str,
                     device: str = "cpu") -> dict:
    """One rank of the dry run (see the module docstring); returns its
    histories."""
    torch.set_num_threads(1)
    topo = dist.init_distributed(device, init_method=init_method, rank=rank,
                                 world_size=world)
    n_layer = 2 if world % 2 == 0 else 1
    mesh = make_mesh(n_layer)
    common = dict(
        model="resnet32", dataset="synthetic-cifar10",
        batch_size=8 * mesh.n_data, lr=0.1, smoothing=0.1, admm=True,
        fmt="tk", ratio="3", admm_method="gram", admm_hooi_iters=2,
        compute_dtype=None, synthetic_size=256, device=str(topo.device),
        print_fn=lambda *a: None)
    out = {}
    try:
        # leg 1: data-parallel X-step, layer-sharded Z/U step, mesh eval
        model, hist = train_model(
            TrainConfig(epochs=2, steps_per_epoch=4, eval_every=2, **common),
            mesh=mesh)
        if len(hist) != 2 or not all(np.isfinite(h["train_loss"])
                                     for h in hist):
            raise AssertionError(f"leg 1: {hist}")
        if "test_acc1" not in hist[-1]:
            raise AssertionError("leg 1: the evaluation over ranks did not run")
        _check_replicated(model)
        out["leg1"] = hist
        # leg 2: streamed global batches from DCTA shards (each rank writes
        # the same files into a directory of its own)
        with tempfile.TemporaryDirectory() as d:
            x, y, _ = load_dataset("synthetic-cifar10", True, 128)
            write_shards(x, y, d, samples_per_shard=64, prefix="train")
            model, hist = train_model(
                TrainConfig(epochs=1, steps_per_epoch=2, shard_dir=d,
                            eval_every=10 ** 9, **common), mesh=mesh)
        if len(hist) != 1 or not np.isfinite(hist[0]["train_loss"]):
            raise AssertionError(f"leg 2: {hist}")
        _check_replicated(model)
        out["leg2"] = hist
    finally:
        dist.shutdown()
    return out


def _rank_main(rank: int, world: int, init_method: str, device: str) -> None:
    hist = dryrun_multichip(rank, world, init_method, device)
    if rank == 0:
        print({k: [round(h["train_loss"], 4) for h in v]
               for k, v in hist.items()}, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ranks", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        spawn(_rank_main, args.ranks, file_init_method(d), args.device)
    print(f"dryrun_multichip({args.ranks}) ok")


if __name__ == "__main__":
    main()
