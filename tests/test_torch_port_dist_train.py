"""The port's data-parallel X-step on the CPU, over 2 gloo ranks in
processes of their own (`torch_port_dist_workers.py`), against the JAX
package's X-step on a 'data'-sharded batch and against the port's own
one-process run; and the shard loader's partition across data ranks.

A module fixture runs one 2-rank job: one X-step of ResNet32 TK@3x with
the ADMM penalty and BatchNorm over the global batch (each rank holds 4 of
its 8 rows), then 2 epochs of `train_model` (ResNet20 TK@3x, float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_dist_workers as w
from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.models import create_model as jax_model
from dnn_compression_tensor_admm_tpu.parallel.mesh import make_mesh as jax_mesh
from dnn_compression_tensor_admm_tpu.train.losses import cross_entropy as jax_ce
from dnn_compression_tensor_admm_tpu.train.optim import make_optimizer, make_schedule
from dnn_compression_tensor_admm_tpu_torch.data import native_loader as nl
from dnn_compression_tensor_admm_tpu_torch.data import records
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.models.vit import BatchRows, drop_path
from dnn_compression_tensor_admm_tpu_torch.parallel.dist import partition_shard_paths
from dnn_compression_tensor_admm_tpu_torch.parallel.launch import (
    file_init_method, spawn)
from dnn_compression_tensor_admm_tpu_torch.train import train_model
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import state_dict_to_jax

# The 1-rank and 2-rank runs differ in the order of their reductions (the
# gradient's mean over two halves, BatchNorm's one-pass global statistics
# against torch's two-pass ones). At this random init a float32 X-step
# gradient is itself only good to ~0.5% (tests/test_torch_port_slice.py),
# and one step moves the 2-rank update 0.25% from the 1-rank one: so the
# weights' changes over the run are held to 1% of their size, as the
# slice test holds one step's, and the losses, residuals and eval numbers,
# which average over many such values, to 1e-5 (6e-7, 3e-8 and 2.4e-6
# seen).
RUN_RTOL, UPDATE_RTOL = 1e-5, 1e-2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("train2")
    spawn(w.train_job, 2, file_init_method(str(d)), str(d), timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's X-step on the same 8 rows sharded over a 2 x 1
    mesh's 'data' axis: loss, parameters before and after, bn1's
    running mean."""
    model, program, state, x, y = w.xstep_inputs()
    v = state_dict_to_jax(model.state_dict())
    jprog = jeng.build_program(v["params"], jax_plan("resnet32", "tk", "3"))
    hwio = lambda t: jnp.asarray(t.permute(2, 3, 1, 0).numpy())  # noqa: E731
    js = jeng.AdmmState(u={n: hwio(state.u[n]) for n in jprog.paths},
                        z={n: hwio(state.z[n]) for n in jprog.paths})
    mesh = jax_mesh(n_data=2, n_layer=1, devices=jax.devices()[:2])
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    ys = jax.device_put(jnp.asarray(y.astype(np.int32)),
                        NamedSharding(mesh, P("data")))
    jm = jax_model("resnet32", num_classes=10)

    def loss_fn(p, xb, yb):
        logits, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               xb, train=True, mutable=["batch_stats"])
        return (jax_ce(logits, yb, w.SMOOTHING)
                + jeng.admm_penalty(p, js, jprog, w.RHO)), mut

    (loss, mut), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], xs, ys)
    tx = make_optimizer("momentum", make_schedule("cosine", w.LR, 1, 1,
                                                  min_lr=1e-5))
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    return dict(loss=float(loss), before=v["params"],
                after=optax.apply_updates(v["params"], upd),
                bn_mean=np.asarray(mut["batch_stats"]["bn1"]["mean"]))


def test_data_parallel_x_step_matches_jax_sharded_step(ranks, jax_step):
    """Loss, update and BatchNorm statistics to the first slice test's
    float32 tolerances (tests/test_torch_port_slice.py)."""
    (loss0, after0, mean0), (loss1, after1, mean1) = (r["xstep"] for r in ranks)
    # each rank's loss is its rows' mean plus the penalty
    np.testing.assert_allclose((loss0 + loss1) / 2, jax_step["loss"],
                               rtol=1e-5)
    for n in after0:  # the ranks step alike
        assert torch.equal(after0[n], after1[n]), n
    assert torch.equal(mean0, mean1)
    back = state_dict_to_jax(after0)["params"]
    flat = [jax.tree_util.tree_flatten_with_path(t)[0]
            for t in (jax_step["before"], jax_step["after"], back)]
    for (p, w0), (_, wj), (_, wt) in zip(*flat):
        dj, dt = np.asarray(wj) - np.asarray(w0), wt - np.asarray(w0)
        assert np.linalg.norm(dt - dj) <= 1e-2 * np.linalg.norm(dj), str(p)
    np.testing.assert_allclose(mean0.numpy(), jax_step["bn_mean"], rtol=1e-4,
                               atol=1e-6)


def test_two_rank_run_matches_one_rank_run(ranks):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the ranks
    try:
        model, hist = train_model(w.train_config())
    finally:
        torch.set_num_threads(threads)
    ref_sd = model.state_dict()
    init = create_model("resnet20", num_classes=10,
                        generator=torch.Generator().manual_seed(0)).state_dict()
    for r, got in enumerate(ranks):
        got_hist, got_sd = got["train"]
        assert len(got_hist) == len(hist) == 2
        for a, b in zip(got_hist, hist):
            assert a["train_loss"] == pytest.approx(b["train_loss"],
                                                    rel=RUN_RTOL), r
            assert a["admm_nonfinite_layers"] == 0
            for n, res in b["admm_residuals"].items():
                assert a["admm_residuals"][n] == pytest.approx(
                    res, rel=RUN_RTOL), (r, n)
        assert got_hist[-1]["test_acc1"] == hist[-1]["test_acc1"]
        assert got_hist[-1]["test_loss"] == pytest.approx(
            hist[-1]["test_loss"], rel=RUN_RTOL)
        for n, t in ref_sd.items():
            if t.is_floating_point():
                d1, d2 = t - init[n], got_sd[n] - init[n]
                assert (torch.linalg.vector_norm(d2 - d1)
                        <= UPDATE_RTOL * torch.linalg.vector_norm(d1)), n
            else:
                assert torch.equal(got_sd[n], t), n


def test_ranks_end_with_the_same_weights(ranks):
    (_, sd0), (_, sd1) = (r["train"] for r in ranks)
    for n in sd0:
        assert torch.equal(sd0[n], sd1[n]), n


def test_layer_shards_that_do_not_divide_the_world_raise(ranks):
    for got in ranks:
        assert "--layer-shards 3 does not divide the 2 ranks" in got["refused"]


def test_drop_path_of_a_rank_keeps_its_rows_of_the_global_masks():
    """A data-parallel step passes drop path a `BatchRows`: two ranks'
    halves of a batch of 8 come out as the one-process batch does."""
    x = torch.randn(8, 5, 4, generator=torch.Generator().manual_seed(0))
    whole = drop_path(x, 0.5, torch.Generator().manual_seed(1))
    halves = [drop_path(x[lo:lo + 4], 0.5,
                        BatchRows(torch.Generator().manual_seed(1), 8, lo))
              for lo in (0, 4)]
    assert torch.equal(torch.cat(halves), whole)
    dropped = (whole == 0).all(dim=(1, 2))
    assert dropped.any() and not dropped.all()


def _loader_ids(paths, batch, stride, offset):
    loader = nl.NativeLoader(paths, batch, workers=2, seed=5, stride=stride,
                             offset=offset)
    try:
        return [int(i) for _, y, n in loader for i in y[:n]]
    finally:
        loader.close()


@pytest.mark.parametrize("files", [1, 4])
def test_shard_partition_is_disjoint_and_covers_an_epoch(tmp_path, files):
    """Two data ranks' loaders over 40 records (labels 0..39) in 1 file
    (strided rows of the global index) or 4 (files round-robin)."""
    n = 40
    images = np.zeros((n, 2, 2, 3), np.uint8)
    paths = records.write_shards(images, np.arange(n, dtype=np.int32),
                                 str(tmp_path), samples_per_shard=n // files,
                                 prefix="train")
    seen = []
    for rank in range(2):
        p, seed, stride, offset = partition_shard_paths(paths, rank, 2, 5)
        assert (stride, offset) == ((2, rank) if files == 1 else (1, 0))
        seen.append(_loader_ids(p, 4, stride, offset))
    assert len(seen[0]) == len(seen[1]) == n // 2
    assert not set(seen[0]) & set(seen[1])
    assert sorted(seen[0] + seen[1]) == list(range(n))
    assert partition_shard_paths(paths, 0, 1, 5) == (paths, 5, 1, 0)
