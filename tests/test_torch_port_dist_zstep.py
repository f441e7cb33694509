"""The port's layer-sharded Z/U step (`admm_update(mesh=)`) on the CPU,
over gloo ranks in processes of their own (`torch_port_dist_workers.py`),
against the one-process step and the JAX package's mesh step.

A module fixture runs one job of 2 ranks and one of 3 (the uneven pad:
ResNet32's buckets hold 10, 1, 9, 1, 9 layers for TK@3x); each rank writes
its results to a file. Each rank runs the whole step on its own block of
each bucket (see `admm_update`): its layers must come out bit for bit as
the one-process step on that block alone computes them, and on the CPU
bit for bit as the one-process step on the whole stack does; the step
must make exactly three all-gathers a bucket, and match the JAX package's `admm_update` on a
1 x 2 mesh (run as `tests/test_dist.py` runs it) within the Z-step tests'
tolerance. The same jobs evaluate 52 images (an odd tail) over 2 and 3
data ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_workers as w
from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.configs.resolver import get_rank_plan as jax_plan
from dnn_compression_tensor_admm_tpu.parallel.mesh import make_mesh as jax_mesh
from dnn_compression_tensor_admm_tpu_torch.admm import engine as teng
from dnn_compression_tensor_admm_tpu_torch.ops.cuda.subspace_kernel import (
    dominant_left_subspace_batched)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda.tucker_kernel import (
    tucker2_factors_batched, tucker2_reconstruct)
from dnn_compression_tensor_admm_tpu_torch.parallel.launch import (
    file_init_method, spawn)
from dnn_compression_tensor_admm_tpu_torch.parallel.mesh import Mesh, make_mesh
from dnn_compression_tensor_admm_tpu_torch.train import evaluate_model
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import state_dict_to_jax

# the Z-step tests' tolerance for the same float32 iteration on both sides
# (tests/test_torch_port_ops.py, 'subspace'); the residuals as
# tests/test_torch_port_admm.py holds them
REL_TOL, RES_RTOL = 1e-4, 1e-3
WORLDS = (2, 3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}"""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"zstep{world}")
        spawn(w.zstep_job, world, file_init_method(str(d)), str(d),
              timeout=300)
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def one_process():
    """The one-process step (mesh=None) of each program the jobs ran."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the ranks
    try:
        out = {}
        for fmt, method, n_iter in (("tk", "kernel", 6), ("tt", "kernel", 6),
                                    ("tk", "subspace", 4)):
            params, program, state = w.zstep_inputs(fmt)
            s, r = teng.admm_update(params, state, program, update_u=True,
                                    method=method, n_iter=n_iter)
            out[fmt, method] = dict(z=s.z, u=s.u, res=r,
                                    nonfinite=int(s.nonfinite))
        model, x, y, info = w.eval_inputs()
        out["eval"] = evaluate_model(model, x, y, info,
                                     batch_size=w.EVAL_BATCH)
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fmt", ["tk", "tt"])
def test_sharded_zstep_equals_one_process_bit_for_bit(ranks, one_process,
                                                      world, fmt):
    ref = one_process[fmt, "kernel"]
    for r, got in enumerate(ranks[world]):
        got = got[fmt, "kernel"]
        assert got["nonfinite"] == ref["nonfinite"] == 0
        for n in ref["z"]:
            assert torch.equal(got["z"][n], ref["z"][n]), (r, n)
            assert torch.equal(got["u"][n], ref["u"][n]), (r, n)
            assert torch.equal(got["res"][n], ref["res"][n]), (r, n)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fmt", ["tk", "tt"])
def test_sharded_zstep_equals_one_process_on_its_block(ranks, world, fmt):
    """Each rank's layers against the one-process step run on the rank's
    block of every bucket alone: bit for bit, on the card too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the ranks
    try:
        for r, got in enumerate(ranks[world]):
            got = got[fmt, "kernel"]
            params, program, state = w.zstep_inputs(fmt)
            block = w.block_program(program, Mesh(1, world, r))
            assert 0 < len(block.names) < len(program.names)
            s, res = teng.admm_update(params, state, block, update_u=True,
                                      method="kernel", n_iter=6)
            for n in block.names:
                assert torch.equal(got["z"][n], s.z[n]), (r, n)
                assert torch.equal(got["u"][n], s.u[n]), (r, n)
                assert torch.equal(got["res"][n], res[n]), (r, n)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("world", WORLDS)
def test_three_all_gathers_per_bucket(ranks, world):
    for got in ranks[world]:
        for fmt in ("tk", "tt"):
            c = got[fmt, "kernel"]
            assert c["counts"] == {"all_reduce": 0, "broadcast": 0,
                                   "all_gather": 3 * c["buckets"]}, fmt


def test_sharded_zstep_matches_jax_mesh_step(ranks):
    """The port's 2-rank step against JAX's on a 1 x 2 mesh, both by the
    'subspace' method at n_iter 4 (tests/test_dist.py's run), from the
    same weights and duals."""
    params, program, state = w.zstep_inputs("tk")
    model_sd = {k: v.detach() for k, v in params.items()}
    jparams = state_dict_to_jax(model_sd)["params"]
    jprog = jeng.build_program(jparams, jax_plan("resnet32", "tk", "3"))
    hwio = lambda t: jnp.asarray(t.permute(2, 3, 1, 0).numpy())  # noqa: E731
    jstate = jeng.AdmmState(u={n: hwio(state.u[n]) for n in jprog.paths},
                            z={n: hwio(state.z[n]) for n in jprog.paths})
    mesh = jax_mesh(n_data=1, n_layer=2, devices=jax.devices()[:2])
    js, jr = jax.jit(functools.partial(
        jeng.admm_update, program=jprog, method="subspace", n_iter=4,
        mesh=mesh))(jparams, jstate)
    got = ranks[2][0]["tk", "subspace"]
    assert set(jr) == set(got["res"])
    for n in jr:
        for mine, theirs in ((got["z"][n], js.z[n]), (got["u"][n], js.u[n])):
            mine = mine.permute(2, 3, 1, 0).numpy()
            theirs = np.asarray(theirs)
            assert (np.linalg.norm(mine - theirs)
                    <= REL_TOL * max(np.linalg.norm(theirs), 1.0)), n
        np.testing.assert_allclose(float(got["res"][n]), float(jr[n]),
                                   rtol=RES_RTOL, err_msg=n)


@pytest.mark.parametrize("world", WORLDS)
def test_eval_over_ranks_counts_every_sample_once(ranks, one_process, world):
    """52 images in batches of 16 over 2 and 3 data ranks (26 / 18, 17, 17
    rows each, odd tails) give the one-process numbers: a sample counted
    twice or dropped would move the accuracy by ~2% and the loss."""
    ref = one_process["eval"]
    for got in ranks[world]:
        assert got["eval"]["acc1"] == pytest.approx(ref["acc1"], abs=1e-9)
        assert got["eval"]["acc5"] == pytest.approx(ref["acc5"], abs=1e-9)
        assert got["eval"]["loss"] == pytest.approx(ref["loss"], rel=1e-5)


def test_mesh_blocks_cover_each_bucket_once():
    for size in (1, 2, 3, 4):
        for layers in (1, 2, 5, 9, 10):
            blocks = [Mesh(1, size, r).block(layers) for r in range(size)]
            owned = [i for lo, hi, _ in blocks for i in range(lo, hi)]
            assert owned == list(range(layers)), (size, layers)
            assert {b for _, _, b in blocks} == {-(-layers // size)}


def test_layer_shards_that_do_not_divide_raise():
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(n_layer=2)  # one process: a world of 1
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(n_layer=0)


@torch.no_grad()
def test_plain_versions_map_a_zero_layer_to_a_finite_zero():
    """The padding of the JAX step relies on every projection mapping 0
    to 0; the port launches nothing for padding, and a layer of zeros
    still projects to a finite 0 (Newton-Schulz divides by a trace +
    1e-30)."""
    x = torch.zeros(2, 9, 16, 16)
    u0, u1 = tucker2_factors_batched(x, 8, 8, sweeps=2)
    z = tucker2_reconstruct(x, u0, u1)
    assert torch.isfinite(u0).all() and torch.isfinite(u1).all()
    assert torch.equal(z, torch.zeros_like(z))
    q = dominant_left_subspace_batched(torch.zeros(2, 48, 16), 8, iters=8)
    assert torch.isfinite(q).all()
