"""Dominant-subspace kernel of the PyTorch port against the Pallas kernel.

The port's plain version (what its wrapper runs for a CPU tensor) and its
batched TT-SVD sweep are held against the JAX package's
`dominant_left_subspace_batched` and `tt_project_batched` in Pallas
interpret mode, on the same numpy inputs. The CUDA kernel itself is held
against the plain version on the card by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.ops.pallas import (
    dominant_left_subspace_batched as jax_subspace,
    tt_project_batched as jax_tt_project)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Both sides run the same float32 iteration (8 orthogonal-iteration steps,
# each with 12 Newton-Schulz steps); they differ in summation order only,
# a few 1e-6 relative after the iteration's dependent products.
REL_TOL = 1e-5

# the 24 launches of one ResNet32-TT@3x Z-step: [L, rows, cols], r
MAIN_PATH_LAUNCHES = [
    ((10, 144, 16), 16),
    ((1, 288, 16), 16), ((1, 64, 4), 4),
    ((9, 32, 288), 16), ((9, 144, 32), 16), ((9, 64, 8), 8),
    ((1, 64, 288), 40), ((1, 360, 32), 24), ((1, 96, 8), 8),
    ((4, 64, 576), 27), ((4, 243, 64), 27), ((4, 216, 8), 8),
    ((2, 64, 576), 28), ((2, 252, 64), 28), ((2, 224, 8), 8),
    ((1, 64, 576), 29), ((1, 261, 64), 29), ((1, 232, 8), 8),
    ((1, 64, 576), 24), ((1, 216, 64), 24), ((1, 192, 8), 8),
    ((1, 64, 576), 15), ((1, 135, 64), 15), ((1, 120, 8), 8),
]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("L,rows,cols,r", [
    (3, 24, 40, 5),     # wide: Gram of the rows
    (3, 40, 24, 5),     # tall: Gram of the columns, then the lift
    (2, 32, 288, 16),   # slice shapes, small L
    (2, 144, 32, 16),
    (2, 64, 8, 8),      # tall, full rank in the columns
    (2, 8, 64, 8),      # full rank: the identity
])
def test_plain_matches_pallas_interpret(L, rows, cols, r):
    t = np.random.RandomState(rows * 7 + cols).standard_normal(
        (L, rows, cols)).astype(np.float32)
    q_j = np.asarray(jax_subspace(jnp.asarray(t), r, iters=8, interpret=True))
    q_t = sk.dominant_left_subspace_batched(torch.from_numpy(t), r, iters=8)
    assert q_t.shape == (L, rows, min(r, rows, cols))
    assert _rel(q_t.numpy(), q_j) < REL_TOL
    # and the projected slices agree
    p_t = q_t @ q_t.mT @ torch.from_numpy(t)
    p_j = np.einsum("lik,ljk,ljc->lic", q_j, q_j, t)
    assert _rel(p_t.numpy(), p_j) < REL_TOL


@pytest.mark.parametrize("shapes,ranks", [
    ([4, 6, 9, 5, 4], [1, 3, 6, 6, 3, 1]),   # order-5 general TT conv
    ([24, 9, 16], [1, 8, 6, 1]),              # special TT conv [O, 9, I]
    ([8, 8, 6, 4], [1, 4, 8, 3, 1]),          # TT linear shapes
])
def test_tt_project_batched_matches_pallas_interpret(shapes, ranks):
    numel = int(np.prod(shapes))
    x = np.random.RandomState(numel).standard_normal((3, numel)).astype(
        np.float32)
    assert sk.tt_supported(3, numel, shapes, ranks)
    z_j = np.asarray(jax_tt_project(jnp.asarray(x), shapes, ranks, iters=8,
                                    interpret=True))
    z_t = sk.tt_project_batched(torch.from_numpy(x), shapes, ranks, iters=8)
    assert z_t.shape == x.shape
    assert _rel(z_t.numpy(), z_j) < REL_TOL


def test_tt_project_batched_exact_on_tt_rank_input():
    rng = np.random.RandomState(3)
    g1 = rng.standard_normal((2, 6, 4))
    g2 = rng.standard_normal((2, 4, 9, 4))
    g3 = rng.standard_normal((2, 4, 8))
    x = np.einsum("lar,lrbs,lsc->labc", g1, g2, g3).reshape(2, -1)
    z = sk.tt_project_batched(torch.from_numpy(x.astype(np.float32)),
                              [6, 9, 8], [1, 4, 4, 1])
    # an input of TT rank (4, 4) is its own projection, up to the
    # Newton-Schulz ridge (1e-6 of the trace) and float32 rounding
    assert _rel(z.numpy(), x) < 1e-3


def test_shared_memory_gates_on_main_path_launches():
    # floats: the padded plan mp^2 + mp rp + yp rp + 5 rp^2 (m = min(rows,
    # cols), m, r and rows rounded up to 4), or the Gram plus two chunks of
    # STAGE_LEN along the long side where that is larger; the compiled
    # library reports the same plan on the card (chip_smoke.py)
    got = [sk.smem_bytes(s[1], s[2], r) for s, r in MAIN_PATH_LAUNCHES]
    assert got[:3] == [4 * (256 + 256 + 144 * 16 + 5 * 256),
                       4 * (256 + 256 + 288 * 16 + 5 * 256),
                       4 * (16 + 2 * (4 + 4) * 64)]  # [1, 64, 4]: the chunks
    # [1, 261, 64] at rank 29, padded to 32 and 264 rows
    assert max(got) == 4 * (64 * 64 + 64 * 32 + 264 * 32 + 5 * 32 * 32) == 78848
    assert sum(b > 48 * 1024 for b in got) == 12  # the launcher opts in
    assert all(sk.subspace_supported(s, r) for s, r in MAIN_PATH_LAUNCHES)
    # a Gram of 1 MiB fits no block: the workspace plan takes it
    assert not sk.block_plan_fits(720, 512, 128)
    assert sk.subspace_supported((1, 720, 512), 128)
    # the workspace plan's Gram chunks hold one row of at most ~29,000
    assert not sk.subspace_supported((1, 30_000, 30_000), 8)
    assert not sk.subspace_supported((4, 64, 8, 8), 4)    # not [L, rows, cols]
    assert not sk.tt_supported(2, 100, [4, 5, 6], [1, 4, 4, 1])  # numel
    assert sk.tt_supported(9, 32 * 32 * 9, [8, 4, 9, 4, 8],
                           [1, 8, 16, 16, 8, 1])


def test_main_path_takes_the_padded_plan_and_near_cap_shapes_do_not():
    assert all(sk.padded_plan(s[1], s[2], r) for s, r in MAIN_PATH_LAUNCHES)
    # chip_smoke.py's near-cap launches: the unpadded plan fits a block's
    # 58,112 floats, the padded one (196 x 196 Gram, rank 36) does not
    for rows, cols in [(193, 197), (197, 193)]:
        assert sk.subspace_supported((2, rows, cols), 33)
        assert not sk.padded_plan(rows, cols, 33)
        assert sk.smem_bytes(rows, cols, 33) == 232_448


def _unpadded_plan_fits(rows, cols, r):
    """The first version's gate: its unpadded plan within a block's 227 KB."""
    m = min(rows, cols)
    return 4 * (m * m + m * r + rows * r + 5 * r * r) <= 232_448


@pytest.mark.parametrize("rows", [4, 5, 7, 16, 33, 64, 99, 128, 200, 241,
                                  256, 513, 1024])
def test_gate_accepts_exactly_the_shapes_the_unpadded_plan_fits(rows):
    # the padded plan and the Gram's chunks may grow a block's shared memory,
    # but only where it has room: no shape the unpadded plan fits is refused
    # a block plan; every other shape takes the workspace plan
    for cols in [*range(4, 1025, 3), 1024]:
        m = min(rows, cols)
        top = min(m, rows - 1)  # r < rows (r == rows does not launch)
        # every rank up to 64, a sample above, and the ranks around the
        # unpadded plan's limit (5 r^2 + (m + rows) r + m^2 = 58112)
        disc = (m + rows) ** 2 - 20 * (m * m - 232_448 // 4)
        edge = int((-(m + rows) + max(disc, 0) ** 0.5) / 10)
        ranks = {*range(1, min(top, 64) + 1), *range(64, top + 1, 37),
                 *range(edge - 1, edge + 3), top}
        for r in sorted(x for x in ranks if 1 <= x <= top):
            fits = _unpadded_plan_fits(rows, cols, r)
            assert sk.block_plan_fits(rows, cols, r) == fits, (rows, cols, r)
            assert sk.subspace_supported((1, rows, cols), r), (rows, cols, r)


def test_main_path_launch_list_and_bound():
    from dnn_compression_tensor_admm_tpu_torch.admm import build_program
    from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
    from dnn_compression_tensor_admm_tpu_torch.models import create_model
    params = dict(create_model("resnet32").named_parameters())
    program = build_program(params, get_rank_plan("resnet32", "tt", "3"))
    launches = [((len(g.names), rows, cols), r) for g in program.groups
                for rows, cols, r in sk.sweep_steps(g.spec.tt_shapes,
                                                    g.spec.tt_ranks)
                if r != rows]
    assert sorted(launches) == sorted(MAIN_PATH_LAUNCHES)
    flops = sum(sk.subspace_flops(s, r, iters=8) for s, r in launches)
    nbytes = sum(4 * (l * rows * cols + l * rows * r)
                 for (l, rows, cols), r in launches)
    # about 0.49 GFLOP and 3.3 MB per Z-step: ~7.4 us at 67 TFLOP/s float32
    # (3.35 TB/s would move the bytes in ~1 us): bound by operations
    assert 0.48e9 < flops < 0.50e9 and 3.2e6 < nbytes < 3.4e6
    assert sk.subspace_flops((2, 8, 64), 8, iters=8) == 0  # full rank
    # wide case by hand: Gram + 8 x (G Q, Y^T Y, Newton-Schulz, Y S^-1/2)
    assert sk.subspace_flops((1, 4, 10), 2, iters=1) == (
        2 * 4 * 4 * 10 + 2 * 4 * 4 * 2 + 2 * 4 * 2 * 2 + 12 * 3 * 2 * 8
        + 2 * 4 * 2 * 2)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 8, 8, dtype=torch.float64), TypeError),
    (torch.zeros(2, 8, 16).transpose(1, 2), ValueError),
    (torch.zeros(8, 8), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        sk.dominant_left_subspace_batched(bad, 4)


def test_cpu_and_full_rank_calls_count_no_launch():
    before = sk.dominant_left_subspace_batched.launches
    t = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 12, 20)).astype(np.float32))
    q = sk.dominant_left_subspace_batched(t, 3)
    assert torch.equal(q, sk.dominant_left_subspace_plain(t, 3, iters=8))
    eye = sk.dominant_left_subspace_batched(t, 12)
    assert torch.equal(eye, torch.eye(12).expand(2, 12, 12))
    assert sk.dominant_left_subspace_batched.launches == before


# the 13 workspace launches of a DeiT-tiny TT@2x Z-step, in sweep order:
# [L, rows, cols], r, and their plan (`ws_plan`): blocks per layer, shared
# floats of each block, floats of each stage buffer; every region of every
# one fits in shared memory, so none has a slab
DEIT_WORKSPACE_LAUNCHES = [
    ((1, 180, 192), 96, 8, 49248, 17280),
    ((1, 528, 192), 96, 8, 58112, 19456),
    ((1, 720, 192), 96, 8, 58112, 18304),
    ((1, 180, 768), 96, 8, 49248, 17280),
    ((1, 2304, 32), 30, 8, 30592, 10240),
    ((11, 144, 192), 96, 8, 40128, 13824),
    ((1, 480, 192), 96, 8, 58112, 19840),
    ((1, 672, 192), 96, 8, 58112, 18688),
    ((1, 144, 768), 96, 8, 40128, 13824),
    ((1, 2304, 32), 28, 8, 29088, 10112),
    ((10, 384, 192), 96, 8, 58112, 20416),
    ((10, 528, 192), 96, 8, 58112, 19456),
    ((10, 144, 768), 96, 8, 40128, 13824),
]


def test_deit_workspace_launches_take_the_cluster_plan():
    from dnn_compression_tensor_admm_tpu_torch.admm import build_program
    from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
    from dnn_compression_tensor_admm_tpu_torch.models import create_model
    name = "deit_tiny_patch16_224"
    params = dict(create_model(name).named_parameters())
    program = build_program(params, get_rank_plan(name, "tt", "2"))
    launches = [((len(g.names), rows, cols), r) for g in program.groups
                for rows, cols, r in sk.sweep_steps(g.spec.tt_shapes,
                                                    g.spec.tt_ranks)
                if r != rows]
    assert len(launches) == 33
    ws = [(s, r) for s, r in launches if sk.plan_name(s[1], s[2], r)
          == "workspace"]
    assert ws == [(s, r) for s, r, *_ in DEIT_WORKSPACE_LAUNCHES]
    for (l, rows, cols), r, cluster, smem, stage in DEIT_WORKSPACE_LAUNCHES:
        p = sk.ws_plan(rows, cols, r)
        assert (p.cluster, p.smem_floats, p.ws_floats, p.in_ws, p.stage) == (
            cluster, smem, 0, (), stage)
        assert sk.subspace_supported((l, rows, cols), r)
        # a launch fills l x C SMs (at most 88 of 132), one cluster a layer
        assert l * cluster <= 132


def _up4(x):
    return (x + 3) // 4 * 4


WS_SHAPES = [(144, 192, 96), (720, 192, 96), (2304, 32, 30), (3600, 64, 16),
             (300, 320, 106), (260, 176, 174), (5120, 24, 22),
             (2048, 512, 130), (1890, 512, 210), (352, 1536, 320),
             (10240, 48, 42), (512, 4608, 250)]


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_workspace_plan_regions_fit_and_are_aligned(cluster):
    # the TT plans' widest workspace launches (DeiT-small, ResNet18 and 50)
    # and the emulation's shapes
    for rows, cols, r in WS_SHAPES:
        assert not sk.block_plan_fits(rows, cols, r)
        p = sk.ws_plan(rows, cols, r, cluster)
        assert p.cluster == (cluster or sk.WS_CLUSTER)
        assert p.smem_floats <= sk.MAX_SMEM_BYTES // 4
        assert p.ws_floats % 4 == 0 and p.stage % 4 == 0 and p.stage >= p.ldc
        assert 2 * p.stage <= p.smem_floats
        assert set(p.in_ws) <= set(sk.WS_REGIONS)
        # the partial S and the trace's diagonal share the scratch region
        rp = _up4(r)
        assert "sp" in p.in_ws or p.smem_floats >= rp * rp + rp


def test_workspace_launch_raises_on_a_cluster_the_card_refuses(monkeypatch):
    # no card here: a library that reports an error (a cluster the card
    # cannot schedule) and a CPU tensor standing in; the wrapper raises and
    # tries nothing else
    import contextlib
    import types

    class Refusing:
        calls = 0

        def subspace_ws_floats(self, *dims):
            return 4

        def subspace_ws_launch(self, *args):
            Refusing.calls += 1
            return 201  # a CUDA error: the launch was refused

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    t = torch.zeros((2, 144, 192))
    with pytest.raises(RuntimeError, match="CUDA error 201"):
        sk.launch_ws(Refusing(), t, 96, iters=8)
    assert Refusing.calls == 1
