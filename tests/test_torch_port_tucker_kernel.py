"""Tucker-2 factor kernel of the PyTorch port against the Pallas kernel.

The port's plain version (what its wrapper runs for a CPU tensor) is
held against the JAX package's `tucker2_factors_batched` in Pallas
interpret mode, on the same numpy inputs. The CUDA kernel itself is held
against the plain version on the card by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu.ops.pallas import (
    tucker2_factors_batched as jax_factors, tucker2_project_batched as jax_project)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool, and oversubscribed OpenMP threads ran
    these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# Both sides run the same float32 iteration; they differ in summation
# order only (about 1e-6 relative seen), amplified a little by ~1000
# dependent products.
REL_TOL = 1e-5

# the five buckets of the main path (ResNet32 TK@3x): [L, K, O, I], r0, r1
MAIN_PATH_BUCKETS = [((10, 9, 16, 16), 16, 16), ((1, 9, 32, 16), 24, 16),
                     ((9, 9, 32, 32), 20, 20), ((1, 9, 64, 32), 32, 25),
                     ((9, 9, 64, 64), 25, 23)]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("L,K,O,I,r0,r1", [
    (3, 9, 16, 8, 5, 3),     # rectangular conv bucket, both modes truncated
    (2, 1, 24, 16, 6, 6),    # linear bucket (K=1)
    (2, 9, 8, 8, 8, 3),      # full-rank mode 0
    (2, 9, 8, 8, 8, 8),      # both modes full rank: identity factors
])
def test_plain_matches_pallas_interpret(L, K, O, I, r0, r1):
    x = np.random.RandomState(L * 100 + O).standard_normal(
        (L, K, O, I)).astype(np.float32)
    u0_j, u1_j = jax_factors(jnp.asarray(x), r0, r1, interpret=True)
    u0_t, u1_t = tk.tucker2_factors_batched(torch.from_numpy(x), r0, r1)
    assert u0_t.shape == (L, O, min(r0, O)) and u1_t.shape == (L, I, min(r1, I))
    assert _rel(u0_t.numpy(), u0_j) < REL_TOL
    assert _rel(u1_t.numpy(), u1_j) < REL_TOL
    z_j = jax_project(jnp.asarray(x), r0, r1, interpret=True)
    z_t = tk.tucker2_project_batched(torch.from_numpy(x), r0, r1)
    assert _rel(z_t.numpy(), z_j) < REL_TOL


def test_plain_exact_on_low_rank_input():
    rng = np.random.RandomState(2)
    u = rng.standard_normal((2, 16, 4))
    v = rng.standard_normal((2, 4, 12))
    core = rng.standard_normal((2, 9, 4, 4))
    x = np.einsum("lor,lkrs,lsi->lkoi", u, core, v).astype(np.float32)
    z = tk.tucker2_project_batched(torch.from_numpy(x), 4, 4).numpy()
    assert _rel(z, x) < 1e-3


def test_shared_memory_gate_on_main_path_buckets():
    # the resident plan, in floats: X [K, op, odd4(ip)], the Gram np^2,
    # U0 op r0p, U1 ip r1p, then the larger of Y np rp + 5 rp^2 and a group
    # of HOOI products, each max(op odd4(r1p), r0p ip) (every size rounded up
    # to 4, odd4 to an odd number of float4s); the compiled library reports
    # the same plan on the card (chip_smoke.py)
    expected = [4 * (9 * 16 * 20 + 256 + 256 + 256 + 9 * 16 * 20),
                4 * (9 * 32 * 20 + 1024 + 32 * 24 + 16 * 16 + 9 * 32 * 20),
                4 * (9 * 32 * 36 + 1024 + 32 * 20 + 32 * 20 + 9 * 32 * 20),
                4 * (9 * 64 * 36 + 4096 + 64 * 32 + 32 * 28 + 9 * 64 * 28),
                # [9, 9, 64, 64]: room for 6 of the 9 products, taken as 5 + 4
                4 * (9 * 64 * 68 + 4096 + 64 * 28 + 64 * 24 + 5 * 64 * 28)]
    assert expected == [26112, 54272, 73728, 175616, 222208]
    got = [tk.smem_bytes(*s[1:], r0, r1) for s, r0, r1 in MAIN_PATH_BUCKETS]
    assert got == expected
    assert all(tk.kernel_supported(s, r0, r1) for s, r0, r1 in MAIN_PATH_BUCKETS)
    # four of them need more than the 48 KB default: the launcher opts in
    assert sum(b > 48 * 1024 for b in got) == 4
    # the Gram alone is 256 KiB: past every block plan, so the workspace plan
    assert not tk.block_plan_fits(9, 256, 256, 64, 64)
    assert tk.plan_name(9, 256, 256, 64, 64) == "workspace"
    assert tk.kernel_supported((4, 9, 256, 256), 64, 64)
    assert not tk.kernel_supported((4, 64, 64), 8, 8)         # not [L, K, O, I]


# chip_smoke.py's near-cap buckets: the first version's plan fits, X does not
NEAR_CAP_BUCKETS = [((2, 9, 144, 144), 40, 40), ((2, 9, 160, 96), 40, 30)]


def test_main_path_holds_x_and_near_cap_buckets_stream_it():
    assert all(tk.resident_plan(*s[1:], r0, r1) for s, r0, r1 in MAIN_PATH_BUCKETS)
    assert [tk._plan(*s[1:], r0, r1)[2] for s, r0, r1 in MAIN_PATH_BUCKETS] \
        == [9, 9, 9, 9, 5]
    for shape, r0, r1 in NEAR_CAP_BUCKETS:
        assert tk.kernel_supported(shape, r0, r1)
        assert not tk.resident_plan(*shape[1:], r0, r1)
    # the streamed plan is the first version's, byte for byte
    assert [tk.smem_bytes(*s[1:], r0, r1) for s, r0, r1 in NEAR_CAP_BUCKETS] \
        == [207_104, 216_320]


def _first_plan_fits(o, i, r0, r1):
    """The first version's gate: its plan within a block's 227 KB."""
    n, r = max(o, i), max(r0, r1)
    return 4 * (n * n + o * r0 + i * r1 + n * r + max(o * r1, r0 * i)
                + 5 * r * r) <= 232_448


@pytest.mark.parametrize("k", [1, 4, 9, 25])
def test_gate_accepts_every_shape_the_first_plan_fits(k):
    sizes = [1, 3, 4, 7, 16, 33, 64, 96, 100, 144, 160, 201, 240, 256]
    for o in sizes:
        for i in sizes:
            ranks = sorted({1, 2, 5, 12, 23, 40, 64, 97, min(o, i), max(o, i)})
            for r0 in (r for r in ranks if r <= o):
                for r1 in (r for r in ranks if r <= i):
                    fits = _first_plan_fits(o, i, r0, r1)
                    ok = tk.kernel_supported((1, k, o, i), r0, r1)
                    assert ok or not fits, (k, o, i, r0, r1)
                    if not tk.resident_plan(k, o, i, r0, r1) and fits:
                        assert tk.smem_bytes(k, o, i, r0, r1) == 4 * (
                            max(o, i) ** 2 + o * r0 + i * r1
                            + max(o, i) * max(r0, r1) + max(o * r1, r0 * i)
                            + 5 * max(r0, r1) ** 2)


def test_main_path_work_and_bound():
    flops = sum(tk.factor_flops(s, r0, r1) for s, r0, r1 in MAIN_PATH_BUCKETS)
    assert tk.factor_flops(*MAIN_PATH_BUCKETS[0]) == 0  # full rank: no work
    # about 0.84 GFLOP per Z-step: ~13 us at 67 TFLOP/s float32
    assert 0.8e9 < flops < 0.9e9


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 9, 8, 8, dtype=torch.float64), TypeError),
    (torch.zeros(2, 9, 8, 8).transpose(2, 3), ValueError),
    (torch.zeros(9, 8, 8), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        tk.tucker2_factors_batched(bad, 4, 4)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = tk.tucker2_factors_batched.launches
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 9, 8, 8)).astype(np.float32))
    u0, u1 = tk.tucker2_factors_batched(x, 3, 3)
    p0, p1 = tk.tucker2_factors_plain(x, 3, 3)
    assert torch.equal(u0, p0) and torch.equal(u1, p1)
    assert tk.tucker2_factors_batched.launches == before


# DeiT-tiny TK@2x's four buckets: [L, K, O, I], r0, r1
DEIT_BUCKETS = [((12, 1, 192, 192), 72, 72), ((12, 1, 576, 192), 128, 72),
                ((12, 1, 768, 192), 128, 72), ((12, 1, 192, 768), 72, 128)]


def test_deit_buckets_take_the_workspace_plan():
    # every block plan is past a block: 0.47 to 3.75 MB
    assert [tk.smem_bytes(*s[1:], r0, r1) for s, r0, r1 in DEIT_BUCKETS] \
        == [472_320, 2_465_792, 3_749_888, 3_749_888]
    plans = [tk.ws_plan(*s[1:], r0, r1) for s, r0, r1 in DEIT_BUCKETS]
    assert all(tk.kernel_supported(*b) for b in DEIT_BUCKETS)
    # one cluster of 8 blocks per layer: 96 of the card's SMs for 12 layers
    assert [p.cluster for p in plans] == [8] * 4
    # proj all in shared memory; at r = 128 the Gram's own rows (fc1: 96 x
    # 768) and the factors (with fc1 and fc2's HOOI product) in the slab
    assert [p.in_ws for p in plans] == [(), ("g", "u"), ("g", "u", "m"),
                                        ("g", "u", "m")]
    assert [4 * p.ws_floats for p in plans] == [
        0, 1_677_312, 3_028_992, 3_028_992]
    assert [4 * p.smem_floats for p in plans] == [173_952] + [232_448] * 3
    # two stage buffers of 16 rows of X_k at least, each holding a whole
    # Newton-Schulz matrix (proj: two, so two copies of Y and Z)
    for p, (_, r0, r1) in zip(plans, DEIT_BUCKETS):
        rp = max(tk._up4(r0), tk._up4(r1))
        assert p.stage >= 16 * p.ldc and p.stage >= rp * rp
    assert plans[0].stage >= 2 * 72 * 72
    # the work: 214 GFLOP per Z-step, 3.20 ms at 67 TFLOP/s float32
    flops = sum(tk.factor_flops(*b) for b in DEIT_BUCKETS)
    assert 214.2e9 < flops < 214.3e9


WS_SHAPES = [*DEIT_BUCKETS, ((6, 9, 256, 256), 64, 64),
             ((1, 9, 16, 328), 8, 75), ((1, 9, 208, 208), 20, 20),
             ((1, 9, 150, 90), 70, 45), ((1, 1, 248, 8), 244, 8)]


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_workspace_plan_regions_fit_and_are_aligned(cluster):
    for shape, r0, r1 in WS_SHAPES:
        _, k, o, i = shape
        p = tk.ws_plan(k, o, i, r0, r1, cluster)
        assert p.cluster == (cluster or tk.ws_cluster(o, i))
        assert p.smem_floats <= tk.MAX_SMEM_BYTES // 4
        assert p.ws_floats % 4 == 0 and p.stage % 4 == 0 and p.stage >= p.ldc
        assert 2 * p.stage <= p.smem_floats
        # HOOI products in the workspace: all K in one phase; shared: as
        # many as fit, in groups of equal size
        assert 1 <= p.kg <= k and ("m" not in p.in_ws or p.kg == k)


@pytest.mark.parametrize("n", [4, 8, 20, 72, 128, 192, 768])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_workspace_rows_split_over_the_cluster(n, c):
    # groups of 4 rows, every row owned once, in block order, the blocks'
    # shares at most one group apart (some blocks own none where n < 4 c)
    los = [tk.split_lo(n, q, c) for q in range(c + 1)]
    assert los[0] == 0 and los[-1] == n
    sizes = [b - a for a, b in zip(los, los[1:])]
    assert all(s >= 0 and s % 4 == 0 for s in sizes)
    assert max(sizes) - min(sizes) <= 4
    assert max(sizes) == tk._own_cap(n, c)


def test_workspace_cluster_sizes():
    assert [tk.ws_cluster(o, i) for o, i in [(192, 192), (576, 192),
                                             (16, 328), (150, 90), (90, 40),
                                             (40, 20)]] == [8, 8, 8, 4, 2, 1]


def test_workspace_launch_raises_on_a_cluster_the_card_refuses(monkeypatch):
    # no card here: a library that reports an error (a cluster the card
    # cannot schedule) and a CPU tensor standing in; the wrapper raises and
    # tries nothing else
    import contextlib
    import types

    class Refusing:
        calls = 0

        def tucker2_factors_ws_floats(self, *dims):
            return 4

        def tucker2_factors_ws_launch(self, *args):
            Refusing.calls += 1
            return 201  # a CUDA error: the launch was refused

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros((2, 1, 192, 192))
    with pytest.raises(RuntimeError, match="CUDA error 201"):
        tk.launch_ws(Refusing(), x, 72, 72, sweeps=2)
    assert Refusing.calls == 1
