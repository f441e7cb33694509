"""The port's CUDA C++ kernels, compiled for the CPU under the CUDA
emulation of `tests/torch_cuda_emulation.py`, against their plain
versions: the subspace kernel's block plans (`csrc/subspace.cu`) and the
Tucker-2 factor kernel's block and workspace plans
(`csrc/tucker2_factors.cu`, `csrc/tucker2_factors_ws.cu`). The subspace
kernel's workspace plan has its own file,
`test_torch_port_cuda_emulation_subspace_ws.py`, so that the two halves
run on two workers under `--dist loadfile`."""

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk
from tests.torch_cuda_emulation import GUARD, build_library, one_torch_thread

LIBRARIES = ("subspace", "tucker2_factors", "tucker2_factors_ws")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("emu")
    return {name: build_library(name, directory) for name in LIBRARIES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.mark.parametrize("late", [0, 1])
@pytest.mark.parametrize("L,rows,cols,r", [
    (2, 32, 72, 8),     # wide, scalar 2x2 Gram, scalar products (rp < 12)
    (1, 40, 150, 13),   # wide, padded: transposed chunks, float4 Gram and products
    (1, 100, 36, 10),   # tall, 36 columns: lift from L2
    (1, 90, 33, 12),    # tall, 33 columns padded to 36: lift from L2
    (1, 100, 64, 10),   # tall: lift staged in row chunks
    (1, 150, 66, 12),   # tall: lift chunks with zero pads (66 -> 68)
    (2, 120, 8, 8),     # tall, full rank in the columns: lift from L2
    (1, 70, 130, 20),   # wide, Gram of 70 rows in two 64 x 64 blocks
    (1, 193, 197, 33),  # near a block's limit: the unpadded plan
    (1, 197, 193, 33),  # the same, tall: scalar products, lift from L2
    # ResNet-50 TT@3x's longest rows: [32, 73728] at r = 30 streams its
    # Gram through 1,152 stages of 64 columns
    (1, 32, 73728, 30),
])
def test_subspace_source_matches_plain(libs, L, rows, cols, r, late):
    t = (np.random.RandomState(rows + cols).standard_normal((L, rows, cols))
         / np.sqrt(cols)).astype(np.float32)
    assert sk.subspace_supported(t.shape, r)
    for iters in (8, 0):
        q = np.full((L, rows, r), np.nan, np.float32)
        err = libs["subspace"].emu_run(t.ctypes.data, q.ctypes.data, L, rows,
                                       cols, r, iters, late)
        assert err == 0, f"emulation fault {err}"
        p = sk.dominant_left_subspace_plain(torch.from_numpy(t), r,
                                            iters=iters).numpy()
        # the same float32 iteration, summed in the same order; only
        # rsqrtf differs (exact here, approximate on the card)
        assert np.abs(q - p).max() < 1e-5
        zq = q @ (q.transpose(0, 2, 1) @ t)
        zp = p @ (p.transpose(0, 2, 1) @ t)
        assert np.linalg.norm(zq - zp) / np.linalg.norm(zp) < 1e-5


def _tucker2_against_plain(libs, shape, r0, r1, sweeps, late):
    l, k, o, i = shape
    x = (np.random.RandomState(o * i).standard_normal(shape)
         / np.sqrt(k * i)).astype(np.float32)
    u0 = np.full((l, o, r0), np.nan, np.float32)
    u1 = np.full((l, i, r1), np.nan, np.float32)
    err = libs["tucker2_factors"].emu_run(x.ctypes.data, u0.ctypes.data,
                                          u1.ctypes.data, l, k, o, i, r0, r1,
                                          sweeps, late)
    assert err == 0, f"emulation fault {err}"
    xt = torch.from_numpy(x)
    p0, p1 = tk.tucker2_factors_plain(xt, r0, r1, sweeps=sweeps)
    z = tk.tucker2_reconstruct(xt, torch.from_numpy(u0), torch.from_numpy(u1))
    zp = tk.tucker2_reconstruct(xt, p0, p1)
    assert (torch.linalg.vector_norm(z - zp)
            / torch.linalg.vector_norm(zp)).item() < 1e-5


@pytest.mark.parametrize("shape,r0,r1", [
    ((2, 9, 16, 16), 16, 16),   # full rank: the identity
    ((1, 9, 32, 16), 12, 8),
    ((1, 3, 40, 20), 9, 5),
])
def test_tucker2_source_matches_plain(libs, shape, r0, r1):
    _tucker2_against_plain(libs, shape, r0, r1, 2, 0)


@pytest.mark.parametrize("late", [0, 1])
@pytest.mark.parametrize("shape,r0,r1,sweeps,resident", [
    ((1, 9, 32, 32), 20, 20, 2, True),    # resident X, padded iteration
    ((1, 9, 64, 64), 25, 23, 2, True),    # HOOI products in two groups (5 + 4)
    ((1, 9, 64, 64), 25, 23, 0, True),    # sweeps=0: the Grams and HOSVD init
    ((1, 9, 32, 16), 24, 16, 2, True),    # even ranks, mode 1 full rank
    ((1, 9, 30, 18), 7, 5, 2, True),      # odd sizes and ranks: zero pads, scalar
    ((2, 1, 36, 20), 12, 8, 2, True),     # K = 1: padded mode 0, scalar mode 1
    ((1, 4, 8, 24), 8, 5, 2, True),       # mode 0 full rank (identity)
    ((1, 9, 144, 144), 40, 40, 2, False), # X streamed: 64 x 64 Gram blocks
    ((1, 9, 160, 96), 40, 30, 2, False),  # X streamed, O != I
])
def test_tucker2_plans_match_plain(libs, shape, r0, r1, sweeps, resident, late):
    _, k, o, i = shape
    assert tk.kernel_supported(shape, r0, r1)
    assert tk.resident_plan(k, o, i, r0, r1) == resident
    _tucker2_against_plain(libs, shape, r0, r1, sweeps, late)


@pytest.mark.parametrize("shape,r0,r1,cluster,in_ws,sweeps,late", [
    # DeiT fc1, fc2 and qkv at C = 2: the Gram (its chunks of A staged by
    # cp.async), Y, the factors and (fc1, fc2) the Newton-Schulz matrices and
    # the HOOI product in the slab; one copy of Newton-Schulz's Y and Z
    ((1, 1, 768, 192), 128, 72, 2, "ns g y u m", 2, 1),
    ((1, 1, 192, 768), 72, 128, 2, "ns g y u m", 2, 0),
    ((1, 1, 576, 192), 128, 72, 2, "ns g y u", 2, 0),
    # DeiT proj, two layers: two clusters, the factors in the slab
    ((2, 1, 192, 192), 72, 72, 2, "u", 2, 1),
    # C = 4, all in shared memory: two copies of Y and Z
    ((1, 9, 128, 128), 64, 64, 4, "", 2, 1),
    # C = 2, then C = 8, where 3 blocks own no Newton-Schulz rows (rp = 20)
    ((1, 9, 208, 208), 20, 20, 2, "", 2, 0),
    ((1, 9, 208, 208), 20, 20, 8, "", 2, 1),
    # O and I not multiples of 4: scalar HOOI products, zero pads; the 9
    # HOOI products in 5 groups of 2
    ((1, 9, 150, 90), 70, 45, 2, "", 2, 1),
    # mode 0 full rank (the identity); the Gram in the slab; two layers
    ((2, 9, 12, 400), 12, 8, 2, "g", 2, 0),
    # r = 244: the Newton-Schulz matrices and the partial S in the slab,
    # their products staged from the slab (no room for all of Y and Z)
    ((1, 1, 248, 8), 244, 8, 2, "ns sp y u", 0, 1),
    # MobileNetV2-CIFAR SVD's head (1280 x 320 at r = 160, as K = 1 with
    # r0 = r1) cut to 328 x 168: rp = 160 at C = 8 with the same regions in
    # the slab, the Newton-Schulz matrices among them
    ((1, 1, 328, 168), 160, 160, 8, "ns g y u m", 2, 1),
    # its tall 384 x 64 buckets at r = 36, two layers at C = 8: chunk rows
    # of 388 floats (O + 4), 8 rows of U1 a block
    ((2, 1, 384, 64), 36, 36, 8, "", 2, 0),
    # ResNet-50 TK@3x's [3, 9, 512, 512] at 64/96 cut to 476 x 128: K = 9
    # at C = 8 with Y, the factors and the HOOI products in the slab
    ((1, 9, 476, 128), 64, 96, 8, "y u m", 2, 1),
])
def test_tucker2_workspace_plan_matches_plain(libs, shape, r0, r1, cluster,
                                              in_ws, sweeps, late):
    l, k, o, i = shape
    assert not tk.block_plan_fits(k, o, i, r0, r1)
    assert tk.kernel_supported(shape, r0, r1)
    assert tk.plan_name(k, o, i, r0, r1) == "workspace"
    plan = tk.ws_plan(k, o, i, r0, r1, cluster)
    assert plan.in_ws == tuple(in_ws.split())
    got = np.zeros(6, np.int64)
    libs["tucker2_factors_ws"].emu_ws_plan(k, o, i, r0, r1, cluster,
                                           got.ctypes.data)
    bits = {"ns": 1, "g": 2, "u": 4, "y": 8, "m": 16, "sp": 32}
    assert list(got) == [plan.smem_floats, plan.ws_floats,
                         sum(bits[n] for n in plan.in_ws), plan.stage,
                         plan.kg, tk.ws_cluster(o, i)]
    x = (np.random.RandomState(o * i).standard_normal(shape)
         / np.sqrt(k * i)).astype(np.float32)
    ws = np.full(l * plan.ws_floats + GUARD, np.nan, np.float32)
    ws[-GUARD:] = 12345.0
    assert ws.ctypes.data % 16 == 0
    u0 = np.full((l, o, r0), np.nan, np.float32)
    u1 = np.full((l, i, r1), np.nan, np.float32)
    err = libs["tucker2_factors_ws"].emu_run_ws(
        x.ctypes.data, u0.ctypes.data, u1.ctypes.data, ws.ctypes.data, l, k,
        o, i, r0, r1, sweeps, late, cluster)
    assert err == 0, f"emulation fault {err}"
    assert (ws[-GUARD:] == 12345.0).all(), "written past the workspace"
    xt = torch.from_numpy(x)
    p0, p1 = tk.tucker2_factors_plain(xt, r0, r1, sweeps=sweeps)
    # the same float32 iteration in another summation order: Y^T Y summed
    # over the cluster's blocks, Newton-Schulz's Y W as W Y
    z = tk.tucker2_reconstruct(xt, torch.from_numpy(u0), torch.from_numpy(u1))
    zp = tk.tucker2_reconstruct(xt, p0, p1)
    assert (torch.linalg.vector_norm(z - zp)
            / torch.linalg.vector_norm(zp)).item() < 1e-5
