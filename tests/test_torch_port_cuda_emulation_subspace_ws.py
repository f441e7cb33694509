"""The subspace kernel's workspace plan (`csrc/subspace_ws.cu`, one
thread-block cluster per layer), compiled for the CPU under the CUDA
emulation of `tests/torch_cuda_emulation.py`, against its plain version.
The other plans' cases are in `test_torch_port_cuda_emulation.py`."""

import numpy as np
import pytest
import torch

from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk
from tests.torch_cuda_emulation import GUARD, build_library, one_torch_thread

LIBRARIES = ("subspace_ws",)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("emu")
    return {name: build_library(name, directory) for name in LIBRARIES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.mark.parametrize("late", [0, 1])
@pytest.mark.parametrize("L,rows,cols,r,cluster,in_ws", [
    (1, 144, 192, 96, 8, ""),        # DeiT wide r = 96: all in shared memory
    (1, 720, 192, 96, 8, ""),        # DeiT tall r = 96: the lift over 8 blocks
    (2, 2304, 32, 30, 4, ""),        # DeiT 2304 x 32 at C = 4, two layers
    (1, 3600, 64, 16, 8, ""),        # rp = 16: 4 of 8 blocks own no NS rows
    (1, 300, 320, 106, 4, "g"),      # the Gram in the slab, its Y = G Q chunks
                                     # by cp.async
    # DeiT wide at C = 2: Y and the iterate in the slab
    (1, 144, 192, 96, 2, "y q"),
    # DeiT tall at C = 2: the Gram and Y (the lift's too) in the slab
    (1, 720, 192, 96, 2, "g y"),
    # DeiT 2304 x 32 at its C = 8: 288 rows of Y a block, 4 of the Gram
    (1, 2304, 32, 28, 8, ""),
    # rp = 176 (r = 174, not a multiple of 4): no room for all of Y and Z,
    # so Newton-Schulz stages them from their owners and q = Y Z goes
    # through the Gram's rows in pieces; Y and the iterate in the slab
    (1, 260, 176, 174, 8, "y q"),
    # the same at C = 4: the partial S in the slab
    (1, 260, 176, 174, 4, "sp y"),
    # ResNet-50 TT@3x's [2048, 512] at r = 130 (padded to 132) cut to
    # 612 x 284: the same C = 8 with the Gram and Y in the slab
    (1, 612, 284, 130, 8, "g y"),
])
def test_subspace_workspace_plan_matches_plain(libs, L, rows, cols, r,
                                               cluster, in_ws, late):
    assert not sk.block_plan_fits(rows, cols, r)
    assert sk.subspace_supported((L, rows, cols), r)
    assert sk.plan_name(rows, cols, r) == "workspace"
    plan = sk.ws_plan(rows, cols, r, cluster)
    assert plan.in_ws == tuple(in_ws.split())
    got = np.zeros(5, np.int64)
    libs["subspace_ws"].emu_ws_plan(rows, cols, r, cluster, got.ctypes.data)
    bits = {"ns": 1, "g": 2, "q": 4, "y": 8, "sp": 16}
    assert list(got) == [plan.smem_floats, plan.ws_floats,
                         sum(bits[n] for n in plan.in_ws), plan.stage,
                         sk.WS_CLUSTER]
    t = (np.random.RandomState(rows + cols).standard_normal((L, rows, cols))
         / np.sqrt(cols)).astype(np.float32)
    ws = np.full(L * plan.ws_floats + GUARD, np.nan, np.float32)
    ws[-GUARD:] = 12345.0
    assert ws.ctypes.data % 16 == 0
    for iters in (8, 0):
        q = np.full((L, rows, r), np.nan, np.float32)
        err = libs["subspace_ws"].emu_run_ws(t.ctypes.data, q.ctypes.data,
                                             ws.ctypes.data, L, rows, cols,
                                             r, iters, late, cluster)
        assert err == 0, f"emulation fault {err}"
        assert (ws[-GUARD:] == 12345.0).all(), "written past the workspace"
        p = sk.dominant_left_subspace_plain(torch.from_numpy(t), r,
                                            iters=iters).numpy()
        # the same float32 iteration in another summation order (Y^T Y
        # summed over the cluster's blocks, Newton-Schulz's Y W as W Y):
        # at most 6.7e-6 apart here
        assert np.abs(q - p).max() < 1e-5
        zq = q @ (q.transpose(0, 2, 1) @ t)
        zp = p @ (p.transpose(0, 2, 1) @ t)
        assert np.linalg.norm(zq - zp) / np.linalg.norm(zp) < 1e-5


@pytest.mark.parametrize("L,rows,cols,r,in_ws,late", [
    # DeiT-small TT@2x's blocks.0.attn.proj step at r = 320: the five
    # Newton-Schulz matrices and the partial S in the slab
    (1, 352, 384, 320, "ns sp", 0),
    # its fc1 step at r = 256: the partial S, the Gram and Y in the slab
    (1, 800, 384, 256, "sp g y", 1),
    # its fc2 tall step: 10,240 rows at r = 42, Y in the slab
    (1, 10240, 48, 42, "y", 0),
])
def test_subspace_workspace_plan_at_deit_small_shapes(libs, L, rows, cols, r,
                                                      in_ws, late):
    """The workspace plan at DeiT-small's real sizes and the library's
    cluster of 8, over one iteration step (each runs the same code as the
    Z-step's 8: the Gram, Y = G Q, 12 Newton-Schulz steps, the lift; the
    real sizes cost 2 to 4 s a step here)."""
    plan = sk.ws_plan(rows, cols, r)
    assert plan.in_ws == tuple(in_ws.split())
    t = (np.random.RandomState(rows + cols).standard_normal((L, rows, cols))
         / np.sqrt(cols)).astype(np.float32)
    ws = np.full(L * plan.ws_floats + GUARD, np.nan, np.float32)
    ws[-GUARD:] = 12345.0
    q = np.full((L, rows, r), np.nan, np.float32)
    err = libs["subspace_ws"].emu_run_ws(t.ctypes.data, q.ctypes.data,
                                         ws.ctypes.data, L, rows, cols, r, 1,
                                         late, sk.WS_CLUSTER)
    assert err == 0, f"emulation fault {err}"
    assert (ws[-GUARD:] == 12345.0).all(), "written past the workspace"
    p = sk.dominant_left_subspace_plain(torch.from_numpy(t), r,
                                        iters=1).numpy()
    # summation order only (6.4e-6 seen at r = 320)
    assert np.abs(q - p).max() < 1e-5
    zq = q @ (q.transpose(0, 2, 1) @ t)
    zp = p @ (p.transpose(0, 2, 1) @ t)
    assert np.linalg.norm(zq - zp) / np.linalg.norm(zp) < 1e-5
