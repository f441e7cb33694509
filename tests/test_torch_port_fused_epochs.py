"""Fused epochs in the PyTorch port (`--epochs-per-dispatch`,
`train/capture.py`) against the JAX package's rule, on the CPU at a tiny
size. On the CPU the fused chunk runs eagerly; the card replays it from
CUDA graphs (`chip_smoke.py`'s fused phase).

* The counterparts of the JAX package's `TestEpochChunking`
  (`tests/test_train.py:220-255`) on a ResNet-20 with ADMM: the fused run
  equals the per-epoch run bit for bit (losses, accuracies, weights,
  buffers, Z, U), evaluation boundaries are kept, and a log file turns
  chunking off.
* Chunk sizes over a table of cases, each derived from the JAX package's
  `train/engine.py:654-671` (the `chunkable` predicate and the `k` rule);
  the JAX `train_model` itself is not run here (its `TestEpochChunking`
  takes minutes on this CPU). The port's exclusions and their one log
  line.
* The device-indexed batch rows against `batch_at_views`, the lr table
  against the schedule, the in-place Z/U step against `admm_update`, the
  launch count of a captured kernel, the ViT's seeded init, and the CLI
  flag against the JAX parser.
"""

import argparse
import dataclasses
import functools

import numpy as np
import pytest
import torch

import dnn_compression_tensor_admm_tpu.cli.main as jax_cli
import dnn_compression_tensor_admm_tpu_torch.cli.main as port_cli
import dnn_compression_tensor_admm_tpu_torch.train as port_train
from dnn_compression_tensor_admm_tpu_torch.admm import (admm_init, admm_update,
                                                        admm_update_,
                                                        build_program)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.configs.hp import RankPlan, SVDSpec
from dnn_compression_tensor_admm_tpu_torch.data.device_pipeline import (
    batch_at_views, batch_rows_at, sample_batch_repeated)
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import launches
from dnn_compression_tensor_admm_tpu_torch.parallel.mesh import Mesh
from dnn_compression_tensor_admm_tpu_torch.train import (TrainConfig, capture,
                                                         engine, train_model)
from dnn_compression_tensor_admm_tpu_torch.train.optim import (
    LrTable, make_schedule, make_train_optimizer)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    """The JAX `TestEpochChunking._base` at a smaller batch: ResNet-20
    TK@3x ADMM, 4 epochs x 3 steps, the kernel route (its plain version
    on the CPU)."""
    base = dict(model="resnet20", dataset="synthetic-cifar10",
                synthetic_size=128, batch_size=16, steps_per_epoch=3,
                epochs=4, admm=True, fmt="tk", ratio="3", admm_hooi_iters=2,
                admm_method="kernel", compute_dtype=None, device="cpu",
                print_fn=lambda *a: None)
    return TrainConfig(**{**base, **kw})


def _run(cfg):
    """train_model -> (model, history, the ADMM state its Z/U steps
    wrote, the chunk sizes it ran)."""
    seen = {"sizes": []}
    update, run = engine.admm_update_, capture.EpochChunks.run

    def keep(params, state, program, **kw):
        seen["state"] = state
        return update(params, state, program, **kw)

    def sized(self, k):
        seen["sizes"].append(k)
        return run(self, k)

    engine.admm_update_, capture.EpochChunks.run = keep, sized
    try:
        model, hist = train_model(cfg)
    finally:
        engine.admm_update_, capture.EpochChunks.run = update, run
    return model, hist, seen.get("state"), seen["sizes"]


def _equal_maps(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("extra", [
    dict(),
    dict(sampling="shuffle", opt="sgd"),
    dict(sampling="replacement", repeated_aug=3, opt="adamw", lr=1e-3),
    dict(repeated_aug=3, opt="adam", lr=1e-3, clip_grad=1.0, ema_decay=0.9),
    dict(mixup=0.8, cutmix=1.0, smoothing=0.1),
    dict(admm_method="subspace"),
    dict(admm_method="ns", fmt="tt"),
], ids=["perm-momentum", "shuffle-nesterov", "replacement-views-adamw",
        "perm-views-adam-clip-ema", "perm-mixup-cutmix", "perm-subspace-tk",
        "perm-ns-tt"])
def test_fused_matches_unfused(extra):
    """JAX `test_fused_matches_unfused`, bit for bit: the rows' losses
    and accuracies, the weights and buffers, Z and U."""
    m1, h1, s1, k1 = _run(_cfg(eval_every=10 ** 9, epochs_per_dispatch=1,
                               **extra))
    m2, h2, s2, k2 = _run(_cfg(eval_every=10 ** 9, epochs_per_dispatch=4,
                               **extra))
    assert (k1, k2) == ([], [4])
    assert [h["train_loss"] for h in h1] == [h["train_loss"] for h in h2]
    assert [h["train_acc"] for h in h1] == [h["train_acc"] for h in h2]
    assert h1[-1]["test_loss"] == h2[-1]["test_loss"]
    _equal_maps(m1.state_dict(), m2.state_dict())
    _equal_maps(s1.z, s2.z)
    _equal_maps(s1.u, s2.u)
    # the fused rows are the JAX package's: epoch, loss, accuracy, time;
    # with Mixup/CutMix the epoch's failed Beta draws too
    mixed = ["mix_failed_draws"] if "mixup" in extra else []
    assert sorted(h2[0]) == ["epoch", "epoch_time_s", *mixed, "train_acc",
                             "train_loss"]
    assert [h.get("mix_failed_draws") for h in h1] == [
        h.get("mix_failed_draws") for h in h2] == [0 if mixed else None] * 4
    assert len({h["epoch_time_s"] for h in h2}) == 1
    assert "admm_residual_total" in h1[0]


def test_fused_fine_tune_with_augmentations_and_a_teacher():
    """A fine-tune (no ADMM) with RandAugment, erasing and hard
    distillation from a teacher: a chunk of 2 epochs, then the last epoch
    per epoch, bit for bit the per-epoch run."""
    teacher = create_model("resnet20", num_classes=10,
                           generator=torch.Generator().manual_seed(3))
    cfg = _cfg(model="resnet20", admm=False, epochs=3, randaug_magnitude=9,
               erase_prob=0.5, distillation_type="hard",
               teacher_model="resnet20",
               teacher_state_dict=teacher.state_dict(), eval_every=10 ** 9)
    m1, h1, _, k1 = _run(dataclasses.replace(cfg, epochs_per_dispatch=1))
    m2, h2, _, k2 = _run(dataclasses.replace(cfg, epochs_per_dispatch=2))
    assert (k1, k2) == ([], [2])  # epoch 3 alone, per epoch
    assert [h["train_loss"] for h in h1] == [h["train_loss"] for h in h2]
    _equal_maps(m1.state_dict(), m2.state_dict())


def test_eval_boundaries_respected():
    """JAX `test_eval_boundaries_respected`: chunks end at evaluations."""
    _, h, _, sizes = _run(_cfg(eval_every=2, epochs_per_dispatch=4))
    assert sizes == [2, 2]
    assert [r["epoch"] for r in h] == [1, 2, 3, 4]
    assert [("test_acc1" in r) for r in h] == [False, True, False, True]


def test_observability_falls_back(tmp_path):
    """JAX `test_observability_falls_back`: a log file asks for per-epoch
    rows, so nothing is chunked."""
    cfg = _cfg(eval_every=10 ** 9, epochs_per_dispatch=4,
               log_path=str(tmp_path / "x.log"))
    _, h, _, sizes = _run(cfg)
    assert sizes == []
    assert len(open(cfg.log_path).readlines()) == 4
    assert all("admm_residual_total" in r for r in h)


def _sizes(cfg, start, epochs, has_val, streaming=False):
    """The chunk sizes the engine's loop takes from `start`."""
    out, epoch = [], start
    fuse = capture.chunkable(cfg, streaming)
    while epoch < epochs:
        k = capture.chunk_size(cfg, epoch, epochs, has_val) if fuse else 1
        out.append(k)
        epoch += k
    return out


# (start epoch, epochs, eval_every, validation set, config changes,
# streaming) -> sizes. JAX `train/engine.py:654-659`: chunkable unless
# streaming, epochs_per_dispatch <= 1, verbose, a log path, a checkpoint
# or profile dir, or the late rho boost; `:665-671`: with a validation set
# and eval_every <= epochs, nxt = (epoch // eval_every + 1) * eval_every,
# else nxt = epochs; k = max(1, min(epochs_per_dispatch, nxt - epoch,
# epochs - epoch)).
CHUNK_CASES = [
    ((0, 4, 2, True, {}, False), [2, 2]),
    ((0, 4, 1, True, {}, False), [1, 1, 1, 1]),
    ((0, 4, 10 ** 9, True, {}, False), [4]),
    ((0, 20, 10 ** 9, True, {}, False), [8, 8, 4]),
    ((0, 20, 7, True, {}, False), [7, 7, 6]),
    ((3, 10, 4, True, {}, False), [1, 4, 2]),
    ((0, 10, 3, False, {}, False), [8, 2]),  # no validation set: to the end
    ((0, 9, 9, True, {}, False), [8, 1]),
    ((2, 9, 10 ** 9, True, {"epochs_per_dispatch": 3}, False), [3, 3, 1]),
    ((0, 4, 10 ** 9, True, {"epochs_per_dispatch": 1}, False), [1] * 4),
    ((0, 4, 10 ** 9, True, {"verbose_admm": True}, False), [1] * 4),
    ((0, 4, 10 ** 9, True, {"log_path": "x.log"}, False), [1] * 4),
    ((0, 4, 10 ** 9, True, {"checkpoint_dir": "ck"}, False), [1] * 4),
    ((0, 4, 10 ** 9, True, {"profile_dir": "pr"}, False), [1] * 4),
    ((0, 4, 10 ** 9, True, {"adjust_rho_late": True}, False), [1] * 4),
    ((0, 4, 10 ** 9, True, {}, True), [1] * 4),  # streamed shards
    ((1, 4, 10 ** 9, True, {"resume": "ck"}, False), [3]),  # resume alone
]


@pytest.mark.parametrize("case,want", CHUNK_CASES)
def test_chunk_sizes_follow_the_jax_rule(case, want):
    start, epochs, eval_every, has_val, changes, streaming = case
    cfg = _cfg(epochs=epochs, eval_every=eval_every, **changes)
    assert _sizes(cfg, start, epochs, has_val, streaming) == want


def test_exclusions_take_the_per_epoch_route_and_say_so_once():
    """A mesh and the non-kernel Z/U methods stay per epoch, said once;
    Mixup/CutMix, drawn on the device, is fused."""
    assert capture.exclusion(_cfg()) is None
    assert capture.exclusion(_cfg(), Mesh(1, 1, 0)) is None
    assert "2 ranks" in capture.exclusion(_cfg(), Mesh(2, 1, 0))
    assert capture.exclusion(_cfg(mixup=0.8)) is None
    assert capture.exclusion(_cfg(cutmix=1.0)) is None
    assert "'svd'" in capture.exclusion(_cfg(admm_method="svd"))
    assert capture.exclusion(_cfg(admm=False, admm_method="svd")) is None
    lines = []
    cfg = _cfg(admm_method="svd", epochs=3, eval_every=10 ** 9,
               print_fn=lines.append)
    _, h, _, sizes = _run(cfg)
    assert sizes == []
    said = [l for l in lines if "per-epoch route" in l]
    assert len(said) == 1 and "'svd'" in said[0]
    assert all("admm_residual_total" in r for r in h)
    lines.clear()
    _, h, _, sizes = _run(dataclasses.replace(cfg, admm_method="kernel",
                                              mixup=0.8))
    assert sizes == [3]
    assert not [l for l in lines if "per-epoch route" in l]
    assert [r["mix_failed_draws"] for r in h] == [0, 0, 0]


@functools.lru_cache(maxsize=None)
def _program(fmt):
    """A ResNet-20 program in `fmt`; 'svd': one 1x1 conv at rank 2."""
    if fmt == "svd":
        return build_program({"w": torch.zeros(8, 8, 1, 1)},
                             RankPlan("svd", {"w": SVDSpec(2)}))
    params = dict(create_model("resnet20").named_parameters())
    return build_program(params, get_rank_plan("resnet20", fmt, "3"))


# (method, program's format, mesh ranks) -> a word of the reason, or None:
# fused ('kernel', 'subspace' and 'ns' capture every call of their Z/U
# step) unless the step reads a flag to the host ('gram''s eigh, 'svd',
# an SVD bucket's exact SVD under any method but 'kernel') or a mesh
EXCLUSION_CASES = [
    (("kernel", "tk", 1), None),
    (("kernel", "tt", 1), None),
    (("kernel", "svd", 1), None),
    (("subspace", "tk", 1), None),
    (("subspace", "tt", 1), None),
    (("ns", "tk", 1), None),
    (("ns", "tt", 1), None),
    (("gram", "tk", 1), "'gram'"),
    (("gram", "tt", 1), "'gram'"),
    (("svd", "tk", 1), "'svd'"),
    (("svd", "tt", 1), "'svd'"),
    (("subspace", "svd", 1), "SVD layers"),
    (("ns", "svd", 1), "SVD layers"),
    (("kernel", "tk", 2), "2 ranks"),
    (("subspace", "tt", 2), "2 ranks"),
]


@pytest.mark.parametrize("case,want", EXCLUSION_CASES)
def test_exclusion_by_method_program_and_mesh(case, want):
    method, fmt, ranks = case
    why = capture.exclusion(_cfg(admm_method=method), Mesh(ranks, 1, 0),
                            _program(fmt))
    if want is None:
        assert why is None
    else:
        assert want in why


@pytest.mark.parametrize("repeats", [0, 1, 3])
def test_device_rows_equal_batch_at_views_at_every_step(repeats):
    """Two epochs of steps, past the point where `batch_at` wraps."""
    n, b = 50, 8
    x = torch.arange(n) * 10
    for step in range(2 * (n // b + 3)):
        rows = batch_rows_at(torch.tensor(step), n, b, repeats)
        assert torch.equal(x[rows], batch_at_views(x, step, b, repeats)), step
    with pytest.raises(ValueError):
        batch_rows_at(torch.tensor(0), 2, 8, 0)


def test_repeated_uniform_rows_are_the_repeat_interleave():
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    got = sample_batch_repeated(100, g1, 10, 3)
    base = torch.randint(0, 100, (4,), generator=g2)
    assert torch.equal(got, base.repeat_interleave(3)[:10])


@pytest.mark.parametrize("kind,warmup", [("cosine", 0), ("cosine", 2),
                                         ("step", 0), ("constant", 0)])
def test_lr_table_is_the_schedule_in_float32(kind, warmup):
    epochs, steps = 6, 5
    sched = make_schedule(kind, 0.1, epochs, steps, warmup, 1e-5, 2, 0.5)
    for start in (0, 7):
        lrs = LrTable(sched, epochs * steps, torch.device("cpu"), start)
        for s in range(start, epochs * steps):
            lrs.advance()
            assert lrs.lr.item() == np.float32(sched(s)), (s, start)
        assert lrs.step.item() == epochs * steps


def test_lr_tensor_reaches_every_param_group():
    model = create_model("stftkc_resnet20", ratio="3",
                         generator=torch.Generator().manual_seed(0))
    lrs = LrTable(lambda s: 0.5 / (s + 1), 4, torch.device("cpu"))
    opt, _ = make_train_optimizer(model.named_parameters(), lrs.lr,
                                  opt="adamw", stiefel=True)
    opt.load_state_dict(opt.state_dict())  # a resume puts the saved lr in
    lrs.attach(opt)
    assert len(opt.param_groups) == 2
    lrs.advance()
    lrs.advance()
    assert all(g["lr"] is lrs.lr for g in opt.param_groups)
    assert lrs.lr.item() == np.float32(0.25)


@pytest.mark.parametrize("fmt", ["tk", "tt"])
def test_in_place_zu_step_is_admm_update_bit_for_bit(fmt):
    """ResNet32 @3x's programs: the state's own tensors hold the step's
    values, bit for bit `admm_update`'s."""
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan("resnet32", fmt, "3"))
    gen = torch.Generator().manual_seed(1)
    state = admm_init(params, program)
    for n in program.names:
        state.u[n] = 0.01 * torch.randn(params[n].shape, generator=gen)
    kw = dict(update_u=True, method="kernel", n_iter=6)
    want, want_res = admm_update(params, state, program, **kw)
    ids = {n: (id(state.z[n]), id(state.u[n])) for n in program.names}
    res = admm_update_(params, state, program, **kw)
    assert {n: (id(state.z[n]), id(state.u[n])) for n in program.names} == ids
    _equal_maps(state.z, want.z)
    _equal_maps(state.u, want.u)
    _equal_maps(res, want_res)
    assert int(state.nonfinite) == int(want.nonfinite) == 0
    before = state.nonfinite
    admm_update_(params, state, program, **kw)
    assert state.nonfinite is before


def test_a_captured_launch_counts_at_each_replay(monkeypatch):
    """Under capture a wrapper counts nothing; each replay of the graph
    adds the launches it captured."""
    def wrapper():
        pass
    wrapper.launches, wrapper.captured = 0, 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    launches.count_launch(wrapper)
    launches.count_launch(wrapper)
    assert (wrapper.launches, wrapper.captured) == (0, 2)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    launches.count_launch(wrapper)
    assert (wrapper.launches, wrapper.captured) == (1, 2)

    class Replayed:
        def replay(self):
            pass

    graph = object.__new__(capture._Graph)
    graph.graph, graph.launches = Replayed(), [(wrapper, 2)]
    for _ in range(3):
        graph.replay()
    assert wrapper.launches == 7


def test_vit_init_comes_from_the_generator_alone():
    """The seed gives the same ViT whatever the global RNG's state (the
    patch embedding drew from the global RNG before)."""
    torch.manual_seed(1)
    a = create_model("deit_tiny_patch16_224",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    torch.manual_seed(2)
    b = create_model("deit_tiny_patch16_224",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    _equal_maps(a, b)


def _parser(module, monkeypatch):
    """The parser `module.parse_args` builds (nothing is run)."""
    built = []

    def grab(self, args=None, namespace=None):
        built.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        module.parse_args([])
    monkeypatch.undo()
    return built[0]


def test_cli_flags_are_the_jax_clis_and_device(monkeypatch):
    jax_p = _parser(jax_cli, monkeypatch)
    port_p = _parser(port_cli, monkeypatch)

    def flags(p):
        return {o for a in p._actions for o in a.option_strings}

    assert flags(port_p) == flags(jax_p) | {"--device"}
    assert (jax_p.get_default("epochs_per_dispatch")
            == port_p.get_default("epochs_per_dispatch") == 8)
    assert TrainConfig().epochs_per_dispatch == 8


def test_cli_passes_the_flag_to_the_train_config(monkeypatch):
    seen = []
    monkeypatch.setattr(port_train, "train_model",
                        lambda cfg, **kw: (seen.append(cfg) or (None, [])))
    port_cli.main(["--device", "cpu", "--model", "resnet20",
                   "--epochs-per-dispatch", "3"])
    assert seen[0].epochs_per_dispatch == 3
