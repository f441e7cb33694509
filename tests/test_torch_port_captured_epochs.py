"""The captured X-step of the PyTorch port (`train/capture.py`'s
`CapturedStep`, `run_epoch` and `StaticBatch`; Mixup/CutMix drawn on the
device, `data/augment.py`; rho as a 0-d tensor) on the CPU at a tiny size.
On the CPU the step runs eagerly, so these tests hold its code to the
eager reference loop (`train_model(..., eager=True)`, each step on its own
batch tensors) bit for bit; the card replays it from a CUDA graph
(`chip_smoke.py`'s captured-step gate).

* The device sampler: Beta(a, a) by Johnk's method over a fixed number of
  candidates against its distribution at a = 0.2, 0.8, 1.0 and 2.0, its
  failed-draw count (0, and counted where candidates are too few), the
  CutMix box and CutMix's share where both are on.
* `mixup_cutmix` on tensor draws against the JAX package's on the same
  draws, for the three alpha settings.
* `admm_penalty` with a 0-d tensor rho against the float one.
* The per-epoch route against the eager loop: ResNet32 TK@3x ADMM (and
  with the late rho boost inside the run), a 2-block ViT with
  Mixup/CutMix, and the streamed route through the static buffers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from dnn_compression_tensor_admm_tpu.data import augment as jaug
from dnn_compression_tensor_admm_tpu_torch.admm import (admm_init,
                                                        admm_penalty,
                                                        build_program)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan
from dnn_compression_tensor_admm_tpu_torch.data import augment as aug
from dnn_compression_tensor_admm_tpu_torch.data import records
from dnn_compression_tensor_admm_tpu_torch.data.datasets import load_dataset
from dnn_compression_tensor_admm_tpu_torch.models import create_model
from dnn_compression_tensor_admm_tpu_torch.models.vit import VisionTransformer
from dnn_compression_tensor_admm_tpu_torch.train import (TrainConfig, capture,
                                                         engine)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other pytest
    workers and XLA's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the device sampler


@pytest.mark.parametrize("alpha", [0.2, 0.8, 1.0, 2.0])
def test_beta_draws_follow_beta_with_no_failed_draw(alpha):
    gen = torch.Generator().manual_seed(int(alpha * 10))
    values, failed = aug.sample_beta(alpha, gen, (2000,))
    assert values.dtype == torch.float32 and values.shape == (2000,)
    assert int(failed) == 0
    assert scipy.stats.kstest(values.numpy(),
                              scipy.stats.beta(alpha, alpha).cdf).pvalue > 1e-3


def test_failed_draws_are_counted():
    """With one candidate at a = 2, 5/6 of the draws find none accepted:
    the count says so (the values stay in [0, 1])."""
    gen = torch.Generator().manual_seed(1)
    n = 4000
    values, failed = aug.sample_beta(2.0, gen, (n,), candidates=1)
    assert abs(int(failed) / n - 5 / 6) < 4 * np.sqrt(5 / 36 / n)
    assert 0 <= values.min() and values.max() <= 1


@pytest.mark.parametrize("mixup,cutmix", [(0.8, 0.0), (0.0, 1.0), (0.8, 1.0)])
def test_mix_draws_are_tensors_on_the_generators_device(mixup, cutmix):
    """Every number drawn is a 0-d tensor (no host read); the branch is a
    bool where one alpha is on, else CutMix in SWITCH_PROB of the batches;
    the box lies in the image; no failed draw."""
    gen = torch.Generator().manual_seed(2)
    h, w = 24, 32
    draws = [aug.draw_mix(gen, h, w, mixup_alpha=mixup, cutmix_alpha=cutmix)
             for _ in range(400)]
    for d in draws:
        for t in (d.lam_mix, d.lam_cut, d.cy, d.cx, d.failed):
            assert isinstance(t, torch.Tensor) and t.dim() == 0
        y0, y1, x0, x1 = (int(t) for t in aug.cutmix_box(d.lam_cut, d.cy,
                                                         d.cx, h, w))
        assert 0 <= y0 <= y1 <= h and 0 <= x0 <= x1 <= w
    assert sum(int(d.failed) for d in draws) == 0
    if mixup and cutmix:
        share = np.mean([bool(d.use_cutmix) for d in draws])
        assert abs(share - aug.SWITCH_PROB) < 4 * np.sqrt(0.25 / len(draws))
    else:
        assert all(d.use_cutmix is (cutmix > 0) for d in draws)


# --------------------------------------------------------------------------
# Mixup/CutMix on tensor draws against the JAX package's


B, H, W, C = 4, 16, 16, 3


def _tensor_draws(key, mixup, cutmix):
    """`mixup_cutmix`'s draws from its JAX key as the engine hands them
    over: 0-d tensors, the branch a bool where one alpha is on."""
    k_lam, k_switch, k_box = jax.random.split(key, 3)
    if mixup > 0 and cutmix > 0:
        use_cutmix = torch.tensor(bool(jax.random.bernoulli(
            k_switch, aug.SWITCH_PROB)))
    else:
        use_cutmix = cutmix > 0
    a_mix, a_cut = max(mixup, 1e-6), max(cutmix, 1e-6)
    ky, kx = jax.random.split(k_box)

    def t(v):
        return torch.from_numpy(np.array(v))

    return aug.MixDraws(use_cutmix, t(jax.random.beta(k_lam, a_mix, a_mix)),
                        t(jax.random.beta(k_lam, a_cut, a_cut)),
                        t(jax.random.randint(ky, (), 0, H)).long(),
                        t(jax.random.randint(kx, (), 0, W)).long(),
                        torch.zeros((), dtype=torch.long))


@pytest.mark.parametrize("mixup,cutmix", [(0.8, 0.0), (0.0, 1.0), (0.8, 1.0)])
def test_mixup_cutmix_on_tensor_draws_matches_jax(mixup, cutmix):
    x = np.random.RandomState(1).uniform(0, 1, (B, H, W, C)).astype(
        np.float32)
    labels = np.array([3, 1, 4, 1], np.int32)
    branches = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        jx, jy = jaug.mixup_cutmix(jnp.asarray(x), jnp.asarray(labels), key,
                                   num_classes=10, mixup_alpha=mixup,
                                   cutmix_alpha=cutmix, smoothing=0.1)
        draws = _tensor_draws(key, mixup, cutmix)
        branches.add(bool(draws.use_cutmix))
        tx, ty = aug.mixup_cutmix(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  torch.from_numpy(labels), draws,
                                  num_classes=10, smoothing=0.1)
        # the same float32 products, sums and box: within 1e-6
        np.testing.assert_allclose(tx.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jx), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6,
                                   rtol=0)
    want = {True, False} if mixup and cutmix else {cutmix > 0}
    assert branches == want


# --------------------------------------------------------------------------
# rho read on the device


@pytest.mark.parametrize("rho", [1e-3, 5e-3, 0.1 / 3])
def test_admm_penalty_with_a_tensor_rho_is_the_floats_bit_for_bit(rho):
    model = create_model("resnet32", generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan("resnet32", "tk", "3"))
    state = admm_init(params, program)
    gen = torch.Generator().manual_seed(1)
    for n in program.names:
        state.z[n] = torch.randn(params[n].shape, generator=gen)
        state.u[n] = 0.01 * torch.randn(params[n].shape, generator=gen)
    want = admm_penalty(params, state, program, rho)
    got = admm_penalty(params, state, program,
                       torch.full((), rho, dtype=torch.float32))
    assert got.dtype == want.dtype and torch.equal(got, want)


# --------------------------------------------------------------------------
# the captured route's step, eagerly on the CPU, against the eager loop


def _run(cfg, eager, **kw):
    """train_model -> (model, history, the ADMM state its Z/U steps
    wrote, the log's lines)."""
    seen, lines = {}, []
    update = engine.admm_update_

    def keep(params, state, program, **k):
        seen["state"] = state
        return update(params, state, program, **k)

    engine.admm_update_ = keep
    try:
        model, hist = engine.train_model(
            TrainConfig(**{**vars(cfg), "print_fn": lines.append}),
            eager=eager, **kw)
    finally:
        engine.admm_update_ = update
    return model, hist, seen.get("state"), lines


def _equal_runs(a, b):
    (m1, h1, s1, _), (m2, h2, s2, _) = a, b
    for key in ("train_loss", "train_acc", "test_loss",
                "admm_residual_total", "rho", "mix_failed_draws"):
        assert [h.get(key) for h in h1] == [h.get(key) for h in h2], key
    sd1, sd2 = m1.state_dict(), m2.state_dict()
    assert sorted(sd1) == sorted(sd2)
    for n in sd1:
        assert torch.equal(sd1[n], sd2[n]), n
    if s1 is not None:
        for n in s1.z:
            assert torch.equal(s1.z[n], s2.z[n]), n
            assert torch.equal(s1.u[n], s2.u[n]), n


RESNET = dict(model="resnet32", dataset="synthetic-cifar10", synthetic_size=64,
              batch_size=16, steps_per_epoch=3, epochs=2, admm=True, fmt="tk",
              ratio="3", admm_hooi_iters=2, admm_method="kernel",
              compute_dtype=None, smoothing=0.1, device="cpu",
              epochs_per_dispatch=1)


@pytest.mark.parametrize("extra,max_epochs", [
    (dict(), None),
    # the boost past 85% of 1 epoch: epoch 2 at 5 rho, inside the run
    (dict(epochs=1, adjust_rho_late=True, sampling="shuffle"), 2),
], ids=["resnet32-tk3", "resnet32-tk3-rho-boost"])
def test_per_epoch_step_is_the_eager_loop_bit_for_bit(extra, max_epochs):
    cfg = TrainConfig(**{**RESNET, **extra})
    got = _run(cfg, False, max_epochs=max_epochs)
    want = _run(cfg, True, max_epochs=max_epochs)
    _equal_runs(got, want)
    hist = got[1]
    assert len(hist) == 2
    if "adjust_rho_late" in extra:
        assert [h["rho"] for h in hist] == [1e-3, 5e-3]
    # the CPU runs the step eagerly, and says so once
    assert [l for l in got[3] if "runs eagerly" in l] == [
        "the X-step runs eagerly (no card: CUDA graphs need one)"]
    assert [l for l in want[3] if "runs eagerly" in l] == [
        "the X-step runs eagerly (the eager reference loop)"]


def test_vit_with_mixup_cutmix_is_the_eager_loop_bit_for_bit(monkeypatch):
    """A 2-block ViT (embed 48, 32 x 32 images, drop path drawn from the
    device generator) with Mixup/CutMix and AdamW: the rows' failed-draw
    count is 0 and every step's draws are the loop's."""
    def vit(name, num_classes, generator, **kw):
        return VisionTransformer(img_size=32, embed_dim=48, depth=2,
                                 num_heads=3, num_classes=num_classes,
                                 drop_path_rate=0.1, generator=generator)

    monkeypatch.setattr(engine, "create_model", vit)
    cfg = TrainConfig(**{**RESNET, "admm": False, "opt": "adamw",
                         "lr": 5e-4, "mixup": 0.8, "cutmix": 1.0})
    seen = []
    mixing = engine.mixup_cutmix

    def observed(x, labels, draws, **kw):
        seen.append(bool(draws.use_cutmix))
        return mixing(x, labels, draws, **kw)

    monkeypatch.setattr(engine, "mixup_cutmix", observed)
    got = _run(cfg, False)
    want = _run(cfg, True)
    _equal_runs(got, want)
    assert [h["mix_failed_draws"] for h in got[1]] == [0, 0]
    assert seen[:6] == seen[6:] and set(seen) == {True, False}


def test_streamed_step_through_the_static_buffers_is_the_direct_step(
        tmp_path):
    """The streamed route (one loader thread: its order is the seed's)
    through `StaticBatch`'s buffers against the loop's direct batches,
    with Mixup/CutMix, RandAugment and TT ADMM; and a buffer that is
    not refreshed is caught by that comparison."""
    shards = tmp_path / "shards"
    x, y, _ = load_dataset("synthetic-cifar10", True, 48)
    records.write_shards(x, y, str(shards), 24, "train")
    cfg = TrainConfig(**{**RESNET, "model": "resnet20", "fmt": "tt",
                         "shard_dir": str(shards), "loader_workers": 1,
                         "batch_size": 8, "mixup": 0.8, "cutmix": 1.0,
                         "randaug_magnitude": 9.0})
    got = _run(cfg, False)
    want = _run(cfg, True)
    _equal_runs(got, want)
    assert all(h["loader_host_ms_per_batch"] > 0 for h in got[1])

    load = capture.StaticBatch.load

    def first_only(self, xb, yb):
        if self.x is None:
            load(self, xb, yb)

    capture.StaticBatch.load = first_only
    try:
        stale = _run(cfg, False)
    finally:
        capture.StaticBatch.load = load
    assert stale[1][0]["train_loss"] != want[1][0]["train_loss"]
