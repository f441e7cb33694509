"""The port's ViT training recipe (`data/augment.py`, the soft-target loss,
the sampling of `data/device_pipeline.py`) against the JAX package's on
the same numpy inputs. The JAX functions draw from a key; the test
reproduces those draws with `jax.random` (the same splits) and feeds them
to the port's apply functions, which take their draws as arguments. The
port's own draws are held against their distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from dnn_compression_tensor_admm_tpu.data import augment as jaug
from dnn_compression_tensor_admm_tpu.data import device_pipeline as jdp
from dnn_compression_tensor_admm_tpu.train import losses as jlosses
from dnn_compression_tensor_admm_tpu_torch.data import augment as aug
from dnn_compression_tensor_admm_tpu_torch.data import device_pipeline as dp
from dnn_compression_tensor_admm_tpu_torch.train.losses import (
    soft_target_cross_entropy)

B, H, W, C = 4, 16, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests share the CPU with other workers, and
    the draws' many small ops stall on a thread pool that waits for cores
    the other workers hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed=0, shape=(B, H, W, C)):
    """Float images in [0, 1], NHWC (the JAX side's layout)."""
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _mix_draws(key, mixup, cutmix):
    """`mixup_cutmix`'s draws from its key, as the JAX function takes them."""
    k_lam, k_switch, k_box = jax.random.split(key, 3)
    if mixup > 0 and cutmix > 0:
        use_cutmix = bool(jax.random.bernoulli(k_switch, aug.SWITCH_PROB))
    else:
        use_cutmix = cutmix > 0
    a_mix, a_cut = max(mixup, 1e-6), max(cutmix, 1e-6)
    ky, kx = jax.random.split(k_box)
    return aug.MixDraws(
        use_cutmix, float(jax.random.beta(k_lam, a_mix, a_mix)),
        float(jax.random.beta(k_lam, a_cut, a_cut)),
        int(jax.random.randint(ky, (), 0, H)),
        int(jax.random.randint(kx, (), 0, W)))


@pytest.mark.parametrize("mixup,cutmix", [(0.8, 0.0), (0.0, 1.0), (0.8, 1.0)])
def test_mixup_cutmix_matches_jax(mixup, cutmix):
    x = _images(1)
    labels = np.array([3, 1, 4, 1], np.int32)
    branches = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        jx, jy = jaug.mixup_cutmix(jnp.asarray(x), jnp.asarray(labels), key,
                                   num_classes=10, mixup_alpha=mixup,
                                   cutmix_alpha=cutmix, smoothing=0.1)
        draws = _mix_draws(key, mixup, cutmix)
        branches.add(draws.use_cutmix)
        tx, ty = aug.mixup_cutmix(_nchw(x), torch.from_numpy(labels), draws,
                                  num_classes=10, smoothing=0.1)
        # the same float32 products and sums: within 1e-6 (lambda enters
        # as a Python number, rounded to float32 once)
        np.testing.assert_allclose(_nhwc(tx), np.asarray(jx), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(ty.sum(-1).numpy(), 1.0, atol=1e-6)
    want = {True, False} if mixup and cutmix else {cutmix > 0}
    assert branches == want


def test_soft_target_cross_entropy_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    soft = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    j = jlosses.soft_target_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(soft))
    t = soft_target_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(soft))
    assert abs(float(j) - t.item()) < 1e-6  # f32 log-softmax, one mean


WARPS = {8: jaug._rotate_mat, 9: jaug._shear_x_mat, 10: jaug._shear_y_mat,
         11: jaug._translate_x_mat, 12: jaug._translate_y_mat}
COLOURS = (jaug._autocontrast, jaug._posterize, jaug._solarize,
           jaug._solarize_add, jaug._color, jaug._contrast, jaug._brightness,
           jaug._sharpness)


@pytest.mark.parametrize("op", range(len(aug.OPS)),
                         ids=lambda k: aug.OPS[k])
def test_rand_augment_op_matches_jax(op):
    x = _images(3)
    levels = np.array([0.0, 3.7, 9.0, 10.0], np.float32)
    if op in WARPS:
        for sign in (1.0, -1.0):
            want = np.stack([np.asarray(jaug._affine_warp(
                jnp.asarray(x[i]), WARPS[op](sign * levels[i])))
                for i in range(B)])
            mat = aug._affine(torch.full((B,), op),
                              sign * torch.from_numpy(levels))
            got = _nhwc(aug.affine_warp(_nchw(x), mat))
            # bilinear taps in float32; cos/sin of the angle may differ in
            # their last bit between XLA and torch: within 1e-5
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    want = np.stack([np.asarray(COLOURS[op](jnp.asarray(x[i]), levels[i]))
                     for i in range(B)])
    got = _nhwc(aug.COLOUR_OPS[op](_nchw(x),
                                   torch.from_numpy(levels)[:, None, None,
                                                            None]))
    if aug.OPS[op] == "posterize":  # floors of the same float32 products
        np.testing.assert_array_equal(got, want)
    else:  # means and the 3 x 3 blur summed in another order: 1e-6
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _rand_augment_draws(key, magnitude=9.0, mag_std=0.5):
    """`rand_augment`'s per-image draws from its key."""
    op, level, sign = [], [], []
    for k in jax.random.split(key, B):
        rounds = []
        for kr in jax.random.split(k, aug.ROUNDS):
            k_op, k_mag, k_sign = jax.random.split(kr, 3)
            rounds.append((
                int(jax.random.randint(k_op, (), 0, len(aug.OPS))),
                float(jnp.clip(magnitude + mag_std * jax.random.normal(k_mag),
                               0.0, aug.MAX_LEVEL)),
                1.0 if bool(jax.random.bernoulli(k_sign)) else -1.0))
        op.append([r[0] for r in rounds])
        level.append([r[1] for r in rounds])
        sign.append([r[2] for r in rounds])
    return aug.RandAugmentDraws(torch.tensor(op), torch.tensor(level),
                                torch.tensor(sign))


def test_rand_augment_and_erasing_match_jax():
    x = _images(4)
    ops_seen = set()
    for seed in range(4):
        key = jax.random.PRNGKey(10 + seed)
        want = np.asarray(jaug.rand_augment(jnp.asarray(x), key))
        draws = _rand_augment_draws(key)
        ops_seen |= set(draws.op.flatten().tolist())
        got = _nhwc(aug.rand_augment(_nchw(x), draws))
        # two rounds of warp and colour op, each as above: within 1e-5
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert len(ops_seen) >= 8

    # RandomErasing at JAX's draws and JAX's noise
    xe = np.random.RandomState(5).standard_normal((B, H, W, C)).astype(
        np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(20 + seed)
        want = np.asarray(jaug.random_erasing(jnp.asarray(xe), key, prob=0.5))
        k_apply, k_area, k_aspect, k_y, k_x, k_noise = jax.random.split(key, 6)
        draws = aug.EraseDraws(
            torch.from_numpy(np.array(
                jax.random.bernoulli(k_apply, 0.5, (B,)))),
            torch.from_numpy(np.array(jax.random.uniform(
                k_area, (B,), minval=0.02, maxval=1 / 3))),
            torch.from_numpy(np.array(jax.random.uniform(
                k_aspect, (B,), minval=jnp.log(0.3), maxval=jnp.log(10 / 3)))),
            torch.from_numpy(np.array(jax.random.uniform(k_y, (B,)))),
            torch.from_numpy(np.array(jax.random.uniform(k_x, (B,)))),
            _nchw(np.asarray(jax.random.normal(k_noise, xe.shape))))
        got = _nhwc(aug.random_erasing(_nchw(xe), draws))
        # the same boxes (float32 sqrt and round), the same noise: equal
        np.testing.assert_array_equal(got, want)


def test_port_draws_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    n = 2000
    lams, failed = aug.sample_beta(0.8, gen, (n,))
    assert int(failed) == 0
    assert scipy.stats.kstest(lams.numpy(),
                              scipy.stats.beta(0.8, 0.8).cdf).pvalue > 1e-3
    # CutMix at alpha 1: lambda uniform, the box's area 1 - lambda of the
    # image up to the truncation of its sides (before clipping)
    h = w = 224
    cut = [aug.draw_mix(gen, h, w, mixup_alpha=0.0, cutmix_alpha=1.0)
           for _ in range(n)]
    assert all(d.use_cutmix is True for d in cut)
    assert sum(int(d.failed) for d in cut) == 0
    lam_cut = np.array([float(d.lam_cut) for d in cut])
    assert scipy.stats.kstest(lam_cut, "uniform").pvalue > 1e-3
    for d, lam in zip(cut, lam_cut):
        side = np.sqrt(np.float32(1) - np.float32(lam))
        sides = int(np.float32(h) * side) * int(np.float32(w) * side)
        area = sides / (h * w)
        assert (1 - lam) - 2 * side / h - 1e-6 <= area <= 1 - lam
        y0, y1, x0, x1 = (int(t) for t in aug.cutmix_box(d.lam_cut, d.cy,
                                                         d.cx, h, w))
        assert 0 <= y0 <= y1 <= h and 0 <= x0 <= x1 <= w
        assert (y1 - y0) * (x1 - x0) <= sides  # in integers: no rounding
    both = [aug.draw_mix(gen, h, w, mixup_alpha=0.8, cutmix_alpha=1.0)
            for _ in range(n)]
    share = np.mean([bool(d.use_cutmix) for d in both])
    assert abs(share - 0.5) < 4 * np.sqrt(0.25 / n)
    # RandomErasing: applied with its probability; area and log aspect
    # ratio uniform in their ranges
    e = aug.draw_random_erasing((20000, 1, 2, 2), gen, prob=0.25)
    p = e.apply.float().mean().item()
    assert abs(p - 0.25) < 4 * np.sqrt(0.25 * 0.75 / 20000)
    a0, a1 = aug.ERASE_AREA
    assert scipy.stats.kstest(e.area.numpy(), "uniform",
                              args=(a0, a1 - a0)).pvalue > 1e-3
    lo, hi = np.log(aug.ERASE_ASPECT[0]), np.log(aug.ERASE_ASPECT[1])
    assert scipy.stats.kstest(e.log_ratio.numpy(), "uniform",
                              args=(lo, hi - lo)).pvalue > 1e-3
    # RandAugment: ops uniform over the 13, levels clip(9 + 0.5 N)
    r = aug.draw_rand_augment(20000, gen, magnitude=9.0, mag_std=0.5)
    counts = np.bincount(r.op.flatten().numpy(), minlength=len(aug.OPS))
    assert scipy.stats.chisquare(counts).pvalue > 1e-3
    assert abs(r.level.mean().item() - 9.0) < 0.02
    assert abs(r.sign.mean().item()) < 0.02


def test_repeated_and_perm_sampling_match_jax():
    n, batch, repeats = 50, 12, 3
    images = np.arange(n, dtype=np.int32)
    labels = 100 + images
    perm = np.random.RandomState(6).permutation(n)
    for step in range(7):
        # the shuffled copy's contiguous repeated batch
        jx, jy = jdp.batch_at_repeated(jnp.asarray(images[perm]),
                                       jnp.asarray(labels[perm]), step, batch,
                                       repeats)
        got = dp.batch_at_repeated(torch.from_numpy(perm), step, batch,
                                   repeats).numpy()
        np.testing.assert_array_equal(got, np.asarray(jx))
        np.testing.assert_array_equal(labels[got], np.asarray(jy))
        # the 'perm' step of the JAX engine's one_step, repeated or not
        for r in (0, repeats):
            base = -(-batch // r) if r > 1 else batch
            start = (step * base) % max(n - base + 1, 1)
            want = perm[start:start + base]
            if r > 1:
                want = np.repeat(want, r)[:batch]
            np.testing.assert_array_equal(
                dp.batch_at_views(torch.from_numpy(perm), step, batch, r).numpy(),
                want)
    # with replacement: ceil(B / repeats) draws, each in `repeats` slots
    key = jax.random.PRNGKey(7)
    jx, _ = jdp.sample_batch_repeated(jnp.asarray(images), jnp.asarray(labels),
                                      key, 10, repeats)
    base = np.asarray(jax.random.randint(key, (dp.pl_cdiv(10, repeats),), 0,
                                         n))
    np.testing.assert_array_equal(np.asarray(jx), np.repeat(base, 3)[:10])
    gen = torch.Generator().manual_seed(0)
    idx = dp.sample_batch_repeated(n, gen, 10, repeats).numpy()
    assert idx.shape == (10,) and ((0 <= idx) & (idx < n)).all()
    np.testing.assert_array_equal(idx, np.repeat(idx[::3], 3)[:10])
    assert dp.pl_cdiv(10, 3) == jdp.pl_cdiv(10, 3) == 4
