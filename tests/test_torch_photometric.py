"""The port's self-supervised loss path against the JAX package, on the CPU
with the same numpy inputs (made from a seed) on both sides:

  * every finite-difference and smoothness primitive of ``ops/gradients``
    in float64 to 1e-12, and ``ssim_map`` in float64 to 1e-12 and in
    float32 to 2e-6 (its variances are differences of blurred moments:
    each side is ~1e-6 from float64, measured up to 1.03e-6); ``c_ds3`` of
    a constant image (JAX divides by a zero mean) gives NaN in the same
    places;
  * ``photometric_pyramid_loss`` for the four kinds with and without
    occlusion masking, in float64: a 7-level pyramid (levels 3-6 upsampled
    to level 2), crop windows at nonzero origins, and levels on both sides
    of the 1024-valid-pixel fallback; the value to 1e-10 and the gradient
    with respect to every level's disparity of both views (``jax.grad``
    against autograd) to 1e-9;
  * ``weight_common`` and the loss-name parser field by field;
  * the colour augmentation and ``_selfsup_views`` at nedge 0 and 64 with
    JAX's draws, recomputed from its key as its step splits it
    (``jax_step_draws``), injected.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu import losses as j_losses
from dsmnet_tpu.ops import gradients as j_grad
from dsmnet_tpu.ops import ssim as j_ssim
from dsmnet_tpu.ops import warp as j_warp
from dsmnet_tpu.train import color_aug as j_color_aug
from dsmnet_tpu.train import steps as j_steps
from dsmnet_tpu_torch import losses as t_losses
from dsmnet_tpu_torch.ops import gradients as t_grad
from dsmnet_tpu_torch.ops import ssim as t_ssim
from dsmnet_tpu_torch.train import SelfsupDraws, color_augment_batch
from dsmnet_tpu_torch.train import steps as t_steps


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_aug_draws(k_aug, n: int) -> SelfsupDraws:
    """JAX's colour-augmentation draws for a batch of ``n`` from ``k_aug``,
    split as ``color_aug.py:104-115`` splits it (eps left 0)."""
    kj, kl = jax.random.split(k_aug)

    def jitter_one(key):
        k_perm, k_u = jax.random.split(key)
        return (jax.random.permutation(k_perm, 4),
                jax.random.uniform(k_u, (4,), minval=-0.5, maxval=0.5))

    order, u = jax.vmap(jitter_one)(jax.random.split(kj, n))
    alpha = jax.vmap(lambda k: jax.random.normal(k, (3,)) * 0.1)(jax.random.split(kl, n))
    t = lambda a: torch.from_numpy(np.array(a))
    return SelfsupDraws(t(order).long(), t(u), t(alpha), torch.zeros(()))


def jax_step_draws(rng, step: int, n: int) -> SelfsupDraws:
    """The draws of JAX's self-supervised train step ``step`` with key
    ``rng`` (``steps.py:133-135``): the augmentation's and the warps' eps."""
    k_aug, k_eps = jax.random.split(jax.random.fold_in(rng, step))
    draws = jax_aug_draws(k_aug, n)
    draws.eps = torch.from_numpy(np.array(1e-4 * (jax.random.uniform(k_eps) + 0.1)))
    return draws


def _f64(fn, *arrays):
    with jax.enable_x64():
        return np.asarray(fn(*[jnp.asarray(a) for a in arrays]))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------------- primitives

_POSITIVE = lambda rng, *s: rng.uniform(0.5, 3.0, s)
# name -> operands: an image (N,H,W,3) and / or a disparity (N,H,W,1)
_PRIMITIVES = {
    "diff1_dx": lambda r: [r.randn(2, 7, 9, 3)],
    "diff1_dy": lambda r: [r.randn(2, 7, 9, 3)],
    "diff2_dx": lambda r: [r.randn(2, 7, 9, 3)],
    "diff2_dy": lambda r: [r.randn(2, 7, 9, 3)],
    "diff_z_dx": lambda r: [_POSITIVE(r, 2, 7, 9, 1)],
    "diff_z_dy": lambda r: [_POSITIVE(r, 2, 7, 9, 1)],
    "c_imdiff1": lambda r: [r.rand(2, 7, 9, 3), r.rand(2, 7, 9, 3)],
    "c_ds1": lambda r: [r.rand(2, 7, 9, 3), r.randn(2, 7, 9, 1) * 4],
    "c_ds2": lambda r: [r.rand(2, 7, 9, 3), r.randn(2, 7, 9, 1) * 4],
    # |ratio| above 10 at some pixels: the clip bites
    "c_ds3": lambda r: [r.rand(2, 7, 9, 3), r.randn(2, 7, 9, 1) * 20],
    "c_ds3t": lambda r: [r.rand(2, 7, 9, 3), r.randn(2, 7, 9, 1) * 20],
    "c_ds3t1": lambda r: [r.rand(2, 7, 9, 3), r.randn(2, 7, 9, 1) * 4],
}


@pytest.mark.parametrize("name", sorted(_PRIMITIVES))
def test_gradient_primitive_matches_jax_f64(name, rng):
    arrays = _PRIMITIVES[name](rng)
    ref = _f64(getattr(j_grad, name), *arrays)
    out = getattr(t_grad, name)(*_t(*arrays)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


def test_c_ds3_constant_image_nan_where_jax(rng):
    """Sample 0's image is constant: its mean |dI| is 0, and JAX's 0 / 0
    makes its whole map NaN; sample 1 stays finite."""
    img, disp = rng.rand(2, 6, 8, 3), rng.randn(2, 6, 8, 1) * 3
    img[0] = 0.4
    for name in ("c_ds3", "c_ds3t1"):
        ref = _f64(getattr(j_grad, name), img, disp)
        out = getattr(t_grad, name)(*_t(img, disp)).numpy()
        assert np.isnan(ref[0]).all() and np.isfinite(ref[1]).all()
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        np.testing.assert_allclose(out[1], ref[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-6)])
def test_ssim_map_matches_jax(dtype, tol, rng):
    """A related pair and an unrelated one (so SSIM spans its range), 3
    channels, H and W below and above the 11-tap window."""
    a = rng.rand(2, 9, 23, 3)
    b = np.clip(a + rng.randn(2, 9, 23, 3) * 0.1, 0, 1)
    b[1] = rng.rand(9, 23, 3)
    a, b = a.astype(dtype), b.astype(dtype)
    if dtype == np.float64:
        ref = _f64(j_ssim.ssim_map, a, b)
    else:
        ref = np.asarray(j_ssim.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    out = t_ssim.ssim_map(*_t(a, b))
    assert out.dtype == torch.from_numpy(a).dtype and out.shape == (2, 9, 23, 1)
    assert ref.min() < 0.3 and ref.max() > 0.9
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    if dtype == np.float32:  # both sides against float64
        exact = _f64(j_ssim.ssim_map, a.astype(np.float64), b.astype(np.float64))
        for y in (out.numpy(), ref):
            np.testing.assert_allclose(y, exact, rtol=tol, atol=tol)
    np.testing.assert_array_equal(t_ssim.gaussian_kernel_1d(), j_ssim.gaussian_kernel_1d())


# --------------------------------------------------------- pyramid loss

H0, W0, PAD = 72, 168, 24  # uncropped sources
CH, CW = 64, 128            # the crop: level 2 is 16 x 32 (512 < 1024 pixels)
X0, Y0 = 20, 5              # the left view's crop origin; the flipped one's mirrors it
SCALES = list(range(7))


def _texture(rng, h, w):
    """A smooth texture in [0, 1] (3 channels): SSIM of near-true warps is
    above the 0.75 gate, of wrong ones below."""
    t = rng.rand(h // 4 + 2, w // 4 + 2, 3)
    yy, xx = np.linspace(0, h // 4, h), np.linspace(0, w // 4, w)
    y0, x0 = np.floor(yy).astype(int), np.floor(xx).astype(int)
    fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
    t = (t[y0][:, x0] * (1 - fy) * (1 - fx) + t[y0 + 1][:, x0] * fy * (1 - fx)
         + t[y0][:, x0 + 1] * (1 - fy) * fx + t[y0 + 1][:, x0 + 1] * fy * fx)
    return t


def _scene(rng):
    """A consistent stereo pair: the right source a texture window, the left
    source that texture shifted by a row ramp of non-integer disparities
    (L(y, x) = R(y, x - d(y))); the crops and both views' disparity
    pyramids near the truth (noise of 0.4 px, the flipped view's offset
    by 1.2 px, so that the occlusion ramp's three pieces all occur)."""
    tex = _texture(rng, H0, W0 + 2 * PAD)
    d = np.linspace(6.037, 13.913, H0)
    cols = np.arange(W0)[None, :] + PAD
    def shifted(shift):
        xs = cols - shift[:, None]
        xi = np.floor(xs).astype(int)
        f = (xs - xi)[..., None]
        rows = np.arange(H0)[:, None]
        return tex[rows, xi] * (1 - f) + tex[rows, xi + 1] * f
    imR_src, imL_src = shifted(np.zeros(H0)), shifted(d)
    gt = np.broadcast_to(d[:, None], (H0, W0))
    x1 = W0 - X0 - CW  # the flipped crop's origin
    imL = imL_src[Y0:Y0 + CH, X0:X0 + CW]
    imL1 = imR_src[:, ::-1][Y0:Y0 + CH, x1:x1 + CW]
    gt0, gt1 = gt[Y0:Y0 + CH, X0:X0 + CW], gt[:, ::-1][Y0:Y0 + CH, x1:x1 + CW]
    def pyramid(g, offset):
        out = []
        for lvl in SCALES:
            s = g[::2 ** lvl, ::2 ** lvl][:CH >> lvl, :CW >> lvl]
            out.append((s + offset + rng.randn(*s.shape) * 0.4)[None, :, :, None])
        return out
    return dict(imR_src=imR_src[None], imL=imL[None], imR1_src=imL_src[:, ::-1][None].copy(),
                imL1=imL1[None].copy(), dispLs=pyramid(gt0, 0.0), dispL1s=pyramid(gt1, 1.2),
                left_top=(X0, Y0), left_top1=(x1, Y0))


def _jax_loss_and_grads(cfg, sc, weights, eps):
    def loss(dls, dl1s):
        return j_losses.photometric_pyramid_loss(
            cfg, jnp.asarray(sc["imR_src"]), jnp.asarray(sc["imL"]), dls, SCALES,
            sc["left_top"], jnp.asarray(sc["imR1_src"]), jnp.asarray(sc["imL1"]), dl1s,
            SCALES, sc["left_top1"], jnp.asarray(weights), eps=eps)

    with jax.enable_x64():
        dls = [jnp.asarray(d) for d in sc["dispLs"]]
        dl1s = [jnp.asarray(d) for d in sc["dispL1s"]]
        value, grads = jax.value_and_grad(loss, argnums=(0, 1))(dls, dl1s)
        return float(value), [np.asarray(g) for g in grads[0] + grads[1]]


_KINDS = [("common", {}), ("depthmono", {}), ("cap", dict(with_ds=True, with_lr=True)),
          ("sssmnet", {})]


@pytest.mark.parametrize("flag_mask", [False, True])
@pytest.mark.parametrize("kind,extra", _KINDS, ids=[k for k, _ in _KINDS])
def test_photometric_pyramid_loss_matches_jax_f64(kind, extra, flag_mask, rng):
    sc = _scene(rng)
    weights = j_losses.weight_adjust_levels(4, 7, 10).astype(np.float64)  # mid-sweep
    eps = 7.3e-5
    ref, ref_grads = _jax_loss_and_grads(j_losses.PhotoLossConfig(kind, flag_mask, **extra),
                                         sc, weights, eps)
    dls = [torch.from_numpy(d).requires_grad_() for d in sc["dispLs"]]
    dl1s = [torch.from_numpy(d).requires_grad_() for d in sc["dispL1s"]]
    imR_src, imL, imR1_src, imL1 = _t(sc["imR_src"], sc["imL"], sc["imR1_src"], sc["imL1"])
    out = t_losses.photometric_pyramid_loss(
        t_losses.PhotoLossConfig(kind, flag_mask, **extra), imR_src, imL, dls, SCALES,
        sc["left_top"], imR1_src, imL1, dl1s, SCALES, sc["left_top1"], weights,
        eps=torch.tensor(eps, dtype=torch.float64))
    out.backward()
    np.testing.assert_allclose(out.item(), ref, rtol=1e-10)
    for i, (t, g) in enumerate(zip(dls + dl1s, ref_grads)):
        assert np.abs(g).max() > 0, i
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-9, atol=1e-9 * np.abs(g).max(),
                                   err_msg=f"d loss / d disparity {i}")


def test_scene_covers_gate_fallback_and_occlusion(rng):
    """The scene of the pyramid test reaches both sides of the SSIM gate,
    of the 1024-pixel fallback and every piece of the occlusion weight."""
    sc = _scene(rng)
    with jax.enable_x64():
        sims, counts, pieces = [], [], set()
        for lvl in (0, 2):
            dl = jnp.asarray(sc["dispLs"][lvl])
            dl1 = jnp.asarray(sc["dispL1s"][lvl])
            warp = j_warp.imwarp(jnp.asarray(sc["imR_src"]), dl, False, sc["left_top"], 2 ** lvl)
            im = jnp.asarray(sc["imL"])[:, ::2 ** lvl, ::2 ** lvl]
            mask = warp[..., :1] != 0
            counts.append(int(mask.sum()))
            ssim = j_ssim.ssim_map(im, warp)
            sims.append(float((ssim * mask).sum() / mask.sum()))
            wc = np.asarray(j_losses.weight_common(dl, j_warp.warp_disparity(dl1, dl), 2 ** lvl))
            pieces |= {1.0 if v == 1.0 else 0.01 if v == 0.01 else 0.5 for v in wc.ravel()}
        bad = jnp.full_like(jnp.asarray(sc["dispLs"][0]), 30.5)
        warp = j_warp.imwarp(jnp.asarray(sc["imR_src"]), bad, False, sc["left_top"])
        low = float(j_ssim.ssim_map(jnp.asarray(sc["imL"]), warp).mean())
    assert counts[0] >= 1024 > counts[1], counts
    assert max(sims) > 0.75 > low, (sims, low)
    assert pieces == {1.0, 0.5, 0.01}, pieces


def test_weight_common_and_loss_names_match_jax(rng):
    d, dw = rng.rand(2, 5, 7, 1) * 10, rng.rand(2, 5, 7, 1) * 10
    for factor in (1, 4):
        np.testing.assert_array_equal(
            t_losses.weight_common(*_t(d, dw), factor).numpy(),
            _f64(lambda a, b: j_losses.weight_common(a, b, factor), d, dw))
    for name in ("supervised", "depthmono-mask", "Cap_ds-mask", "Cap_ds_lr", "SsSMnet-mask",
                 "SsSMnet", "Cap_lr", "common", "common-mask", "depthmono"):
        t, j = t_losses.parse_loss_name(name, 7, 10), j_losses.parse_loss_name(name, 7, 10)
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        assert (t.name, t.supervised, t.count_levels, t.maxepoch_weight_adjust, t.flag_mask) \
            == (j.name, j.supervised, j.count_levels, j.maxepoch_weight_adjust, j.flag_mask)
        assert (t.photo is None) == (j.photo is None), name
        if t.photo is not None:
            assert dataclasses.asdict(t.photo) == dataclasses.asdict(j.photo), name
    for bad in ("bogus", "nonsense-mask"):
        with pytest.raises(ValueError, match="unknown loss"):
            t_losses.parse_loss_name(bad)


# ------------------------------------------------- augmentation and views


def test_color_augment_matches_jax_f64(rng):
    """Four samples, so that different op orders meet in one batch; the
    same result without draws (normalization alone) as JAX's jitter=False."""
    batch = rng.rand(4, 6, 10, 6)
    with jax.enable_x64():
        key = jax.random.PRNGKey(3)
        ref = np.asarray(j_color_aug.color_augment_batch(key, jnp.asarray(batch)))
        plain = np.asarray(j_color_aug.color_augment_batch(key, jnp.asarray(batch), False))
        draws = jax_aug_draws(key, 4)
    assert len({tuple(o) for o in draws.order.tolist()}) > 1
    (x,) = _t(batch)
    np.testing.assert_allclose(color_augment_batch(draws, x).numpy(), ref, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(color_augment_batch(None, x).numpy(), plain, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("nedge,channels", [(0, 7), (64, 6)])
def test_selfsup_views_match_jax_f64(nedge, channels, rng):
    batch = rng.rand(2, 144, 160, channels)
    with jax.enable_x64():
        k_aug = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), 3))[0]
        ref = {k: np.asarray(v) for k, v in j_steps._selfsup_views(
            jnp.asarray(batch), nedge, k_aug, jitter=True).items()}
        draws = jax_aug_draws(k_aug, 2)
    out = t_steps._selfsup_views(*_t(batch), nedge, draws)
    assert set(out) == set(ref) and ("dispL" in out) == (channels == 7)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-12, atol=1e-12, err_msg=k)
