"""The port's op API gaps and utilities against the JAX package.

  * ``ops.resize.resize_trilinear`` against JAX's in float64 (1e-12; the
    same interpolation matrices, summed in another order), and the port's
    trilinear soft-argmin against the soft-argmin of its full resize
    (``tests/test_ops.py:423``'s identity).
  * ``ops.corr.corr1d(simfun=)`` and ``corr1d_reference`` against JAX in
    float64 (1e-12) with the cosine similarity of ``tests/test_ops.py:209``
    and the default dot product; a custom similarity takes the plain path
    on every device (forced to the kernel, a CPU tensor neither raises nor
    reaches the wrapper).
  * ``utils.evaluate`` (``evaluate_pair``, ``compute_errors``,
    ``warp_pixel_error``) against JAX's and ``tests/test_utils.py``'s
    goldens; ``utils.viz.save_grid`` with arrays and tensors;
    ``utils.benchtime`` on CPU tensors, and its refusal without a tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu.ops import corr as j_corr
from dsmnet_tpu.ops import resize as j_resize
from dsmnet_tpu.utils import evaluate as j_eval
from dsmnet_tpu_torch import config
from dsmnet_tpu_torch.ops import corr as t_corr
from dsmnet_tpu_torch.ops.regression import trilinear_soft_argmin
from dsmnet_tpu_torch.ops.resize import resize_trilinear
from dsmnet_tpu_torch.ops.softargmin import soft_argmin
from dsmnet_tpu_torch.utils import (
    compute_errors,
    evaluate_pair,
    time_op,
    time_pytree_step,
    warp_pixel_error,
)


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("shape,out", [((1, 4, 5, 6, 1), (12, 20, 24)),
                                       ((2, 3, 4, 7, 3), (9, 4, 13)),
                                       ((1, 1, 5, 6, 2), (4, 1, 6)),
                                       ((1, 2, 3, 4, 1), (2, 3, 4))])
def test_resize_trilinear_matches_jax_f64(shape, out, rng):
    x = rng.randn(*shape)
    with jax.enable_x64():
        want = np.asarray(j_resize.resize_trilinear(jnp.asarray(x), out))
    got = resize_trilinear(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape == (shape[0], *out, shape[-1])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_trilinear_soft_argmin_is_soft_argmin_of_resize(rng):
    cost = torch.from_numpy(rng.randn(2, 8, 6, 10, 1))
    ref = soft_argmin(resize_trilinear(cost, (32, 24, 40))[..., 0], negate=False)
    out = trilinear_soft_argmin(cost, (32, 24, 40))
    assert out.shape == ref.shape == (2, 24, 40, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def _cosine(xp):
    def sim(a, b):
        num = (a * b).sum(-1)
        norm = (lambda v: jnp.linalg.norm(v, axis=-1)) if xp == "jax" else \
            (lambda v: torch.linalg.vector_norm(v, dim=-1))
        return num / (norm(a) * norm(b) + 1e-8)
    return sim


@pytest.mark.parametrize("D,stride,k", [(5, 1, 1), (7, 2, 3), (20, 1, 1)])
@pytest.mark.parametrize("sim", ["cosine", "dot"])
def test_corr1d_simfun_matches_jax_f64(D, stride, k, sim, rng):
    fL, fR = rng.randn(2, 4, 12, 8), rng.randn(2, 4, 12, 8)
    j_sim, t_sim = (_cosine("jax"), _cosine("torch")) if sim == "cosine" else (None, None)
    with jax.enable_x64():
        want = np.asarray(j_corr.corr1d(jnp.asarray(fL), jnp.asarray(fR), D, stride, k,
                                        use_pallas=False, simfun=j_sim))
        want_ref = np.asarray(j_corr.corr1d_reference(jnp.asarray(fL), jnp.asarray(fR), D,
                                                      stride, j_sim))
    a, b = torch.from_numpy(fL), torch.from_numpy(fR)
    got = t_corr.corr1d(a, b, D, stride, k, simfun=t_sim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_corr.corr1d_reference(a, b, D, stride, t_sim).numpy(),
                               want_ref, rtol=1e-12, atol=1e-12)


def test_corr1d_custom_simfun_never_reaches_the_kernel(rng, monkeypatch):
    calls = []

    def wrapper(*args):
        calls.append(args)
        return t_corr.corr1d_plain(*args)

    monkeypatch.setattr(t_corr, "corr1d_kernel", wrapper)
    a, b = (torch.from_numpy(rng.randn(1, 3, 9, 4)) for _ in range(2))
    with config.implementation("kernel", ops=("corr1d",)):
        out = t_corr.corr1d(a, b, 4, simfun=_cosine("torch"))
        assert out.shape == (1, 3, 9, 4) and calls == []
        t_corr.corr1d(a, b, 4)  # the dot product reaches the kernel's wrapper
    assert len(calls) == 1


def test_evaluate_goldens_and_jax(rng):
    gt = np.zeros((8, 8), np.float32)
    gt[:, 4:] = 100.0
    d1, epe, pix = evaluate_pair(np.full((8, 8), 104.0, np.float32), gt)
    assert (d1, epe, pix) == (pytest.approx(0.0), pytest.approx(4.0), -1.0)
    assert evaluate_pair(np.ones((4, 4)), None) == (-1.0, -1.0, -1.0)
    errs = compute_errors(np.full((10,), 10.0), np.full((10,), 12.0))
    assert errs[:3] == (pytest.approx(0.2), pytest.approx(0.4), pytest.approx(2.0))
    assert errs[4] == pytest.approx(0.0) and errs[5] == 1.0

    h, w = 16, 48
    base = rng.rand(h, w + 5, 3)
    imL, imR = base[:, :w], base[:, 5:]
    gt = rng.rand(h, w) * 20
    gt[rng.rand(h, w) < 0.2] = 0
    pred = gt + rng.randn(h, w) * 3
    assert evaluate_pair(pred, gt, imL, imR) == j_eval.evaluate_pair(pred, gt, imL, imR)
    pos = np.abs(pred) + 0.1
    assert compute_errors(gt, pos) == j_eval.compute_errors(gt, pos)
    for d in (5.0, 8.0):
        assert warp_pixel_error(imL, imR, np.full((h, w), d)) == \
            j_eval.warp_pixel_error(imL, imR, np.full((h, w), d))
    assert warp_pixel_error(imL, imR, np.full((h, w), 5.0)) < 1e-3


def test_save_grid_and_benchtime(tmp_path, rng):
    from dsmnet_tpu_torch.utils.viz import save_grid

    p = str(tmp_path / "grid.png")
    save_grid(p, rng.rand(8, 8, 3), torch.from_numpy(rng.rand(1, 8, 8, 1)))
    assert (tmp_path / "grid.png").stat().st_size > 0

    x = torch.ones(256, 256)
    assert 0 < time_op(lambda a: a @ a, x, n_small=1, n_big=4, reps=1) < 1.0
    step = time_pytree_step(lambda c, a: {"w": c["w"] @ a}, {"w": x}, x, n_small=1, n_big=3,
                            reps=1)
    assert 0 < step < 1.0
    with pytest.raises(ValueError, match="no tensor"):
        time_op(lambda: None)
