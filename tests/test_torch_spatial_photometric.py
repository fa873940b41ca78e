"""The self-supervised loss's ops under spatial (H) sharding, on the CPU:
ranks are processes on a gloo group (``torch_parallel_ranks.py``), each
holding its data index's images and a band of their rows, and the JAX op
on the whole tensor is the reference, in float64 at 1e-9 relative.

Every check runs on a (1, 2) mesh (one data index holds both images) and
on a (2, 2) mesh whose data indices hold different images, so that a
per-image statistic summed over the whole mesh, not over the ``model``
group, fails:

  * ``ssim_map`` (its 11-tap blur reads 5 rows of each neighbouring band);
  * ``diff2_dy``, ``diff_z_dy`` (a ratio: its gradients at the band
    edges must be finite), ``c_ds1``, ``c_ds2``, ``c_ds3``, ``c_ds3t1``
    (the per-image mean |dI| of their edge weights) and ``c_imdiff1``,
    each with the gradient of sum(out * g) with respect to its band;
  * ``imwarp`` of a band of the crop from the whole, uncropped source at
    origin (nedge, nedge + lo): the horizontal fast path, never the
    generic one, in it and in every warp of the losses;
  * ``photometric_pyramid_loss`` of ``common``, ``depthmono``,
    ``Cap_ds_lr`` and ``SsSMnet``, with and without ``-mask``, at a border
    of 8 pixels: the ranks' shares summed against JAX's loss, and the
    gradients with respect to both views' disparity bands against
    ``jax.grad`` of the whole; a level above 0 inside a band raises.

Both rank groups run beside the JAX references (module fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu import losses as j_losses
from dsmnet_tpu.ops import gradients as j_grad
from dsmnet_tpu.ops import ssim as j_ssim
from dsmnet_tpu.ops import warp as j_warp
from test_torch_photometric import _texture
from torch_parallel_ranks import Ranks

REL = 1e-9
N, CH, CW, NEDGE = 2, 24, 40, 8  # two images; the crop; its border in the sources
OPS = {  # name -> (operands (N, 16, 9, C), the operand the gradient is taken for)
    "diff2_dy": (lambda r: [r.randn(N, 16, 9, 3)], 0),
    "diff_z_dy": (lambda r: [r.uniform(0.5, 3.0, (N, 16, 9, 1))], 0),
    "c_ds1": (lambda r: [r.rand(N, 16, 9, 3), r.randn(N, 16, 9, 1) * 4], 1),
    "c_ds2": (lambda r: [r.rand(N, 16, 9, 3), r.randn(N, 16, 9, 1) * 4], 1),
    # |ratio| above 10 at some pixels: the clip bites
    "c_ds3": (lambda r: [r.rand(N, 16, 9, 3), r.randn(N, 16, 9, 1) * 20], 1),
    "c_ds3t1": (lambda r: [r.rand(N, 16, 9, 3), r.randn(N, 16, 9, 1) * 4], 1),
    "c_imdiff1": (lambda r: [r.rand(N, 16, 9, 3), r.rand(N, 16, 9, 3)], 1),
}
LOSS_NAMES = [f"{k}{m}" for k in ("common", "depthmono", "Cap_ds_lr", "SsSMnet")
              for m in ("", "-mask")]
MESHES = {"1x2": 2, "2x2": 4}  # mesh -> ranks


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _scene(rng):
    """Two consistent stereo pairs of different textures and disparity
    ramps, uncropped (the sources) and cropped by NEDGE (the targets), and
    both views' disparities near the truth (the flipped view's offset by
    1.2 px, so that every piece of the occlusion weight occurs)."""
    h0, w0 = CH + 2 * NEDGE, CW + 2 * NEDGE
    crop = (slice(None), slice(NEDGE, NEDGE + CH), slice(NEDGE, NEDGE + CW))
    imR, imL, gt = [], [], []
    for i in range(N):
        tex = _texture(rng, h0, w0 + 16)
        d = np.linspace(2.3 + 2 * i, 7.9 - i, h0)
        xs = np.arange(w0)[None, :] + 8 - d[:, None]
        x0 = np.floor(xs).astype(int)
        f = (xs - x0)[..., None]
        rows = np.arange(h0)[:, None]
        imR.append(tex[rows, np.arange(w0)[None, :] + 8])
        imL.append(tex[rows, x0] * (1 - f) + tex[rows, x0 + 1] * f)
        gt.append(np.broadcast_to(d[:, None, None], (h0, w0, 1)))
    imR, imL, gt = np.stack(imR), np.stack(imL), np.stack(gt)
    noise = lambda: rng.randn(N, CH, CW, 1) * 0.4
    return {"nedge": NEDGE, "eps": 7.3e-5, "imR_src": imR, "imR1_src": imL[:, :, ::-1].copy(),
            "imL": imL[crop].copy(), "imL1": imR[:, :, ::-1][crop].copy(),
            "dispL": gt[crop] + noise(), "dispL1": gt[:, :, ::-1][crop] + 1.2 + noise()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(the payload, {mesh: each rank's results}, JAX's references)."""
    rng = np.random.RandomState(3)
    a = rng.rand(N, 16, 23, 3)
    b = np.clip(a + rng.randn(N, 16, 23, 3) * 0.1, 0, 1)
    b[1] = rng.rand(16, 23, 3)  # an unrelated pair: SSIM spans its range
    ops = {}
    for name, (make, wrt) in OPS.items():
        args = make(rng)
        out_c = args[-1].shape[-1] if name != "c_imdiff1" else 3
        ops[name] = {"args": args, "wrt": wrt, "g": rng.randn(*args[0].shape[:3], out_c)}
    payload = {"ssim": (a, b), "ops": ops, "scene": _scene(rng), "loss_names": LOSS_NAMES}
    groups = {mesh: Ranks("banded_photometric", world, tmp_path_factory.mktemp(mesh), payload)
              for mesh, world in MESHES.items()}
    with groups["1x2"], groups["2x2"]:
        ref = _jax_references(payload)
        return payload, {mesh: g.results() for mesh, g in groups.items()}, ref


def _jax_references(p):
    s = p["scene"]
    e = s["nedge"]
    ref = {"ops": {}, "loss": {}}
    with jax.enable_x64():
        ref["ssim"] = np.asarray(jax.jit(j_ssim.ssim_map)(*map(jnp.asarray, p["ssim"])))
        for name, o in p["ops"].items():
            args = [jnp.asarray(x) for x in o["args"]]
            y, vjp = jax.vjp(getattr(j_grad, name), *args)
            ref["ops"][name] = (np.asarray(y), np.asarray(vjp(jnp.asarray(o["g"]))[o["wrt"]]))
        ref["imwarp"] = np.asarray(j_warp.imwarp(jnp.asarray(s["imR_src"]),
                                                 jnp.asarray(s["dispL"]), False, (e, e)))
        views = {k: jnp.asarray(s[k]) for k in ("imR_src", "imL", "imR1_src", "imL1")}
        for name in p["loss_names"]:
            cfg = j_losses.parse_loss_name(name, 1, 10).photo
            fn = lambda dl, dl1: j_losses.photometric_pyramid_loss(
                cfg, views["imR_src"], views["imL"], [dl], [0], (e, e), views["imR1_src"],
                views["imL1"], [dl1], [0], (e, e), jnp.ones(1), eps=s["eps"])
            value, grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
                jnp.asarray(s["dispL"]), jnp.asarray(s["dispL1"]))
            ref["loss"][name] = (float(value), *(np.asarray(g) for g in grads))
    return ref


def _whole(results, get):
    """The global (N, H, ...) array of which each rank holds its data
    index's images and its band of their rows: the bands joined on H
    (ranks m, m + 1 of a data index), the data indices on N."""
    per = [get(o) for o in results]
    return np.concatenate([np.concatenate(per[d:d + 2], axis=1)
                           for d in range(0, len(per), 2)], axis=0)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_banded_ssim_and_imwarp_match_jax_whole(mesh, setup):
    """SSIM's band equals the whole map's; the warp of a band of the crop
    at origin (nedge, nedge + lo) equals the whole crop's warp, through
    the fast path alone, in it and in every loss's warps."""
    _, results, ref = setup
    r = results[mesh]
    assert ref["ssim"].min() < 0.3 and ref["ssim"].max() > 0.9
    assert _rel(_whole(r, lambda o: o["ssim"]), ref["ssim"]) <= REL
    assert [o["lo"] for o in r] == [0, CH // 2] * (len(r) // 2)
    assert _rel(_whole(r, lambda o: o["imwarp"]), ref["imwarp"]) <= REL
    for o in r:
        assert o["warp_paths"]["generic"] == 0 and o["warp_paths"]["fast"] > 0
        # SSIM pads its maps, every y-difference its operand: halo rows
        assert o["collectives"]["halo_exchange"] > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(OPS))
def test_banded_gradient_op_matches_jax_whole(name, mesh, setup):
    payload, results, ref = setup
    r = results[mesh]
    y, grad = ref["ops"][name]
    assert _rel(_whole(r, lambda o: o[name]["y"]), y) <= REL
    got = _whole(r, lambda o: o[name]["grad"])
    assert np.isfinite(got).all()  # a ratio's band edges divide no halo zero
    assert _rel(got, grad) <= REL


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_banded_photometric_loss_matches_jax_whole(name, mesh, setup):
    """The ranks' shares sum to the loss of the global batch; the gradients
    of the bands join into the gradient of the whole disparities."""
    _, results, ref = setup
    r = results[mesh]
    value, g, g1 = ref["loss"][name]
    assert abs(sum(float(o[name]["loss"]) for o in r) - value) <= REL * abs(value)
    for key, want in (("dl", g), ("dl1", g1)):
        got = _whole(r, lambda o: o[name][key])
        assert np.abs(want).max() > 0 and np.isfinite(got).all()
        assert _rel(got, want) <= REL, (key, _rel(got, want))
    for o in r:
        assert "no banded pyramid" in o["level1"]
        # C_ds3's per-image means sum over the model group alone
        assert o["collectives"]["model_sum"] == 6  # c_ds3, c_ds3t1, both views of two losses
