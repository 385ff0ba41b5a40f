"""The port's sampling, compositing, rays and renderer against the JAX
package (nerfmlp_torch/ops/sampling.py, integrate.py, rays.py, render.py,
render_path.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops.integrate import composite_rays as jax_composite
from nerfmlp_tpu.ops.rays import intersect_aabb as jax_intersect_aabb
from nerfmlp_tpu.ops.render import (
    _merge_by_depth as jax_merge, render_rays as jax_render_rays,
)
from nerfmlp_tpu.ops.sampling import (
    sample_pdf as jax_sample_pdf, stratified_sample as jax_stratified,
)
from nerfmlp_tpu.render_path import (
    rays_for_pose as jax_rays_for_pose,
    rays_for_pose_device as jax_rays_for_pose_device,
)

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops.integrate import composite_rays
from nerfmlp_torch.ops.rays import intersect_aabb, pose_spherical
from nerfmlp_torch.ops.render import _merge_by_depth, render_rays
from nerfmlp_torch.ops.sampling import sample_pdf, stratified_sample
from nerfmlp_torch.render_path import rays_for_pose, rays_for_pose_device

ARCH = dict(depth=6, width=64, N_samples=16, N_importance=8, perturb=False,
            raw_noise_std=0.0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests and fixtures (restored
    after), so that parallel test workers do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_stratified_sample_matches_jax():
    want = np.asarray(jax_stratified(None, 5, 16, 2.0, 6.0, perturb=False))
    got = stratified_sample(None, 5, 16, 2.0, 6.0, perturb=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # Per-ray bounds, lindisp, and a jittered draw with the same uniforms.
    near = np.linspace(1.0, 2.0, 5).astype(np.float32)
    want = np.asarray(jax_stratified(None, 5, 16, jnp.asarray(near), 6.0,
                                     perturb=False, lindisp=True))
    got = stratified_sample(None, 5, 16, t(near), 6.0, perturb=False,
                            lindisp=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_stratified(key, 5, 16, 2.0, 6.0, perturb=True))
    u = np.asarray(jax.random.uniform(key, (5, 16)))
    got = stratified_sample(None, 5, 16, 2.0, 6.0, perturb=True,
                            u=t(u)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode", ["det", "uniform", "stratified"])
def test_sample_pdf_matches_jax(mode):
    rng = np.random.default_rng(4)
    bins = np.sort(rng.uniform(2, 6, size=(7, 15)), axis=-1).astype(np.float32)
    weights = rng.uniform(size=(7, 14)).astype(np.float32)
    weights[0] = 0.0   # an empty ray
    key = jax.random.PRNGKey(5)
    det = mode == "det"
    want = np.asarray(jax_sample_pdf(
        None if det else key, jnp.asarray(bins), jnp.asarray(weights), 12,
        det=det, stratified=mode == "stratified"))
    u = None if det else t(jax.random.uniform(key, (7, 12)))
    got = sample_pdf(None, t(bins), t(weights), 12, det=det,
                     stratified=mode == "stratified", u=u).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="bins last dim"):
        sample_pdf(None, t(bins[:, :-1]), t(weights), 12, det=True)


@pytest.mark.parametrize("far_cap", [None, "scalar", "per_ray"])
def test_composite_rays_matches_jax(far_cap):
    rng = np.random.default_rng(6)
    raw = rng.normal(size=(9, 20, 4)).astype(np.float32) * 2
    z = np.sort(rng.uniform(2, 6, size=(9, 20)), axis=-1).astype(np.float32)
    d = rng.normal(size=(9, 3)).astype(np.float32)
    cap = {None: None, "scalar": 6.5,
           "per_ray": rng.uniform(5, 7, size=9).astype(np.float32)}[far_cap]
    want = jax_composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                         far_cap=None if cap is None else jnp.asarray(cap))
    got = composite_rays(t(raw), t(z), t(d),
                         far_cap=None if cap is None else torch.as_tensor(cap))
    for k in ("rgb_map", "depth_map", "disp_map", "acc_map", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_merge_by_depth_matches_jax_with_ties():
    rng = np.random.default_rng(7)
    z_c = np.sort(rng.choice(np.arange(20.0), size=(4, 8)), axis=-1)
    z_f = rng.choice(np.arange(20.0), size=(4, 6))  # unsorted, with ties
    raw_c = rng.normal(size=(4, 8, 4))
    raw_f = rng.normal(size=(4, 6, 4))
    want_z, want_raw = jax_merge(*(jnp.asarray(a, jnp.float32)
                                   for a in (z_c, raw_c, z_f, raw_f)))
    got_z, got_raw = _merge_by_depth(t(z_c), t(raw_c), t(z_f), t(raw_f))
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_raw.numpy(), np.asarray(want_raw))


def test_rays_and_aabb_match_jax():
    pose = pose_spherical(30.0, -30.0, 4.0)
    cfg, jcfg = RenderConfig(), JaxRenderConfig()
    o, d, vd = rays_for_pose(pose, 12, 10, 15.0, cfg)
    jo, jd, jvd = jax_rays_for_pose(pose, 12, 10, 15.0, jcfg)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(d, jd)
    assert vd is None and jvd is None
    other = pose_spherical(90.0, -30.0, 4.0)
    o2, d2, vd2 = rays_for_pose_device(pose, 12, 10, 15.0, cfg,
                                       viewdirs_pose=other, device="cpu")
    jo2, jd2, jvd2 = jax_rays_for_pose_device(pose, 12, 10, 15.0, jcfg,
                                              viewdirs_pose=other)
    for a, b in ((o2, jo2), (d2, jd2), (vd2, jvd2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    box = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    n, f = intersect_aabb(o2, d2, box[:3], box[3:], 2.0, 6.0)
    jn, jf = jax_intersect_aabb(jnp.asarray(o2.numpy()),
                                jnp.asarray(d2.numpy()), box[:3], box[3:],
                                2.0, 6.0)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)


def _rays(n=16, seed=1):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return o, d


def _both(mode, **extra):
    """Same weights in both packages for a render mode."""
    kw = dict(ARCH, **extra)
    if mode == "coarse_only":
        kw["N_importance"] = 0
    sep = mode == "separate_fine"
    jcfg = JaxRenderConfig(separate_fine=sep, **kw)
    cfg = RenderConfig(separate_fine=sep, **kw)
    jp = {"coarse": jax_init_model(jax.random.PRNGKey(0), jcfg.model_config())}
    if sep:
        jp["fine"] = jax_init_model(jax.random.PRNGKey(1),
                                    jcfg.model_config(fine=True))
    tp = {k: model_from_params(jax.tree.map(np.asarray, v),
                               cfg.model_config(fine=k == "fine"),
                               device="cpu")
          for k, v in jp.items()}
    return jp, jcfg, tp, cfg


@pytest.mark.parametrize("mode", ["coarse_only", "shared", "separate_fine"])
def test_render_rays_fp32_matches_jax(mode):
    """Deterministic fp32 render through both packages, at the bars of
    tests/test_reference_parity.py:118-131."""
    jp, jcfg, tp, cfg = _both(mode, aabb=(-2.0, -2.0, -2.0, 2.0, 2.0, 2.0)
                              if mode == "shared" else None)
    o, d = _rays()
    want = jax_render_rays(jp, jnp.asarray(o), jnp.asarray(d), None, jcfg)
    with torch.no_grad():
        got = render_rays(tp, t(o), t(d), None, cfg)
    assert set(got) == set(want)
    if mode != "coarse_only":
        np.testing.assert_allclose(got["rgb_map_coarse"].numpy(),
                                   np.asarray(want["rgb_map_coarse"]),
                                   atol=5e-4)
    np.testing.assert_allclose(got["rgb_map"].numpy(),
                               np.asarray(want["rgb_map"]),
                               atol=5e-4 if mode == "coarse_only" else 3e-3)
    np.testing.assert_allclose(got["depth_map"].numpy(),
                               np.asarray(want["depth_map"]), atol=1e-2)
    np.testing.assert_allclose(got["acc_map"].numpy(),
                               np.asarray(want["acc_map"]), atol=3e-3)


def test_render_rays_bf16_kernel_flag_matches_jax_pallas():
    """bf16 with the kernel flag (its plain version on the CPU) vs JAX bf16
    with use_pallas=True (interpret mode): the bar of test_pallas.py:92."""
    jp, jcfg, tp, cfg = _both("shared")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16", use_pallas=True)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernel=True)
    o, d = _rays()
    want = jax_render_rays(jp, jnp.asarray(o), jnp.asarray(d), None, jcfg)
    with torch.no_grad():
        got = render_rays(tp, t(o), t(d), None, cfg)
    np.testing.assert_allclose(got["rgb_map"].numpy(),
                               np.asarray(want["rgb_map"]), atol=1e-3)


def test_render_guards():
    _, _, tp, cfg = _both("shared")
    o, d = _rays(4)
    # use_occupancy with no grid: the JAX package's ValueError naming it.
    with pytest.raises(ValueError, match="occ_grid"):
        render_rays(tp, t(o), t(d), None,
                    dataclasses.replace(cfg, use_occupancy=True))
    with pytest.raises(ValueError, match="viewdirs"):
        render_rays(tp, t(o), t(d), None, dataclasses.replace(cfg, ndc=True))
    with pytest.raises(ValueError, match="generator"):
        render_rays(tp, t(o), t(d), None, dataclasses.replace(cfg,
                                                              perturb=True))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = render_rays(tp, t(o), t(d), g,
                          dataclasses.replace(cfg, perturb=True,
                                              raw_noise_std=1.0))
    assert torch.isfinite(out["rgb_map"]).all()
