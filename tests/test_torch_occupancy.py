"""The port's occupancy-grid sampling (nerfmlp_torch/ops/occupancy.py, the
occupancy branch of ops/render.py, the train step, the Trainer, the
serving path) against the JAX package's, on the CPU at a small size.

Same weights (JAX init, converted), same grids and the same jitter in both
packages. Bars: the grid's lookups bit-equal; a refresh at atol 2e-4;
renders at the dense path's bars (tests/test_torch_render.py); one train
step at tests/test_torch_train_step.py's (loss, then per-leaf relative
Frobenius < 5e-2 and cosine > 0.995).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.config import TrainConfig as JaxTrainConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops import occupancy as jocc
from nerfmlp_tpu.ops.render import render_rays as jax_render_rays
from nerfmlp_tpu.parallel import train_step as jts

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.convert import (
    model_from_params, params_from_state_dict,
)
from nerfmlp_torch.ops import occupancy as occ
from nerfmlp_torch.ops.render import render_rays
from nerfmlp_torch.parallel import train_step as ts

AABB = (-1.5, -1.5, -1.2, 1.5, 1.5, 1.5)
KW = dict(depth=3, width=32, N_samples=8, N_importance=8, near=2.0, far=6.0,
          perturb=False, raw_noise_std=0.0, aabb=AABB, use_occupancy=True,
          occ_grid_size=12, occ_dense_samples=32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _both(separate_fine=False, **extra):
    """Both packages' configs and the same weights (fine net under
    ``separate_fine`` with its own architecture)."""
    kw = dict(KW, separate_fine=separate_fine, **extra)
    if separate_fine:
        kw.update(depth_fine=2, width_fine=16)
    jcfg, cfg = JaxRenderConfig(**kw), RenderConfig(**kw)
    jp = {"coarse": jax_init_model(jax.random.PRNGKey(0), jcfg.model_config())}
    if separate_fine:
        jp["fine"] = jax_init_model(jax.random.PRNGKey(1),
                                    jcfg.model_config(fine=True))
    # A positive density bias: live compositing and occupied cells.
    for net in jp.values():
        net["sigma"]["bias"] = net["sigma"]["bias"] + 0.5
    tp = {k: model_from_params(jax.tree.map(np.asarray, v),
                               cfg.model_config(fine=k == "fine"),
                               device="cpu")
          for k, v in jp.items()}
    return jp, jcfg, tp, cfg


def _jitter(key, g):
    """The uniforms JAX's update_grid draws from ``key``."""
    k_jit, _ = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_jit, (g ** 3, 3)))


def _rays(n=16, seed=1):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[:, 2] = -1.0
    d[-1] = [1.0, 1.0, 0.05]        # misses the box: near/far untightened
    return o, d


def _jax_grid(jp, jcfg, key=3):
    """A grid with empty and occupied cells: one refresh of the model."""
    g = jocc.create_grid(jcfg.occ_grid_size)
    g = jocc.update_grid(g, jp, jcfg, jax.random.PRNGKey(key), decay=0.0)
    dens = np.asarray(g.density).copy()
    dens[: dens.shape[0] // 2] = 0.0    # half the box empty
    return jocc.OccupancyGrid(density=jnp.asarray(dens))


def test_create_grid_matches_jax():
    got = occ.create_grid(8, device="cpu")
    want = jocc.create_grid(8)
    assert got.resolution == want.resolution == 8
    np.testing.assert_array_equal(got.density.numpy(), np.asarray(want.density))
    assert float(got.density.min()) > 1e-2
    assert float(got.density.max()) * 0.95 ** 14 < 1e-2


def test_create_grid_defaults_to_cuda():
    """Without a device the grid goes to cuda, as every entry point of the
    port: with no GPU that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert occ.create_grid(4).density.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            occ.create_grid(4)


@pytest.mark.parametrize("case", ["random", "box_edges"])
def test_lookup_bit_equal(case):
    rng = np.random.default_rng(2)
    dens = rng.uniform(size=(6, 6, 6)).astype(np.float32)
    if case == "random":
        pts = rng.uniform(-2.0, 2.0, size=(5, 40, 3)).astype(np.float32)
    else:
        lo, hi = np.array(AABB[:3], np.float32), np.array(AABB[3:], np.float32)
        below = hi - np.float32(1e-3)
        pts = np.stack([lo, hi, below, np.nextafter(lo, np.float32(-np.inf)),
                        np.array([lo[0], hi[1], 0.0], np.float32),
                        np.array([below[0], lo[1], below[2]], np.float32),
                        (lo + hi) / 2]).astype(np.float32)
    want = np.asarray(jocc.lookup(jocc.OccupancyGrid(jnp.asarray(dens)),
                                  jnp.asarray(pts), AABB))
    got = occ.lookup(occ.OccupancyGrid(t(dens)), t(pts), AABB).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "box_edges":
        # The lower faces are inside, the upper faces outside.
        assert got[0] == dens[0, 0, 0] and got[1] == 0.0 and got[3] == 0.0
        assert got[2] == dens[-1, -1, -1]


def test_occupancy_weights_bit_equal_with_fallback():
    _, jcfg, _, cfg = _both()
    dens = np.zeros((4, 4, 4), np.float32)
    dens[2, 2, 2] = 5.0
    dens[1, 2, 3] = 0.01            # at the threshold: empty (strict >)
    o, d = _rays(12)
    z = np.asarray(np.broadcast_to(np.linspace(2.0, 6.0, 24), (12, 24)),
                   np.float32)
    want = np.asarray(jocc.occupancy_weights(
        jocc.OccupancyGrid(jnp.asarray(dens)), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(z), jcfg))
    got = occ.occupancy_weights(occ.OccupancyGrid(t(dens)), t(o), t(d), t(z),
                                cfg).numpy()
    np.testing.assert_array_equal(got, want)
    hit = (got < 0.5).any(axis=-1)
    assert hit.any() and not hit.all()          # concentrated and fallback
    np.testing.assert_array_equal(got[~hit], 1.0)


@pytest.mark.parametrize("separate_fine", [False, True])
def test_update_grid_matches_jax(separate_fine):
    """One refresh with JAX's jitter fed in; under separate_fine the fine
    net, at its own architecture (depth 2, width 16), is the source
    (tests/test_occupancy.py:201-226)."""
    jp, jcfg, tp, cfg = _both(separate_fine)
    g = cfg.occ_grid_size
    start = np.random.default_rng(3).uniform(
        0.0, 0.5, size=(g, g, g)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jocc.update_grid(jocc.OccupancyGrid(jnp.asarray(start)),
                                       jp, jcfg, key, decay=0.95).density)
    got = occ.update_grid(occ.OccupancyGrid(t(start)), tp, cfg,
                          jitter=t(_jitter(key, g)), decay=0.95).density
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert (want > 0.95 * start + 1e-3).any()   # sigma took some cells
    with pytest.raises(ValueError, match="generator or jitter"):
        occ.update_grid(occ.OccupancyGrid(t(start)), tp, cfg)


def test_build_grid_is_the_running_max():
    """build_grid == three update_grid(decay=1) from zeros, and == JAX's
    build_grid over the same keys."""
    jp, jcfg, tp, cfg = _both()
    g, rng = cfg.occ_grid_size, jax.random.PRNGKey(7)
    jitters = [t(_jitter(k, g)) for k in jax.random.split(rng, 3)]
    built = occ.build_grid(tp, cfg, resolution=g, jitters=jitters)
    manual = occ.OccupancyGrid(torch.zeros((g,) * 3))
    for j in jitters:
        manual = occ.update_grid(manual, tp, cfg, decay=1.0, jitter=j)
    torch.testing.assert_close(built.density, manual.density, rtol=0, atol=0)
    want = jocc.build_grid(jp, jcfg, rng, resolution=g, refreshes=3)
    np.testing.assert_allclose(built.density.numpy(),
                               np.asarray(want.density), atol=2e-4)
    again = occ.build_grid(tp, cfg, torch.Generator().manual_seed(0),
                           resolution=g)
    assert again.density.device.type == "cpu"
    assert torch.isfinite(again.density).all() and (again.density >= 0).all()


@pytest.mark.parametrize("mode", ["hierarchical", "one_shot",
                                  "separate_fine"])
def test_render_rays_with_grid_matches_jax(mode):
    """Deterministic fp32 render with a grid in both packages: the dense
    path's bars (rgb 3e-3 after a second query, depth 1e-2, acc 3e-3)."""
    jp, jcfg, tp, cfg = _both(mode == "separate_fine",
                              occ_one_shot=mode == "one_shot")
    jgrid = _jax_grid(jp, jcfg)
    grid = occ.OccupancyGrid(t(np.asarray(jgrid.density)))
    o, d = _rays()
    want = jax_render_rays(jp, jnp.asarray(o), jnp.asarray(d), None, jcfg,
                           occ_grid=jgrid)
    with torch.no_grad():
        got = render_rays(tp, t(o), t(d), None, cfg, occ_grid=grid)
    assert set(got) == set(want) == {"rgb_map", "depth_map", "disp_map",
                                     "acc_map"}
    rgb_tol = 5e-4 if mode == "one_shot" else 3e-3
    np.testing.assert_allclose(got["rgb_map"].numpy(),
                               np.asarray(want["rgb_map"]), atol=rgb_tol)
    np.testing.assert_allclose(got["depth_map"].numpy(),
                               np.asarray(want["depth_map"]), atol=1e-2)
    np.testing.assert_allclose(got["acc_map"].numpy(),
                               np.asarray(want["acc_map"]), atol=3e-3)
    assert float(got["acc_map"].max()) > 0.1     # live compositing


def test_render_with_occupancy_needs_a_grid():
    _, _, tp, cfg = _both()
    o, d = _rays(4)
    with pytest.raises(ValueError, match="occ_grid"):
        render_rays(tp, t(o), t(d), None, cfg)


def _batch(n=32, seed=5):
    o, d = _rays(n, seed)
    target = np.random.default_rng(seed).uniform(size=(n, 3))
    return np.concatenate([o, d, target], axis=1).astype(np.float32)


# Jitted, as tests/test_torch_train_step.py takes the hierarchical step's:
# ten times faster than op by op here, and the per-leaf bars absorb XLA's
# reordering.
_jax_value_and_grad = jax.jit(
    jax.value_and_grad(jts.loss_and_metrics, has_aux=True),
    static_argnums=(3, 4))


@pytest.mark.parametrize("mode", ["hierarchical", "one_shot",
                                  "separate_fine"])
def test_occupancy_loss_and_grads_match_jax(mode):
    """One occupancy train step's loss and per-leaf gradients against the
    JAX step's; under separate_fine the coarse net gets none."""
    jp, jcfg, tp, cfg = _both(mode == "separate_fine",
                              occ_one_shot=mode == "one_shot")
    jgrid = _jax_grid(jp, jcfg)
    grid = occ.OccupancyGrid(t(np.asarray(jgrid.density)))
    batch = _batch()
    (loss_j, _), grads_j = _jax_value_and_grad(
        jp, jnp.asarray(batch), jax.random.PRNGKey(0), jcfg,
        JaxTrainConfig(), jgrid)
    loss_t, _ = ts.loss_and_metrics(tp, torch.from_numpy(batch), None, cfg,
                                    TrainConfig(), grid)
    loss_t.backward()
    assert abs(float(loss_j) - float(loss_t.detach())) < 1e-5
    for key, net in tp.items():
        if mode == "separate_fine" and key == "coarse":
            assert all(p.grad is None for p in net.parameters())
            assert all(float(jnp.abs(leaf).max()) == 0.0 for leaf in
                       jax.tree_util.tree_leaves(grads_j["coarse"]))
            continue
        got = params_from_state_dict(
            {n: p.grad for n, p in net.named_parameters()}, net.cfg)
        for name, leaves in grads_j[key].items():
            for leaf in ("kernel", "bias"):
                a = np.asarray(got[name][leaf]).ravel()
                b = np.asarray(leaves[leaf]).ravel()
                nb = np.linalg.norm(b)
                rel = np.linalg.norm(a - b) / max(nb, 1e-12)
                cos = float(a @ b) / max(np.linalg.norm(a) * nb, 1e-24)
                assert rel < 5e-2, f"{key}.{name}.{leaf}: relF {rel:.2e}"
                assert cos > 0.995, f"{key}.{name}.{leaf}: cosine {cos:.5f}"


def test_occupancy_step_leaves_the_coarse_net_as_optax_does():
    """A whole port step under separate_fine: the coarse net gets optax's
    zero gradient (Adam moves it by 0), the fine net moves."""
    _, _, tp, cfg = _both(True)
    grid = occ.create_grid(cfg.occ_grid_size, device="cpu")
    before = {k: [p.detach().clone() for p in net.parameters()]
              for k, net in tp.items()}
    state = ts.TrainState(step=0, params=tp,
                          optimizer=ts.make_optimizer(tp, TrainConfig()),
                          generator=torch.Generator().manual_seed(0))
    m = ts.make_step_fn(cfg, TrainConfig())(state, torch.from_numpy(_batch()),
                                            grid)
    assert state.step == 1 and torch.isfinite(m["loss"])
    for p, q in zip(tp["coarse"].parameters(), before["coarse"]):
        assert torch.equal(p.detach(), q)
    assert any(not torch.equal(p.detach(), q)
               for p, q in zip(tp["fine"].parameters(), before["fine"]))


# --------------------------------------------------------------------- #
# The Trainer, the train CLI and the render service with a grid
# --------------------------------------------------------------------- #
WH = (16, 16)
RC = RenderConfig(depth=2, width=32, N_samples=8, N_importance=8, near=2.0,
                  far=6.0, aabb=AABB, use_occupancy=True, occ_grid_size=12,
                  occ_dense_samples=32, occ_update_every=10,
                  compute_dtype="bfloat16", use_kernel=True)
TC = TrainConfig(batch_size=128, iters=30, quick_val_interval=30,
                 full_val_interval=0, quick_val_subset=1, log_interval=0,
                 ckpt_interval=0, seed=1, lr=5e-3)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_scene

    root = str(tmp_path_factory.mktemp("occ_scene"))
    make_synthetic_scene(root, n_train=4, n_val=1, n_test=0, img_wh=WH)
    return (BlenderDataset(root, "train", img_wh=WH),
            BlenderDataset(root, "val", img_wh=WH), root)


def _trainer(scene, save_dir, rc=RC, **tc):
    from nerfmlp_torch.train.loop import Trainer

    return Trainer(rc, dataclasses.replace(TC, **tc), scene[0], scene[1],
                   save_dir=str(save_dir), device="cpu", verbose=False)


def test_trainer_with_occupancy_trains_and_validates(scene, tmp_path):
    """A tiny run through the kernels' plain versions: the grid is
    refreshed, validation renders with it, PSNR clears 8 dB
    (tests/test_occupancy.py:115-134)."""
    tr = _trainer(scene, tmp_path, iters=80, quick_val_interval=40)
    assert torch.equal(tr.occ_grid.density,
                       occ.create_grid(RC.occ_grid_size, device="cpu").density)
    out = tr.train()
    assert out["final_val"]["psnr"] > 8.0
    assert np.isfinite(out["train_losses"][-1])
    d = tr.occ_grid.density
    assert d.shape == (12, 12, 12) and torch.isfinite(d).all()
    assert not torch.equal(d, occ.create_grid(12, device="cpu").density)


def test_trainer_resume_rebuilds_the_grid(scene, tmp_path):
    """Resume refreshes the grid once with decay 0 from the restored nets
    (tests/test_occupancy.py:153-180)."""
    _trainer(scene, tmp_path).train()
    again = _trainer(scene, tmp_path)
    fresh = again.occ_grid.density.clone()
    assert again.resume(str(tmp_path / "metrics_latest.pt"))
    assert again.history["step"] == 30 and again.state.step == 30
    assert not torch.allclose(again.occ_grid.density, fresh)
    from nerfmlp_torch.ops.render import prepare_params

    want = occ.update_grid(occ.create_grid(12, device="cpu"),
                           prepare_params(again.state.params, RC), RC,
                           decay=0.0,
                           jitter=torch.rand(12 ** 3, 3, generator=torch
                                             .Generator().manual_seed(
                                                 again._OCC_SEED
                                                 * 1_000_003)))
    torch.testing.assert_close(again.occ_grid.density, want.density,
                               rtol=0, atol=0)


def test_trainer_occupancy_warmup_decay_schedule(scene, tmp_path):
    """Refreshes at steps <= occ_warmup_steps use decay 1, later ones 0.95
    (tests/test_occupancy.py:243-275): at s = 1, 17, 33, 49, 65, 81."""
    rc = dataclasses.replace(RC, occ_update_every=16, occ_warmup_steps=50)
    tr = _trainer(scene, tmp_path, rc=rc, iters=96, quick_val_interval=0,
                  batch_size=64)
    seen = []
    inner = tr._occ_update

    def spy(seed_step, decay):
        seen.append((seed_step, decay))
        return inner(seed_step, decay)

    tr._occ_update = spy
    tr.train()
    assert [d for _, d in seen] == [1.0, 1.0, 1.0, 1.0, 0.95, 0.95], seen
    assert [s for s, _ in seen] == [1, 17, 33, 49, 65, 81]


def test_train_cli_with_occupancy(tmp_path):
    """python -m nerfmlp_torch.scripts.train --use_occupancy --aabb ...
    (tests/test_occupancy.py:183-198), in the one-shot protocol too."""
    from nerfmlp_torch.scripts import train as cli

    args = ["--datadir", str(tmp_path / "scene"), "--make_synthetic_scene",
            "--img_wh", "16", "16", "--device", "cpu", "--iters", "12",
            "--batch_size", "64", "--N_samples", "8", "--N_importance", "8",
            "--netdepth", "2", "--netwidth", "32", "--quick_val_interval",
            "12", "--quick_val_subset", "1", "--i_print", "6",
            "--occ_grid_size", "8", "--occ_dense_samples", "16",
            "--occ_update_every", "4", "--use_occupancy", "--aabb",
            *map(str, AABB)]
    m = cli.main(args + ["--save_dir", str(tmp_path / "out")])
    assert m["step"] == 12 and m["config"]["render"]["use_occupancy"]
    m = cli.main(args + ["--occ_one_shot", "--save_dir",
                         str(tmp_path / "one_shot")])
    assert m["config"]["render"]["occ_one_shot"]
    with pytest.raises(ValueError, match="aabb"):
        cli.main(args[:-8] + ["--use_occupancy", "--save_dir",
                              str(tmp_path / "no_box")])


def test_render_service_with_a_grid(tmp_path):
    """RenderService builds its grid from the weights, renders with it
    (JAX's render_rays on the frame's rays, same weights and JAX's grid set
    in its place, at the render bars), /spec reports occupancy, and a weight
    swap rebuilds the grid from the new weights.

    The reference is JAX's eager render_rays, not its service: the
    service's jitted tile program differs from the eager function at a
    few pixels of a small frame, likely where XLA's fused arithmetic moves
    a dense depth across a cell face and the 0/1 prior then places the
    samples elsewhere."""
    from nerfmlp_tpu.render_path import rays_for_pose_device

    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.serve import GRID_SEED, RenderService

    def built_from(params):
        return occ.build_grid(params, cfg,
                              torch.Generator().manual_seed(GRID_SEED),
                              resolution=cfg.occ_grid_size).density

    jp, jcfg, tp, cfg = _both()
    jgrid = _jax_grid(jp, jcfg)
    # 16 rays: the shapes of the render test, whose eager JAX ops are
    # compiled already.
    frame = dict(H=4, W=4, focal=5.0, tile=16)
    pose = pose_spherical(30.0, -30.0, 4.0)
    svc = RenderService(tp, cfg, **frame, device="cpu", log=lambda *a: None)
    torch.testing.assert_close(svc.occ_grid.density, built_from(tp),
                               rtol=0, atol=0)
    svc.occ_grid = occ.OccupancyGrid(t(np.asarray(jgrid.density)))
    maps = ("rgb_map", "acc_map")
    got = svc.render_pose(pose, maps=maps)
    o, d, _ = rays_for_pose_device(pose, 4, 4, 5.0, jcfg)
    want = jax_render_rays(jp, o, d, None, jcfg, occ_grid=jgrid)
    for k in maps:
        np.testing.assert_allclose(got[k].reshape(16, -1),
                                   np.asarray(want[k]).reshape(16, -1),
                                   atol=3e-3)
    assert float(got["acc_map"].max()) > 0.1
    assert svc.spec()["occupancy"] is True
    assert json.loads(json.dumps(svc.spec()))["render_config"][
        "use_occupancy"]
    before = svc.occ_grid.density.clone()
    new = {"coarse": model_from_params(jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(9), jcfg.model_config())), cfg.model_config(),
        device="cpu")}
    svc.swap_params(new)
    assert svc.reloads == 1
    assert not torch.equal(svc.occ_grid.density, before)
    torch.testing.assert_close(svc.occ_grid.density, built_from(new),
                               rtol=0, atol=0)


def test_serve_cli_with_occupancy(tmp_path):
    """python -m nerfmlp_torch.scripts.serve --use_occupancy --aabb ...:
    a grid built at start-up, 16,384-ray tiles by default."""
    from nerfmlp_tpu.models.import_torch import params_to_torch_state_dict

    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.scripts.serve import build_parser, build_service

    jp, jcfg, _, _ = _both()
    ckpt = tmp_path / "model.pth"
    torch.save(params_to_torch_state_dict(
        jax.tree.map(np.asarray, jp["coarse"]), jcfg.model_config()), ckpt)
    base = ["--ckpt", str(ckpt), "--focal", "15", "--img_wh", "12", "12",
            "--N_samples", "8", "--N_importance", "8", "--netdepth", "3",
            "--netwidth", "32", "--device", "cpu", "--occ_grid_size", "8",
            "--occ_dense_samples", "16"]
    p = build_parser()
    s = build_service(p.parse_args(base + ["--use_occupancy", "--aabb",
                                           *map(str, AABB)]))
    assert s.tile == 16384 and s.spec()["occupancy"] is True
    assert s.occ_grid.resolution == 8
    out = s.render_pose(pose_spherical(0.0, -30.0, 4.0))["rgb_map"]
    assert out.shape == (12, 12, 3) and np.isfinite(out).all()
    plain = build_service(p.parse_args(base))
    assert plain.tile == 4096 and plain.occ_grid is None
    assert plain.spec()["occupancy"] is False
    with pytest.raises(ValueError, match="aabb"):
        build_service(p.parse_args(base + ["--use_occupancy"]))
