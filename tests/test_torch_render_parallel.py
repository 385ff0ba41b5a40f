"""Frames rendered over several devices (nerfmlp_torch/parallel/
render_parallel.py, render_path(mesh=), RenderService(devices=), the serve
CLI's device flags) on the CPU, against the JAX package's
render_image_sharded over its 8 fake CPU devices (tests/conftest.py) and
against the port's local renderer.

Bars. Against JAX, the renderer's (tests/test_torch_render_path.py): rgb
3e-3 and disparity 2.5e-3, dense; with a grid the samples the grid
places jump with rounding (JAX's jitted and eager occupancy renders lie
up to 8.2e-2 apart on a few values, ROADMAP Queue 3), so there the rgb
bar holds in the mean and the maximum is held at 1e-1. Against the
port's own local renderer: JAX's sharded-vs-local bars
(tests/test_parallel.py:67-99), rtol 2e-4 / atol 2e-5; the renders of a
tile of the same size, each ray computed alike, are bit-equal (dealt over
devices of one kind, a ray's tile keeps its size), which the device-list
and rank paths are held to.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops.occupancy import build_grid as jax_build_grid
from nerfmlp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nerfmlp_tpu.parallel.render_parallel import (
    render_image_sharded as jax_render_image_sharded,
)

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops import rays
from nerfmlp_torch.ops.occupancy import OccupancyGrid
from nerfmlp_torch.ops.render import render_image_maps
from nerfmlp_torch.parallel import checks
from nerfmlp_torch.parallel.mesh import Mesh, launch
from nerfmlp_torch.parallel.render_parallel import (
    Replicas, data_parallel_mesh, render_image_sharded, replicate,
)
from nerfmlp_torch.render_path import render_path
from nerfmlp_torch.serve import RenderService

RGB_TOL, DISP_TOL = 3e-3, 2.5e-3
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
KW = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=False,
          depth=2, width=32)
OCC = dict(use_occupancy=True, occ_grid_size=8, occ_dense_samples=16,
           aabb=AABB)
H = W = 12   # 144 rays: not a multiple of the tile times the devices


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(**extra):
    """JAX's and the port's configs and nets, the same weights: those of
    tests/test_torch_render_path.py, whose sigma bias is raised by 0.5 so
    that few samples sit at sigma ~ 0, where the fine pass is
    discontinuous (ROADMAP Queue 3)."""
    kw = dict(KW, **extra)
    jcfg, cfg = JaxRenderConfig(**kw), RenderConfig(**kw)
    jp = {"coarse": jax_init_model(jax.random.PRNGKey(0), jcfg.model_config())}
    jp["coarse"]["sigma"]["bias"] = jp["coarse"]["sigma"]["bias"] + 0.5
    net = model_from_params(jax.tree.map(np.asarray, jp["coarse"]),
                            cfg.model_config(), device="cpu")
    return jp, jcfg, {"coarse": net}, cfg


def _rays(seed=5):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, 0.0, 4.0]], (H * W, 1)).astype(np.float32)
    d = rng.normal(size=(H * W, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    near = np.full((H * W,), 2.0, np.float32)
    near[: H * W // 2] = 1.5   # per-ray bounds
    return o, d, near


def _grids(jp, jcfg):
    jgrid = jax_build_grid(jp, jcfg, jax.random.PRNGKey(1), resolution=8,
                           refreshes=2)
    return jgrid, OccupancyGrid(density=torch.from_numpy(
        np.asarray(jgrid.density).copy()))


@pytest.mark.parametrize("grid", [False, True], ids=["dense", "occupancy"])
def test_sharded_frame_against_jax_and_local(grid):
    jp, jcfg, tp, cfg = _both(**(OCC if grid else {}))
    o, d, near = _rays()
    jgrid, tgrid = _grids(jp, jcfg) if grid else (None, None)
    maps = ("rgb_map", "disp_map")
    want = jax_render_image_sharded(jp, o, d, H, W, jcfg,
                                    jax_make_mesh(n_devices=8), tile=8,
                                    near=near, occ_grid=jgrid, maps=maps)
    got = render_image_sharded(tp, o, d, H, W, cfg, ["cpu"] * 4, tile=8,
                               near=near, occ_grid=tgrid, maps=maps)
    assert got["rgb_map"].shape == (H, W, 3) and got["disp_map"].shape == (
        H, W)
    err = np.abs(got["rgb_map"].numpy() - want["rgb_map"])
    if grid:
        assert err.mean() < RGB_TOL and err.max() < 1e-1
    else:
        assert err.max() < RGB_TOL
        np.testing.assert_allclose(got["disp_map"].numpy(), want["disp_map"],
                                   atol=DISP_TOL)
    local = render_image_maps(tp, torch.from_numpy(o), torch.from_numpy(d),
                              H, W, cfg, tile=8, near=torch.from_numpy(near),
                              occ_grid=tgrid, maps=maps)
    for k in maps:
        np.testing.assert_array_equal(got[k].numpy(), local[k].numpy())


@pytest.mark.parametrize("grid", [False, True], ids=["dense", "occupancy"])
def test_sharded_frame_over_two_ranks(grid):
    """render_image_sharded over a mesh of 2 gloo ranks, every rank with
    the same nets and grid: each renders its tiles, all get the frame,
    equal to the local renderer's at the same tile."""
    jp, jcfg, tp, cfg = _both(**(OCC if grid else {}))
    o, d, near = _rays(seed=6)
    tgrid = _grids(jp, jcfg)[1] if grid else None
    nets = {"coarse": {k: v.numpy()
                       for k, v in tp["coarse"].state_dict().items()}}
    got = launch(checks.dp_frame, 2,
                 args=(cfg, nets, o, d, H, W, 8,
                       None if tgrid is None else tgrid.density.numpy()),
                 kwargs=dict(near=near), device="cpu", timeout_s=60)
    local = render_image_maps(tp, torch.from_numpy(o), torch.from_numpy(d),
                              H, W, cfg, tile=8, near=torch.from_numpy(near),
                              occ_grid=tgrid, maps=("rgb_map", "disp_map"))
    for k, v in local.items():
        np.testing.assert_array_equal(got[k], v.numpy())


def test_render_path_mesh_matches_local():
    """render_path(mesh=) (the events', --render_only's and render_video's
    --shard_render path) reproduces the local render, with a grid and the
    static-camera view branch, over devices or their replicas."""
    jp, jcfg, tp, cfg = _both(**OCC)
    grid = _grids(jp, jcfg)[1]
    poses = rays.blender_render_poses(n_frames=2, radius=4.0)
    hwf = (10, 10, 12.0)
    kw = dict(tile=64, verbose=False, occ_grid=grid,
              static_cam_pose=poses[0])
    local = render_path(tp, poses, hwf, cfg, **kw)
    for mesh in (["cpu", "cpu"], replicate(tp, cfg, ["cpu"] * 3, grid)):
        sharded = render_path(tp, poses, hwf, cfg, mesh=mesh, **kw)
        for a, b in zip(local[:2], sharded[:2]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_data_parallel_mesh_and_replicas():
    one = Mesh(rank=0, world_size=1, device=torch.device("cpu"),
               backend="gloo")
    two = dataclasses.replace(one, world_size=2)
    assert data_parallel_mesh(None) is None
    assert data_parallel_mesh(one) is None
    assert data_parallel_mesh(two) is two
    assert data_parallel_mesh(["cpu"]) is None
    assert data_parallel_mesh(["cpu", "cpu"]) == ["cpu", "cpu"]
    _, _, tp, cfg = _both()
    reps = replicate(tp, cfg, ["cpu", "cpu"])
    assert isinstance(reps, Replicas) and data_parallel_mesh(reps) is reps
    # The nets' own device reuses them: no copy for a repeated device.
    assert set(reps.params) == {torch.device("cpu")}
    assert reps.params[torch.device("cpu")]["coarse"] is tp["coarse"]


def test_service_shards_frames_and_swaps_replicas():
    """RenderService(devices=...) serves the single-device frame, lists
    its devices in /spec, and re-replicates on a weight swap (the frame
    after it equal to a fresh service's on the new weights)."""
    _, _, tp, cfg = _both(**OCC)
    frame = dict(H=16, W=16, focal=20.0, device="cpu", log=lambda *a: None)
    pose = rays.pose_spherical(30.0, -30.0, 4.0)
    local = RenderService(dict(tp), cfg, **frame)
    shard = RenderService(dict(tp), cfg, devices=["cpu", "cpu"], **frame)
    assert shard.spec()["devices"] == ["cpu", "cpu"]
    assert local.spec()["devices"] == ["cpu"]
    maps = ("rgb_map", "disp_map")
    for k in maps:
        np.testing.assert_allclose(shard.render_pose(pose, maps=maps)[k],
                                   local.render_pose(pose, maps=maps)[k],
                                   rtol=2e-4, atol=2e-5)
    other = {"coarse": _both()[2]["coarse"]}
    with torch.no_grad():
        for p in other["coarse"].parameters():
            p.mul_(1.5)
    shard.swap_params(dict(other))
    fresh = RenderService(dict(other), cfg, **frame)
    np.testing.assert_allclose(shard.render_pose(pose)["rgb_map"],
                               fresh.render_pose(pose)["rgb_map"],
                               rtol=2e-4, atol=2e-5)


def test_serve_cli_devices(tmp_path):
    """The serve CLI shards by default over every visible card: on the CPU
    there is one device, so it serves locally; --n_devices beyond the
    visible devices is refused."""
    from nerfmlp_torch.scripts import serve as serve_cli

    p = serve_cli.build_parser()
    base = ["--ckpt", "x.pt", "--device", "cpu"]
    assert serve_cli.serve_devices(p.parse_args(base)) is None
    assert p.parse_args(base).shard_render
    assert not p.parse_args(base + ["--no_shard_render"]).shard_render
    with pytest.raises(SystemExit, match="only 1 device"):
        serve_cli.serve_devices(p.parse_args(base + ["--n_devices", "2"]))
