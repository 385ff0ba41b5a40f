"""The benchmark's plain reference against the port's module path (float32
'highest', no kernels) at a tiny size on the CPU: the same inputs must
give the same frames, grids and training steps, so that on the card the
check measures the program's precision and nothing else."""

from __future__ import annotations

import copy
import dataclasses
import math
import tempfile

import numpy as np
import pytest
import torch

from benchmark import check, harness, scene
from benchmark.drivers import frames, train
from benchmark.reference import data as rdata
from benchmark.reference import fp8, nerf, png

TINY_MODEL = {"depth": 7, "width": 32, "skips": [5], "pos_enc_L": 4,
              "dir_enc_L": 2, "use_viewdirs": True}


def tiny(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_cell(name).config)
    cfg["model"] = dict(TINY_MODEL)
    r = cfg["render"]
    r.update(use_kernel=False, compute_dtype="float32")
    if r.get("use_occupancy"):
        r.update(N_samples=6, N_importance=10, occ_grid_size=8,
                 occ_dense_samples=12, occ_update_every=2,
                 occ_warmup_steps=2)
    else:
        r.update(N_samples=8, N_importance=12)
    cfg["train"].update(batch_size=48, steps_per_dispatch=1)
    if cfg["train"].get("precrop_iters"):
        cfg["train"]["precrop_iters"] = 2
    cfg["scene"].update(n_views=3, H=12, W=12, gt_samples=24)
    cfg["serve"]["tile"] = 40
    return cfg


def recipe(name: str) -> dict:
    """The weight recipe of the cell's traffic."""
    return harness.load_cell(name).traffic["weights"]


def program_net(cfg, weights):
    from nerfmlp_torch.models.mlp import NeRFMLP

    rc, _ = harness.program_configs(cfg, 0)
    net = NeRFMLP(rc.model_config())
    net.load_state_dict(weights)
    return rc, net


@pytest.mark.parametrize("cell", ["paper_serve", "turbo_serve"])
def test_frame_matches_module_path(cell):
    from nerfmlp_torch.serve import RenderService

    cfg = tiny(cell)
    weights = scene.make_weights(cfg["model"], 11, "cpu", recipe(cell))
    rc, net = program_net(cfg, weights)
    h = w = 12
    focal = 0.5 * w / math.tan(0.5 * cfg["scene"]["camera_angle_x"])
    svc = RenderService({"coarse": net}, rc, h, w, focal,
                        tile=cfg["serve"]["tile"], device="cpu",
                        log=lambda m: None)
    density = frames.reference_density(cfg, weights, "cpu")
    if density is not None:
        np.testing.assert_allclose(density.numpy(),
                                   svc.occ_grid.density.numpy(),
                                   rtol=1e-5, atol=1e-6)
    for theta in (-170.0, 12.5, 95.0):
        got = svc.render_pose(svc_pose(theta), maps=("rgb_map",))["rgb_map"]
        ref = check.reference_frame(
            cfg, weights, nerf.pose_spherical(theta, -30.0, 4.0), h, w, focal,
            cfg["serve"]["tile"], "cpu", density)
        np.testing.assert_allclose(got, ref, atol=2e-5)


def svc_pose(theta):
    from nerfmlp_torch.ops.rays import pose_spherical

    return pose_spherical(theta, -30.0, 4.0)


@pytest.mark.parametrize("cell", ["paper_train", "turbo_train"])
@pytest.mark.parametrize("k", [1, 2])
def test_train_steps_match_module_path(cell, k):
    from nerfmlp_torch.train.loop import Trainer

    cfg = tiny(cell)
    cfg["train"]["steps_per_dispatch"] = k
    seed = 2 ** 31 + 17
    views = scene.Scene(cfg["scene"], 5, "cpu")
    weights = scene.make_weights(cfg["model"], 6, "cpu", recipe(cell))
    rc, tc = harness.program_configs(cfg, seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(rc, tc, views, save_dir=tmp, device="cpu",
                          verbose=False)
        for net in trainer.state.params.values():
            net.load_state_dict(weights)
        prog = train.take_steps(trainer, 3)
        trainer.train(iters=9)
        kept = train.keep_state(trainer)
        late = train.take_steps(trainer, 3)
    pool, shape = views.pool(), (views.n_images, 12, 12)
    ref = check.reference_train(cfg, weights, pool, shape, seed, 3, "cpu")
    ref_late = check.reference_train(cfg, kept["weights"], pool, shape, seed,
                                     3, "cpu", start=kept)
    for p, r in ((prog, ref), (late, ref_late)):
        np.testing.assert_allclose(p["losses"], r["losses"], rtol=1e-5)
        for key in r["grads"]:
            np.testing.assert_allclose(p["grads"][key], r["grads"][key],
                                       rtol=1e-3, atol=1e-7)
            np.testing.assert_allclose(p["update"][key], r["update"][key],
                                       rtol=1e-3, atol=1e-7)
        got = check.train_readings(p, r, r)
        assert max(v for k, v in got.items() if "ratio" not in k) < 1e-3, got


def test_png_decode_reads_the_served_bytes():
    from nerfmlp_torch.utils.image import png_bytes

    img = np.random.default_rng(0).integers(0, 256, (9, 7, 3), np.uint8)
    np.testing.assert_array_equal(png.decode(png_bytes(img)), img)


def test_png_decode_undoes_every_filter():
    import struct
    import zlib

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 4, 3)).astype(np.int32)
    rows, prev = [], np.zeros(12, np.int32)
    for y in range(5):
        f = y % 5
        cur = img[y].reshape(-1)
        enc = np.zeros(12, np.int32)
        for x in range(12):
            a = cur[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = [0, a, b, (a + b) >> 1, paeth][f]
            enc[x] = (cur[x] - pred) & 255
        rows.append(bytes([f]) + bytes(enc.astype(np.uint8)))
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 5, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode(data), img.astype(np.uint8))


def test_fp8_control_is_coarser_than_float32():
    g = torch.Generator().manual_seed(0)
    h = torch.randn(64, 32, generator=g)
    w = torch.randn(16, 32, generator=g) * 0.1
    exact = h @ w.t()
    err = (fp8.fp8_linear(h, w) - exact).abs().max() / exact.abs().max()
    assert 1e-3 < float(err) < 0.2


def test_host_batches_follow_the_loader():
    from nerfmlp_torch.data.pipeline import RayBatchLoader

    pool = np.arange(3 * 10 * 8 * 9, dtype=np.float32).reshape(-1, 9)
    ds = dataclasses.make_dataclass("D", ["all_rays_o", "all_rays_d",
                                          "all_rgbs", "n_images", "H", "W"])(
        pool[:, :3], pool[:, 3:6], pool[:, 6:], 3, 10, 8)
    loader = RayBatchLoader.from_dataset(ds, 16, seed=99, image_mode=True)
    mine = rdata.HostBatches(pool, (3, 10, 8), 16, 99)
    loader.set_precrop(0.5)
    for _ in range(3):
        np.testing.assert_array_equal(loader.next_batch(), mine.next(0.5))
    loader.set_precrop(1.0)
    for _ in range(3):
        np.testing.assert_array_equal(loader.next_batch(), mine.next(1.0))
