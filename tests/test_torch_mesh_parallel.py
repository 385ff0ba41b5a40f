"""Mesh extraction over several devices (nerfmlp_torch/ops/mesh.py's
``mesh=``: a list of devices or their Replicas, or a Mesh of gloo ranks),
the server's ``POST /mesh`` over its devices and the Trainer's ``i_mesh``
over ranks, on the CPU.

Bars: the volume, the faces, vertices and colours over several devices or
ranks are one device's, bit for bit (each chunk runs the one-device call's
shape on some device); against JAX's ``extract_mesh(mesh=)`` over two of
the conftest's fake CPU devices, tests/test_torch_mesh.py's bars (volume
5e-5, vertices 1e-5, the same faces).
"""

import json

import jax
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JRC
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops import mesh as jm
from nerfmlp_tpu.parallel.mesh import make_mesh as jax_make_mesh

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops import mesh as tm
from nerfmlp_torch.parallel import checks
from nerfmlp_torch.parallel.mesh import launch
from nerfmlp_torch.parallel.render_parallel import replicate

BOX = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
KW = dict(N_samples=8, N_importance=0, near=2.0, far=6.0, perturb=False,
          depth=2, width=32, aabb=BOX)
TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module (and the ranks it spawns)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(seed=4, **extra):
    kw = dict(KW, **extra)
    jcfg, cfg = JRC(**kw), RenderConfig(**kw)
    jp = {"coarse": jax_init_model(jax.random.PRNGKey(seed),
                                   jcfg.model_config())}
    tp = {"coarse": model_from_params(jax.tree.map(np.asarray,
                                                   jp["coarse"]),
                                      cfg.model_config(), device="cpu")}
    return jp, jcfg, tp, cfg


def _threshold(tp, cfg, g):
    vol = tm.density_volume(tp, cfg, resolution=g)
    return float(0.5 * (vol.min() + vol.max()))


def _assert_same_mesh(a, b):
    for k in ("verts", "faces", "normals", "colors"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["sigma_max"] == b["sigma_max"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_mesh_over_devices_is_one_devices(n_dev, dtype):
    """A list of devices (the same one repeated: JAX's single controller
    over n devices) and their Replicas: the volume bit-equal to one
    device's, with a chunk that tiles the grid unevenly, and the mesh."""
    _, _, tp, cfg = _both(compute_dtype=dtype)
    devices = ["cpu"] * n_dev
    one = tm.density_volume(tp, cfg, resolution=13, chunk=256)
    for mesh in (devices, replicate(tp, cfg, devices)):
        np.testing.assert_array_equal(
            tm.density_volume(tp, cfg, resolution=13, chunk=256, mesh=mesh),
            one)
    thr = _threshold(tp, cfg, 12)
    ref = tm.extract_mesh(tp, cfg, resolution=12, threshold=thr,
                          density_chunk=512)
    assert len(ref["faces"]) > 0
    got = tm.extract_mesh(tp, cfg, resolution=12, threshold=thr,
                          density_chunk=512, mesh=devices)
    _assert_same_mesh(got, ref)
    colors = tm.vertex_colors(tp, cfg, ref["verts"], ref["normals"],
                              chunk=100, mesh=devices)
    np.testing.assert_array_equal(colors, tm.vertex_colors(
        tp, cfg, ref["verts"], ref["normals"], chunk=100))


def test_mesh_over_ranks_is_one_devices():
    """Two gloo ranks, each querying its share of the chunks (an odd
    chunk count: the last rank's share padded), every rank getting the
    whole mesh: one device's, bit for bit."""
    _, _, tp, cfg = _both(seed=6)
    thr = _threshold(tp, cfg, 12)
    ref = tm.extract_mesh(tp, cfg, resolution=12, threshold=thr,
                          density_chunk=512)
    nets = {"coarse": {k: v.numpy() for k, v in
                       tp["coarse"].state_dict().items()}}
    got = launch(checks.mesh_over_ranks, 2, args=(cfg, nets, 12, thr),
                 kwargs=dict(density_chunk=256), device="cpu",
                 timeout_s=TIMEOUT_S)
    assert -(-12 ** 3 // 256) % 2 == 1
    np.testing.assert_array_equal(
        got["volume"], tm.density_volume(tp, cfg, resolution=12, chunk=256))
    _assert_same_mesh(got, ref)


def test_mesh_over_devices_matches_jax_mesh():
    """The port over two devices against JAX's extract_mesh over a mesh
    of two fake CPU devices, at tests/test_torch_mesh.py's bars."""
    jp, jcfg, tp, cfg = _both(seed=8)
    jmesh = jax_make_mesh(n_devices=2)
    a = jm.density_volume(jp, jcfg, resolution=9, chunk=128, mesh=jmesh)
    b = tm.density_volume(tp, cfg, resolution=9, chunk=128,
                          mesh=["cpu", "cpu"])
    np.testing.assert_allclose(b, a, rtol=0, atol=5e-5)
    thr = float(0.5 * (b.min() + b.max()))
    ref = jm.extract_mesh(jp, jcfg, resolution=9, threshold=thr, mesh=jmesh)
    got = tm.extract_mesh(tp, cfg, resolution=9, threshold=thr,
                          mesh=["cpu", "cpu"])
    assert len(ref["faces"]) > 0 and got["faces"].shape == ref["faces"].shape
    d = np.linalg.norm(ref["verts"][:, None] - got["verts"][None], axis=-1)
    idx = d.argmin(1)
    assert d[np.arange(len(idx)), idx].max() <= 1e-5
    np.testing.assert_array_equal(idx[ref["faces"]], got["faces"])
    np.testing.assert_allclose(got["colors"][idx], ref["colors"], atol=1e-5)


def test_served_mesh_over_devices(tmp_path):
    """POST /mesh of a service over two devices: the same .ply bytes and
    counts as a one-device service's (its replicas do the queries)."""
    from nerfmlp_torch.serve import RenderService

    _, _, tp, cfg = _both(seed=9)
    thr = _threshold(tp, cfg, 10)
    args = dict(H=8, W=8, focal=10.0, device="cpu", log=lambda *a: None)
    one = RenderService(tp, cfg, **args)
    two = RenderService(tp, cfg, devices=["cpu", "cpu"], **args)
    assert two.replicas is not None
    req = {"resolution": 10, "threshold": thr}
    body, _ = two.mesh_request(req)
    assert body == one.mesh_request(req)[0]
    stats = json.loads(two.mesh_request({**req, "format": "json"})[0])
    assert stats["faces"] > 0
    assert two.health()["meshes"] == 2


def test_i_mesh_over_ranks(tmp_path):
    """The train CLI over 2 gloo ranks with --i_mesh: the .ply of step 2
    is the one-device extraction of that step's weights, byte for byte."""
    from nerfmlp_torch.scripts import train as cli
    from nerfmlp_torch.train import checkpoint as ckpt

    out = tmp_path / "run"
    cli.main(["--datadir", str(tmp_path / "scene"), "--make_synthetic_scene",
              "--img_wh", "16", "16", "--device", "cpu", "--iters", "4",
              "--batch_size", "64", "--N_samples", "8", "--N_importance", "8",
              "--netdepth", "2", "--netwidth", "32", "--quick_val_interval",
              "0", "--full_val_interval", "0", "--save_dir", str(out),
              "--n_devices", "2", "--i_mesh", "2", "--i_weights", "2",
              "--mesh_resolution", "12", "--mesh_threshold", "0.05",
              "--aabb", "-1.5", "-1.5", "-1.2", "1.5", "1.5", "1.5"])
    # The CLI's defaults: bf16 through the kernels (their plain versions
    # here).
    cfg = RenderConfig(N_samples=8, N_importance=8, depth=2, width=32,
                       compute_dtype="bfloat16", use_kernel=True,
                       aabb=(-1.5, -1.5, -1.2, 1.5, 1.5, 1.5))
    params = ckpt.load_params_any(str(out / "model_2.pt"), cfg.model_config(),
                                  device="cpu")
    want = tm.extract_mesh(params, cfg, resolution=12, threshold=0.05)
    assert len(want["faces"]) > 0
    path = tmp_path / "want.ply"
    tm.save_ply(str(path), want["verts"], want["faces"],
                colors=want["colors"], normals=want["normals"])
    assert (out / "run_mesh_000002.ply").read_bytes() == path.read_bytes()
