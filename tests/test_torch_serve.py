"""The port's render server (nerfmlp_torch/serve.py and its CLI) against the
JAX package's RenderService, plus the serving contract: formats, errors,
admission, HTTP."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.models.import_torch import params_to_torch_state_dict
from nerfmlp_tpu.serve import RenderService as JaxRenderService

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops.rays import pose_spherical
from nerfmlp_torch.serve import (
    RenderServer, RenderService, RequestError, ServiceOverloaded,
)

KW = dict(N_samples=16, N_importance=8, near=2.0, far=6.0, perturb=False,
          depth=6, width=64)
FRAME = dict(H=16, W=16, focal=20.0, tile=256)


def _params(seed=0):
    return jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(seed), JaxRenderConfig(**KW).model_config()))


def _service(seed=0, **kw):
    cfg = RenderConfig(**KW)
    net = model_from_params(_params(seed), cfg.model_config(), device="cpu")
    args = dict(FRAME, log=lambda *a: None, device="cpu")
    args.update(kw)
    return RenderService({"coarse": net}, cfg, **args)


@pytest.fixture(scope="module")
def svc():
    return _service()


def test_frame_matches_jax_service():
    """One fp32 frame from each package's service, same weights and pose:
    the render_rays fp32 bars (tests/test_reference_parity.py:118-131).

    Seed and pose are fixed on purpose. With det sampling the fine pass's
    u = 1 sample sits on the last bin when the CDF's end rounds to <= 1 and
    one bin earlier when it rounds above; where that last bin is empty, a
    one-ulp difference in the coarse weights (another summation order)
    moves it by a whole bin and a pixel by up to ~5e-3."""
    jsvc = JaxRenderService({"coarse": _params(1)}, JaxRenderConfig(**KW),
                            **FRAME, log=lambda *a: None)
    pose = pose_spherical(30.0, -30.0, 4.0)
    maps = ("rgb_map", "depth_map", "acc_map")
    want = jsvc.render_pose(pose, maps=maps)
    got = _service(seed=1).render_pose(pose, maps=maps)
    assert got["rgb_map"].shape == (16, 16, 3)
    np.testing.assert_allclose(got["rgb_map"], want["rgb_map"], atol=3e-3)
    np.testing.assert_allclose(got["depth_map"], want["depth_map"], atol=1e-2)
    np.testing.assert_allclose(got["acc_map"], want["acc_map"], atol=3e-3)


def test_formats(svc):
    from PIL import Image

    cam = {"theta": 45.0, "phi": -30.0, "radius": 4.0}
    npy, ctype = svc.render_request({**cam, "format": "npy"})
    assert ctype == "application/octet-stream"
    rgb = np.load(io.BytesIO(npy))
    assert rgb.shape == (16, 16, 3) and np.isfinite(rgb).all()
    png, ctype = svc.render_request(cam)
    assert ctype == "image/png"
    img = np.asarray(Image.open(io.BytesIO(png)))
    np.testing.assert_array_equal(img, (rgb * 255).round().astype(np.uint8))
    body, ctype = svc.render_request(
        {**cam, "format": "json", "maps": ["rgb_map", "depth_map"]})
    assert ctype == "application/json"
    out = json.loads(body)
    np.testing.assert_allclose(np.asarray(out["rgb_map"]), rgb, atol=1e-6)
    assert np.asarray(out["depth_map"]).shape == (16, 16)
    c2w, _ = svc.render_request({"c2w": pose_spherical(45.0, -30.0, 4.0)
                                 .tolist(), "format": "npy"})
    np.testing.assert_array_equal(np.load(io.BytesIO(c2w)), rgb)
    bright = np.load(io.BytesIO(svc.render_request(
        {**cam, "format": "npy", "brightness": 2.0})[0]))
    np.testing.assert_allclose(bright, np.clip(rgb * 2.0, 0, 1), atol=1e-6)


def test_request_errors(svc):
    for req in (
        {},
        {"theta": 0, "phi": -30, "radius": 4, "c2w": np.eye(4).tolist()},
        {"eye": [0, -4, 0]},
        {"theta": 0, "phi": -30},
        {"theta": 0, "phi": -30, "radius": 4, "format": "tiff"},
        {"theta": 0, "phi": -30, "radius": 4, "maps": ["disp_map"]},
        {"theta": 0, "phi": -30, "radius": 4, "format": "npy",
         "maps": ["rgb_map", "disp_map"]},
        {"theta": "abc", "phi": -30, "radius": 4},
        {"c2w": [[1, 2], [3]]},
        {"theta": 0, "phi": -30, "radius": 4, "H": 10_000, "W": 10_000},
        [1, 2, 3],
    ):
        with pytest.raises(RequestError):
            svc.render_request(req)


def test_admission_sheds_and_swap_changes_output():
    s = _service(max_queue=1)
    pose = pose_spherical(0.0, -30.0, 4.0)
    before = s.render_pose(pose)["rgb_map"]
    with s._stats_lock:
        s._inflight = 1
    try:
        with pytest.raises(ServiceOverloaded):
            s.render_pose(pose)
    finally:
        with s._stats_lock:
            s._inflight = 0
    assert s.health()["rejected"] == 1
    cfg = RenderConfig(**KW)
    s.swap_params({"coarse": model_from_params(_params(7), cfg.model_config(),
                                               device="cpu")})
    assert s.reloads == 1
    assert np.abs(s.render_pose(pose)["rgb_map"] - before).max() > 0


@pytest.fixture(scope="module")
def server_url(svc):
    server = RenderServer(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield "http://%s:%d" % server.server_address[:2]
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _http(url, body=None):
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def test_http_routes(server_url):
    status, body, ctype = _http(server_url + "/health")
    assert status == 200 and ctype == "application/json"
    health = json.loads(body)
    assert health["status"] == "ok" and health["device"] == "cpu"
    status, body, _ = _http(server_url + "/spec")
    spec = json.loads(body)
    assert status == 200 and spec["defaults"]["W"] == 16
    assert spec["not_ported"] == ["multi-device sharding"]
    assert {"POST /mesh", "POST /reload"} <= set(spec["routes"])
    assert spec["render_config"]["use_kernel"] is False
    status, body, ctype = _http(server_url + "/render", json.dumps(
        {"theta": 0, "phi": -30, "radius": 4}).encode())
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    assert json.loads(_http(server_url + "/health")[1])["latency"]["n"] >= 1


def test_http_errors(server_url):
    status, body, _ = _http(server_url + "/render", b"{not json")
    assert status == 400 and b"bad JSON" in body
    status, body, _ = _http(server_url + "/render", b'{"format": "png"}')
    assert status == 400 and "camera spec" in json.loads(body)["error"]
    # /mesh and /reload are served: this service has no box and no reload
    # support, so both answer 400 with the reason.
    status, body, _ = _http(server_url + "/mesh", b"{}")
    assert status == 400 and "aabb" in json.loads(body)["error"]
    status, body, _ = _http(server_url + "/reload", b"")
    assert status == 400 and "reload" in json.loads(body)["error"]
    status, _, _ = _http(server_url + "/nope")
    assert status == 404


def test_http_503_with_retry_after():
    s = _service(max_queue=1)
    server = RenderServer(s, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    try:
        with s._stats_lock:
            s._inflight = 1
        status, body, _ = _http(url + "/render", json.dumps(
            {"theta": 0, "phi": -30, "radius": 4}).encode())
        assert status == 503
        assert "max_queue=1" in json.loads(body)["error"]
    finally:
        with s._stats_lock:
            s._inflight = 0
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_cli_builds_a_service(tmp_path):
    from nerfmlp_torch.scripts.serve import build_parser, build_service

    ckpt = tmp_path / "model.pth"
    torch.save(params_to_torch_state_dict(
        _params(), JaxRenderConfig(**KW).model_config()), ckpt)
    args = build_parser().parse_args([
        "--ckpt", str(ckpt), "--focal", "20", "--img_wh", "16", "12",
        "--N_samples", "16", "--N_importance", "8", "--netdepth", "6",
        "--netwidth", "64", "--device", "cpu", "--tile", "256"])
    s = build_service(args)
    assert s.cfg.use_kernel and s.cfg.compute_dtype == "bfloat16"
    assert s.defaults == {"H": 12, "W": 16, "focal": 20.0, "near": 2.0,
                          "far": 6.0}
    out = s.render_pose(pose_spherical(0.0, -30.0, 4.0))["rgb_map"]
    assert out.shape == (12, 16, 3) and np.isfinite(out).all()
    assert build_parser().parse_args(
        ["--ckpt", "x.pth", "--focal", "1", "--no_pallas"]).use_kernel is False
