"""The port's render server (nerfmlp_torch/serve.py and its CLI) against the
JAX package's RenderService, plus the serving contract: formats, errors,
admission, HTTP."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.models.import_torch import params_to_torch_state_dict
from nerfmlp_tpu.ops import render as jrender
from nerfmlp_tpu.ops.sampling import sample_pdf as jax_sample_pdf
from nerfmlp_tpu.serve import RenderService as JaxRenderService

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops import render as render_mod
from nerfmlp_torch.ops.rays import pose_spherical
from nerfmlp_torch.ops.sampling import _invert_cdf
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


POSE = pose_spherical(30.0, -30.0, 4.0)
MAPS = ("rgb_map", "depth_map", "acc_map")
BARS = {"rgb_map": 3e-3, "depth_map": 1e-2, "acc_map": 3e-3}


def _jax_frame_and_draws(monkeypatch):
    """JAX's service frame at POSE, with the (bins, weights, depths) of the
    fine pass's sample_pdf call recorded inside the jitted tile program
    that made the frame."""
    draws = []
    jax_pdf = jrender.sample_pdf

    def recorded(rng, bins, weights, n, *args, **kwargs):
        out = jax_pdf(rng, bins, weights, n, *args, **kwargs)
        jax.debug.callback(lambda *a: draws.append(
            tuple(np.array(x) for x in a)), bins, weights, out)
        return out

    jsvc = JaxRenderService({"coarse": _params(1)}, JaxRenderConfig(**KW),
                            **FRAME, log=lambda *a: None)
    jrender._tile_render_fn.cache_clear()   # retrace with the recorder
    try:
        with monkeypatch.context() as m:
            m.setattr(jrender, "sample_pdf", recorded)
            want = jsvc.render_pose(POSE, maps=MAPS)
    finally:
        jrender._tile_render_fn.cache_clear()
    assert len(draws) == 1   # one tile
    return want, draws[0]


def _port_frame(monkeypatch, depths=None):
    """The port's service frame at POSE and the (bins, weights, depths) of
    its own fine-pass draw; with ``depths`` the fine pass takes those
    instead of its own (the renderer's sample_pdf seam)."""
    draws = []
    port_pdf = render_mod.sample_pdf

    def seam(*args, **kwargs):
        mine = port_pdf(*args, **kwargs)
        draws.append((args[1].numpy(), args[2].numpy(), mine.numpy()))
        return mine if depths is None else torch.from_numpy(depths)

    with monkeypatch.context() as m:
        m.setattr(render_mod, "sample_pdf", seam)
        got = _service(seed=1).render_pose(POSE, maps=MAPS)
    assert len(draws) == 1
    return got, draws[0]


def test_frame_matches_jax_service(monkeypatch):
    """One fp32 frame from each package's service, same weights and pose:
    the render_rays fp32 bars (tests/test_reference_parity.py:118-131) on
    every pixel, with the port's fine pass fed the depths JAX's service
    drew for this frame; the plain service-against-service frame at the
    same bars on its mean.

    The fine pass is discontinuous in the coarse outputs: with det sampling
    the u = 1 sample snaps to the last bin's edge when the CDF's end rounds
    to <= 1 and lands inside the last bin when it rounds above. Where that
    bin holds almost no mass, one ulp of the coarse weights moves the sample
    by ulp / mass of the bin's width, and the frame's tail with it; which
    pixels cross a bar then depends on the host's summation order
    (test_frame_departure_is_the_u1_last_bin pins where)."""
    want, (bins, weights, depths) = _jax_frame_and_draws(monkeypatch)
    got, (my_bins, my_weights, _) = _port_frame(monkeypatch, depths=depths)
    # The fine pass's inputs are the port's own, ulps from JAX's.
    np.testing.assert_allclose(my_bins, bins, atol=1e-5)
    np.testing.assert_allclose(my_weights, weights, atol=1e-4)
    assert got["rgb_map"].shape == (16, 16, 3)
    for key, bar in BARS.items():
        np.testing.assert_allclose(got[key], want[key], atol=bar)
    own, _ = _port_frame(monkeypatch)
    for key, bar in BARS.items():
        assert np.abs(own[key] - want[key]).mean() < bar, key


def _cdf_end_above_one(weights, jax_ops):
    """Whether each row's CDF (sample_pdf's, nerfmlp_tpu/ops/sampling.py:
    76-79) ends above 1, built with JAX's ops or the port's."""
    if jax_ops:
        w = jnp.asarray(weights) + 1e-5
        return np.asarray(jnp.cumsum(w / jnp.sum(w, axis=-1, keepdims=True),
                                     axis=-1)[:, -1] > 1.0)
    w = torch.from_numpy(weights) + 1e-5
    return (torch.cumsum(w / w.sum(-1, keepdim=True), -1)[:, -1] > 1.0).numpy()


def test_frame_departure_is_the_u1_last_bin(monkeypatch):
    """Where the port's own frame departs from JAX's service frame: only on
    rays whose u = 1 fine sample lies in a last bin holding < 1e-4 of the
    mass and whose two CDFs end on either side of 1. Given JAX's depth for
    that one sample on those rays (the port's own everywhere else) the frame
    meets the bars on every pixel. The port's inversion of JAX's CDF gives
    JAX's depths bit for bit; the CDFs themselves differ by ulps (the
    normalising sum and the cumsum add in another order)."""
    want, (bins, weights, depths) = _jax_frame_and_draws(monkeypatch)
    own, (_, my_weights, my_depths) = _port_frame(monkeypatch)
    last_mass = (weights[:, -1] + 1e-5) / (weights + 1e-5).sum(-1)
    flips = (last_mass < 1e-4) & (_cdf_end_above_one(weights, True)
                                  != _cdf_end_above_one(my_weights, False))
    departs = np.zeros(flips.shape, bool)
    for key, bar in BARS.items():
        err = np.abs(own[key] - want[key]).reshape(len(flips), -1)
        departs |= err.max(-1) > bar
    assert not (departs & ~flips).any(), np.nonzero(departs & ~flips)
    # JAX's u = 1 depth on the flipped rays alone closes the frame.
    mixed = my_depths.copy()
    mixed[flips, -1] = depths[flips, -1]
    got, _ = _port_frame(monkeypatch, depths=mixed)
    for key, bar in BARS.items():
        np.testing.assert_allclose(got[key], want[key], atol=bar)
    # The inversion is JAX's: JAX's own CDF of these weights, inverted by
    # the port, gives JAX's (eager) depths bit for bit.
    w = jnp.asarray(weights) + 1e-5
    cdf = jnp.cumsum(w / jnp.sum(w, axis=-1, keepdims=True), axis=-1)
    cdf = np.array(jnp.concatenate([jnp.zeros_like(cdf[:, :1]), cdf], -1))
    n = depths.shape[-1]
    u = torch.from_numpy(np.array(jnp.linspace(0.0, 1.0, n))).expand(
        len(cdf), n)
    np.testing.assert_array_equal(
        _invert_cdf(torch.from_numpy(bins), torch.from_numpy(cdf), u).numpy(),
        np.asarray(jax_sample_pdf(None, jnp.asarray(bins),
                                  jnp.asarray(weights), n, det=True)))


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
    assert "not_ported" not in spec and spec["devices"] == ["cpu"]
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
