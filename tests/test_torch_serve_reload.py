"""The port's render server beyond frames (nerfmlp_torch/serve.py and its
CLI): ``POST /mesh`` and hot reload (``POST /reload``, the checkpoint
watcher, ``latest_params_checkpoint``), against the JAX package's
RenderService where both compute, and the serving contract (formats,
errors, admission, HTTP) where only the port does, on the CPU at a small
size (depth 2, width 32, fp32 'highest').

Mirrors tests/test_serve.py's reload (:275-330) and mesh (:894-1045)
tests, with the port's ``.pt`` checkpoint names."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JRC
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.serve import RenderService as JaxRenderService

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops.rays import pose_spherical
from nerfmlp_torch.serve import (
    RenderServer, RenderService, RequestError, ServiceOverloaded,
    latest_params_checkpoint,
)
from nerfmlp_torch.train import checkpoint as ckpt

BOX = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
KW = dict(N_samples=8, N_importance=4, near=2.0, far=6.0, perturb=False,
          depth=2, width=32, aabb=BOX)
FRAME = dict(H=16, W=16, focal=20.0, tile=256)
POSE = pose_spherical(0.0, -30.0, 4.0)


def _jax_params(seed):
    return {"coarse": jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(seed), JRC(**KW).model_config()))}


def _nets(seed):
    cfg = RenderConfig(**KW)
    return {"coarse": model_from_params(_jax_params(seed)["coarse"],
                                        cfg.model_config(), device="cpu")}


def _service(seed=0, **kw):
    args = dict(FRAME, log=lambda *a: None, device="cpu")
    args.update(kw)
    return RenderService(_nets(seed), RenderConfig(**KW), **args)


def _reload_fn(path):
    return ckpt.load_params_any(path, RenderConfig(**KW).model_config(),
                                device="cpu", with_step=True)


def _reloadable(tmp_path, **kw):
    path = str(tmp_path / "model_100.pt")
    ckpt.save_params(path, _nets(0))
    params, step = _reload_fn(path)
    return RenderService(params, RenderConfig(**KW), **dict(
        FRAME, log=lambda *a: None, device="cpu", reload_fn=_reload_fn,
        watch_dir=str(tmp_path), ckpt_path=path, ckpt_step=step, **kw))


def _threshold(svc, resolution=10):
    stats = json.loads(svc.mesh_request(
        {"resolution": resolution, "threshold": 1e9, "format": "json"})[0])
    assert stats["verts"] == stats["faces"] == 0
    assert stats["sigma_max"] >= stats["sigma_min"] >= 0.0
    return 0.5 * (stats["sigma_min"] + stats["sigma_max"])


# ---- POST /mesh ---------------------------------------------------------- #

def test_mesh_request_json_ply_obj_match_jax():
    """The same weights in both packages' services: equal counts and sigma
    range (json), the PLY and OBJ of those counts; health and spec count
    the extractions."""
    svc = _service(1)
    jsvc = JaxRenderService(_jax_params(1), JRC(**KW), H=16, W=16,
                            focal=20.0, tile=256, log=lambda *a: None)
    thr = _threshold(svc)
    req = {"resolution": 10, "threshold": thr}
    ours = json.loads(svc.mesh_request({**req, "format": "json"})[0])
    theirs = json.loads(jsvc.mesh_request({**req, "format": "json"})[0])
    assert ours["faces"] > 0
    for k in ("verts", "faces", "resolution", "threshold", "aabb"):
        assert ours[k] == theirs[k], k
    assert abs(ours["sigma_max"] - theirs["sigma_max"]) <= 1e-5
    body, ctype = svc.mesh_request(req)
    assert ctype == "application/octet-stream"
    head = body.partition(b"end_header\n")[0].decode().splitlines()
    assert f"element vertex {ours['verts']}" in head
    assert f"element face {ours['faces']}" in head
    assert [ln.split()[2] for ln in head if ln.startswith("property ")
            and "list" not in ln] == ["x", "y", "z", "nx", "ny", "nz",
                                      "red", "green", "blue"]
    body, ctype = svc.mesh_request({**req, "format": "obj", "color": False})
    assert ctype.startswith("text/plain")
    lines = body.decode().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == ours["verts"]
    assert sum(ln.startswith("f ") for ln in lines) == ours["faces"]
    assert all(len(ln.split()) == 4 for ln in lines if ln.startswith("v "))
    h = svc.health()
    assert h["meshes"] == 4 and h["mesh_last_s"] is not None
    assert h["renders"] == 0
    assert svc.spec()["max_mesh_resolution"] == 256


def test_mesh_request_gamma_changes_colors_only():
    svc = _service(2)
    thr = _threshold(svc, 8)
    lin, _ = svc.mesh_request({"resolution": 8, "threshold": thr})
    srgb, _ = svc.mesh_request({"resolution": 8, "threshold": thr,
                                "gamma": True})
    assert len(lin) == len(srgb) and lin != srgb
    assert srgb.startswith(lin.partition(b"end_header\n")[0])


def test_mesh_request_validation():
    svc = _service()
    for bad in ({"resolution": 1}, {"resolution": 100000},
                {"resolution": "huge"}, {"threshold": float("nan")},
                {"format": "stl"}, {"aabb": [0, 0, 0, -1, 1, 1]},
                {"aabb": [0, 0, 0, 1, 1]}, {"aabb": ["a"] * 6}):
        with pytest.raises(RequestError):
            svc.mesh_request({"resolution": 6, **bad})
    with pytest.raises(RequestError, match="JSON object"):
        svc.mesh_request([1, 2])
    # No box anywhere: an actionable error; a request's own box works.
    nobox = RenderService(_nets(0), RenderConfig(**dict(KW, aabb=None)),
                          **dict(FRAME, log=lambda *a: None, device="cpu"))
    with pytest.raises(RequestError, match="aabb"):
        nobox.mesh_request({"resolution": 6})
    body, _ = nobox.mesh_request({"resolution": 6, "threshold": 1e9,
                                  "format": "json", "aabb": list(BOX)})
    assert json.loads(body)["faces"] == 0
    with pytest.raises(RequestError, match="disabled"):
        _service(max_mesh_resolution=0).mesh_request({"resolution": 6})
    assert svc.meshes == 0


def test_mesh_counts_against_admission():
    """An extraction takes a queue slot: with max_queue=1 and one request
    in flight it is shed like a render, and the Retry-After hint grows to
    an extraction's while one runs."""
    svc = _service(max_queue=1)
    with svc._stats_lock:
        svc._inflight = 1
    try:
        with pytest.raises(ServiceOverloaded):
            svc.mesh_request({"resolution": 6, "threshold": 1e9})
    finally:
        with svc._stats_lock:
            svc._inflight = 0
    assert svc.rejected == 1 and svc.meshes == 0
    with svc._stats_lock:
        svc._mesh_active = 1
    assert svc.retry_after_s() == 30
    with svc._stats_lock:
        svc._mesh_active = 0
    assert svc.retry_after_s() == 1


def test_mesh_reads_the_params_once():
    """A swap during an extraction (at its lock) does not reach it: the
    request's mesh is the old weights', the next request's the new."""
    svc = _service(3)
    thr = _threshold(svc, 8)
    req = {"resolution": 8, "threshold": thr, "format": "json"}
    before = json.loads(svc.mesh_request(req)[0])
    new = _nets(4)

    class SwapOnEnter:
        """The dispatch lock, swapping the weights the first time in."""

        def __init__(self, lock):
            self.lock, self.done = lock, False

        def __enter__(self):
            if not self.done:
                self.done = True
                svc.swap_params(new)
            self.lock.acquire()

        def __exit__(self, *exc):
            self.lock.release()

    svc._lock = SwapOnEnter(svc._lock)
    during = json.loads(svc.mesh_request(req)[0])
    after = json.loads(svc.mesh_request(req)[0])
    assert during["sigma_max"] == before["sigma_max"]
    assert after["sigma_max"] != before["sigma_max"]


# ---- latest_params_checkpoint and reload --------------------------------- #

def test_latest_params_checkpoint_rules(tmp_path):
    assert latest_params_checkpoint(str(tmp_path / "missing")) is None
    assert latest_params_checkpoint(str(tmp_path)) is None
    # Only the whole train state (a run's first validation): fall back.
    (tmp_path / "metrics_latest.pt").write_bytes(b"x")
    assert latest_params_checkpoint(str(tmp_path)).endswith(
        "metrics_latest.pt")
    # The JAX Trainer's whole state too; the newer of the two.
    (tmp_path / "metrics_latest.ckpt").write_bytes(b"x")
    os.utime(tmp_path / "metrics_latest.pt", (1e9, 1e9))
    assert latest_params_checkpoint(str(tmp_path)).endswith(
        "metrics_latest.ckpt")
    # Stepped files win, by step, the JAX package's .ckpt names among the
    # port's; stepless ones and files still being written never match.
    for name in ("model_best.pt", "model_final.pt", "model_1000.pt",
                 "model_2000_latest.pt", "model_best.ckpt",
                 "model_final.ckpt", "model_1500.ckpt",
                 "model_5000.pt.tmp", "model_3000_latest.pt.tmp",
                 "model_4000.ckpt.tmp"):
        (tmp_path / name).write_bytes(b"x")
    assert latest_params_checkpoint(str(tmp_path)).endswith(
        "model_2000_latest.pt")
    # The same step twice: the newer file, whichever its format.
    (tmp_path / "model_2000.pt").write_bytes(b"x")
    os.utime(tmp_path / "model_2000.pt", (1e9, 1e9))
    assert latest_params_checkpoint(str(tmp_path)).endswith(
        "model_2000_latest.pt")
    os.utime(tmp_path / "model_2000.pt", (4e9, 4e9))
    assert latest_params_checkpoint(str(tmp_path)).endswith("model_2000.pt")
    (tmp_path / "model_2000_latest.ckpt").write_bytes(b"x")
    os.utime(tmp_path / "model_2000_latest.ckpt", (5e9, 5e9))
    assert latest_params_checkpoint(str(tmp_path)).endswith(
        "model_2000_latest.ckpt")
    (tmp_path / "model_9000.ckpt").write_bytes(b"x")
    assert latest_params_checkpoint(str(tmp_path)).endswith(
        "model_9000.ckpt")


def test_reload_picks_the_newest_checkpoint(tmp_path):
    svc = _reloadable(tmp_path)
    assert svc.ckpt["step"] == 100 and svc.ckpt["mtime"] is not None
    first = svc.render_pose(POSE)["rgb_map"]
    assert svc.reload(force=False) is None          # nothing new: a no-op
    assert svc.reloads == 0
    ckpt.save_params(str(tmp_path / "model_200.pt"), _nets(1))
    (tmp_path / "model_900.pt.tmp").write_bytes(b"half a file")
    info = svc.reload(force=False)
    assert info["step"] == 200 and info["path"].endswith("model_200.pt")
    second = svc.render_pose(POSE)["rgb_map"]
    assert np.abs(second - first).max() > 0
    assert svc.health()["ckpt"]["step"] == 200 and svc.reloads == 1
    assert svc.reload(force=False) is None
    assert svc.reload(force=True)["step"] == 200 and svc.reloads == 2
    np.testing.assert_array_equal(svc.render_pose(POSE)["rgb_map"], second)


def test_reload_errors(tmp_path):
    with pytest.raises(RequestError, match="without reload support"):
        _service().reload()
    svc = _service(reload_fn=_reload_fn)     # no watch dir, no served file
    with pytest.raises(RequestError, match="no watch dir"):
        svc.reload()
    assert svc.reload(force=False) is None
    empty = _service(reload_fn=_reload_fn, watch_dir=str(tmp_path / "e"))
    with pytest.raises(RequestError, match="no checkpoint found"):
        empty.reload()


def test_reload_without_a_watch_dir_reloads_the_served_file(tmp_path):
    path = str(tmp_path / "weights.pt")
    ckpt.save_params(path, _nets(0))
    svc = _service(reload_fn=_reload_fn, ckpt_path=path)
    assert svc.ckpt["step"] == 0
    assert svc.reload(force=False) is None
    ckpt.save_params(path, _nets(5))
    os.utime(path, (4e9, 4e9))
    assert svc.reload(force=False)["path"] == path and svc.reloads == 1


def test_a_failed_load_keeps_the_record(tmp_path):
    """A file that does not load leaves the served record as it was, so
    the watcher tries it again; once it loads, it is served."""
    svc = _reloadable(tmp_path)
    bad = tmp_path / "model_300.pt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        svc.reload(force=False)
    assert svc.ckpt["step"] == 100 and svc.reloads == 0
    ckpt.save_params(str(bad), _nets(2))
    assert svc.reload(force=False)["step"] == 300


def test_metrics_latest_reports_its_true_step(tmp_path):
    """A whole train state names no step: the service reads it inside, at
    start-up and on a reload."""
    from nerfmlp_torch.parallel.train_step import create_train_state

    state = create_train_state(RenderConfig(**KW), TrainConfig(), "cpu")
    state.set_step(1234)
    path = str(tmp_path / "metrics_latest.pt")
    ckpt.save_checkpoint(path, state)
    svc = _service(reload_fn=_reload_fn, watch_dir=str(tmp_path),
                   ckpt_path=path)
    assert svc.ckpt["step"] == 1234
    info = svc.reload(force=True)
    assert info["path"] == path and info["step"] == 1234
    assert ckpt.step_in_checkpoint(str(tmp_path / "missing.pt")) == 0


def test_watch_thread_swaps(tmp_path):
    svc = _reloadable(tmp_path)
    first = svc.render_pose(POSE)["rgb_map"]
    thread = svc.watch(0.05)
    try:
        ckpt.save_params(str(tmp_path / "model_300.pt"), _nets(2))
        deadline = time.time() + 20
        while svc.reloads == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert svc.reloads == 1 and svc.ckpt["step"] == 300
        assert np.abs(svc.render_pose(POSE)["rgb_map"] - first).max() > 0
    finally:
        thread.stop_event.set()
        thread.join(timeout=10)
    assert not thread.is_alive()


# ---- HTTP ---------------------------------------------------------------- #

def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def test_http_mesh_and_reload_routes(tmp_path):
    svc = _reloadable(tmp_path)
    server = RenderServer(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    try:
        status, body, ctype = _post(url + "/mesh", json.dumps(
            {"resolution": 8, "threshold": 1e9, "format": "json"}).encode())
        assert status == 200 and ctype == "application/json"
        assert json.loads(body)["faces"] == 0
        status, body, _ = _post(url + "/mesh", b'{"format": "stl"}')
        assert status == 400 and "format" in json.loads(body)["error"]
        ckpt.save_params(str(tmp_path / "model_500.pt"), _nets(3))
        status, body, _ = _post(url + "/reload", b"")
        out = json.loads(body)
        assert status == 200 and out["reloaded"] and out["step"] == 500
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            h = json.loads(r.read())
        assert h["reloads"] == 1 and h["ckpt"]["step"] == 500
        assert h["meshes"] == 1
        with urllib.request.urlopen(url + "/spec", timeout=30) as r:
            spec = json.loads(r.read())
        assert spec["hot_reload"] and spec["watch_dir"] == str(tmp_path)
        assert "not_ported" not in spec and spec["devices"] == ["cpu"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_serve_cli_flags(tmp_path):
    """--max_mesh_resolution, --watch_dir and its default: the checkpoint's
    directory for a Trainer's .pt, none for a reference .pth unless
    watching."""
    from nerfmlp_torch.scripts.serve import build_parser, build_service

    path = str(tmp_path / "model_700.pt")
    ckpt.save_params(path, _nets(0))
    base = ["--device", "cpu", "--focal", "20", "--img_wh", "16", "16",
            "--netdepth", "2", "--netwidth", "32", "--compute_dtype",
            "float32", "--fp32_precision", "highest", "--N_samples", "8",
            "--N_importance", "4", "--aabb", *map(str, BOX)]
    svc = build_service(build_parser().parse_args(
        base + ["--ckpt", path, "--max_mesh_resolution", "64"]))
    assert svc.max_mesh_resolution == 64 and svc.ckpt["step"] == 700
    assert svc.watch_dir == str(tmp_path) and svc.reload_fn is not None
    pth = str(tmp_path / "ref.pth")
    torch.save({k: v.detach() for k, v in _nets(0)["coarse"].state_dict()
                .items()}, pth)
    args = build_parser().parse_args(base + ["--ckpt", pth])
    assert build_service(args).watch_dir is None
    args = build_parser().parse_args(base + ["--ckpt", pth, "--watch", "2"])
    assert args.watch == 2.0 and build_service(args).watch_dir == str(
        tmp_path)
    other = str(tmp_path / "runs")
    args = build_parser().parse_args(base + ["--ckpt", pth, "--watch_dir",
                                             other])
    assert build_service(args).watch_dir == other
