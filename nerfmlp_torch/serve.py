"""Persistent render serving on one GPU or several — load once, serve
frames.

Counterpart of ``nerfmlp_tpu/serve.py``. :class:`RenderService` is the
embeddable core (weights + config + device behind a dispatch lock);
:func:`serve` wraps it in a threaded stdlib HTTP server with a JSON API:

    GET  /health    -> status, render and mesh counts, queue, reloads,
                       served checkpoint, latency percentiles (call to
                       body) and those of the wait for the dispatch lock
    GET  /spec      -> model / render configuration + defaults
    POST /render    -> image bytes (png, default), .npy bytes, or JSON
    POST /mesh      -> density-isosurface mesh of the served weights
                       (ops/mesh.py): binary .ply (default), .obj, or JSON
                       counts
    POST /reload    -> swap in the newest checkpoint of the watch dir

``POST /render`` takes one camera per request — ``{"c2w": 3x4 | 4x4}``,
``{"eye", "target"[, "up"]}`` or ``{"theta", "phi", "radius"}`` — plus
optional ``H``/``W``/``focal``/``near``/``far`` overrides, ``gamma``,
``brightness``, ``format`` ("png" | "npy" | "json"), ``maps`` and
``viewdirs_c2w``.

Device work is serialized by a lock; at most ``max_queue`` requests render
or extract a mesh, or wait, at once, and the excess is shed with HTTP 503
+ Retry-After. A config with ``use_occupancy`` is served with a density
grid that the service builds from its weights, at start-up and on every
weight swap.

While a ``torch.profiler`` profile runs, each request records the spans
(``utils/spans.py``) ``serve.request`` (grouped by its number) and
inside it ``serve.wait`` (the lock), ``serve.render`` (rays and the tile
loop's launches), ``serve.copy`` (the copy back, which waits for the
device) and ``serve.encode`` (the body).

Hot reload serves a model while it trains: point ``watch_dir`` at a
Trainer's ``--save_dir`` and :meth:`RenderService.watch` swaps in every
newer ``model_{step}[_latest].pt`` or the JAX Trainer's ``.ckpt``
(``metrics_latest.pt`` / ``.ckpt`` until one exists); ``POST /reload``
forces a swap. The Trainer writes each file to
``*.tmp`` and renames it, and no ``.tmp`` name is ever picked.

Several cards (``devices``, ``nerfmlp_tpu/serve.py:125-145``, ``:301-317``):
each frame's pixel grid is dealt over them
(``parallel/render_parallel.py``), the weights and the grid replicated
once per service and on every swap or reload, so a frame copies no
weights; ``tile`` stays the rays per dispatch, each card's tile
``ceil(tile / n)`` (at least 256). ``POST /mesh`` deals its density and
colour chunks over the same replicas (``ops/mesh.py::extract_mesh(mesh=)``,
JAX's ``serve.py:502``): the volume and faces are one card's.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import json
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from nerfmlp_torch import resolve_device, use_true_fp32
from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.utils.spans import span

_VALID_MAPS = ("rgb_map", "disp_map", "depth_map", "acc_map")
# A camera-spec JSON body is a few hundred bytes.
MAX_BODY_BYTES = 1 << 20
ROUTES = ("GET /health", "GET /spec", "POST /render", "POST /mesh",
          "POST /reload")
# The seed of the grid a service builds from its weights: a fixed one, so a
# restart serves the same grid.
GRID_SEED = 0


def grid_from_weights(params: Dict, cfg: RenderConfig):
    """The density grid a process with no training loop renders with:
    ``ops/occupancy.py::build_grid`` of ``params`` at ``cfg.occ_grid_size``,
    its jitter drawn on the nets' device from ``GRID_SEED`` — the service's
    grid, and the inference CLIs'."""
    import torch

    from nerfmlp_torch.ops.occupancy import build_grid
    from nerfmlp_torch.render_path import params_device

    gen = torch.Generator(device=params_device(params)).manual_seed(GRID_SEED)
    return build_grid(params, cfg, gen, resolution=cfg.occ_grid_size)


class RequestError(ValueError):
    """A malformed render request (maps to HTTP 400)."""


class ServiceOverloaded(RuntimeError):
    """Render queue is full (maps to HTTP 503 + Retry-After)."""


class RenderService:
    """A loaded model + render config held resident for repeated frames.

    ``params``: ``{"coarse": NeRFMLP, ["fine": NeRFMLP]}``, moved to
    ``device`` (default ``cuda``) and packed for the kernel once here and
    on every :meth:`swap_params`. With ``cfg.use_occupancy`` (which needs
    ``cfg.aabb``) every frame renders with ``occ_grid``, built from the
    weights by ``ops/occupancy.build_grid`` at ``cfg.occ_grid_size`` from
    ``GRID_SEED``, here and on every swap. Starting a service keeps TF32
    off process-wide (:func:`nerfmlp_torch.use_true_fp32`). Thread-safe:
    device work is serialized internally.

    ``max_mesh_resolution``: the cap of ``POST /mesh``'s grid (0 disables
    the route). ``reload_fn(path)``: weights, or ``(weights, step)``, of a
    checkpoint, for :meth:`reload`; ``watch_dir``: where :meth:`reload`
    and :meth:`watch` look (without it, the served file is reloaded).
    ``devices``: more than one device (the first is usually ``device``,
    and one may repeat) shards every frame over them; one or ``None``
    renders on ``device``.
    """

    def __init__(
        self,
        params: Dict,
        cfg: RenderConfig,
        H: int,
        W: int,
        focal: float,
        *,
        near: Optional[float] = None,
        far: Optional[float] = None,
        tile: int = 4096,
        max_pixels: int = 4096 * 4096,
        max_queue: int = 8,
        max_mesh_resolution: int = 256,
        reload_fn: Optional[Callable[[str], object]] = None,
        watch_dir: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        ckpt_step: Optional[int] = None,
        device=None,
        devices=None,
        log=print,
    ):
        if cfg.use_occupancy and cfg.aabb is None:
            raise ValueError("use_occupancy requires RenderConfig.aabb "
                             "(--aabb): the grid covers that box")
        self.device = resolve_device(device)
        use_true_fp32()
        self.cfg = cfg
        self.devices = None
        if devices is not None and len(devices) > 1:
            import torch

            self.devices = tuple(torch.device(d) for d in devices)
        self.params = self._prepare(params)
        self.occ_grid = self._build_grid(self.params)
        self.replicas = self._replicate(self.params, self.occ_grid)
        self.tile = int(tile)
        self.defaults = {
            "H": int(H),
            "W": int(W),
            "focal": float(focal),
            "near": float(cfg.near if near is None else near),
            "far": float(cfg.far if far is None else far),
        }
        self.max_pixels = int(max_pixels)
        self.max_queue = int(max_queue)
        self._inflight = 0
        self.rejected = 0
        # /mesh: G^3 queries; the cap keeps one request from holding the
        # device for minutes.
        self.max_mesh_resolution = int(max_mesh_resolution)
        self.meshes = 0
        self._mesh_times = deque(maxlen=16)    # seconds per extraction
        self._mesh_active = 0                  # extractions in progress
        self.reload_fn = reload_fn
        self.watch_dir = watch_dir
        self.ckpt = {
            "path": ckpt_path,
            "mtime": _mtime(ckpt_path),
            "step": int(ckpt_step) if ckpt_step is not None
            else _ckpt_step(ckpt_path),
        }
        self.reloads = 0
        self.log = log
        self.renders = 0
        self.warm = False
        self.warmup_s: Optional[float] = None
        self._times = deque(maxlen=128)        # seconds, call to result
        self._waits = deque(maxlen=128)        # seconds for the lock
        self._request_ids = itertools.count(1)
        self._lock = threading.Lock()          # device dispatch
        self._stats_lock = threading.Lock()    # counters, for /health
        self._reload_lock = threading.Lock()   # the watcher vs POST /reload

    def _prepare(self, params: Dict) -> Dict:
        from nerfmlp_torch.ops.render import prepare_params

        return prepare_params(
            {k: net.to(self.device) for k, net in params.items()}, self.cfg
        )

    def _replicate(self, params: Dict, occ_grid):
        """The weights and grid on every card of ``devices`` (None on
        one)."""
        if self.devices is None:
            return None
        from nerfmlp_torch.parallel.render_parallel import replicate

        return replicate(params, self.cfg, self.devices, occ_grid)

    def _build_grid(self, params: Dict):
        """The density grid of prepared ``params``, or None without
        ``cfg.use_occupancy``."""
        if not self.cfg.use_occupancy:
            return None
        return grid_from_weights(params, self.cfg)

    # -------------------------------------------------------------- #
    # Core rendering
    # -------------------------------------------------------------- #
    def render_pose(
        self,
        c2w: np.ndarray,
        H: Optional[int] = None,
        W: Optional[int] = None,
        focal: Optional[float] = None,
        near: Optional[float] = None,
        far: Optional[float] = None,
        viewdirs_c2w: Optional[np.ndarray] = None,
        maps: Tuple[str, ...] = ("rgb_map",),
        _record_stats: bool = True,
    ) -> Dict[str, np.ndarray]:
        """Render one camera; returns the requested maps as (H, W[, C])
        numpy arrays."""
        t0 = time.perf_counter()
        out = self._render_pose(c2w, H, W, focal, near, far, viewdirs_c2w,
                                maps, _record_stats)
        if _record_stats:
            self._record(time.perf_counter() - t0)
        return out

    def _render_pose(self, c2w, H, W, focal, near, far, viewdirs_c2w, maps,
                     _record_stats):
        """:meth:`render_pose` without its latency record."""
        try:
            H = int(self.defaults["H"] if H is None else H)
            W = int(self.defaults["W"] if W is None else W)
            focal = float(self.defaults["focal"] if focal is None else focal)
            near = self.defaults["near"] if near is None else float(near)
            far = self.defaults["far"] if far is None else float(far)
        except (TypeError, ValueError) as e:
            raise RequestError(f"H/W/focal/near/far must be numeric: {e}")
        if H <= 0 or W <= 0 or H * W > self.max_pixels:
            raise RequestError(
                f"image shape {W}x{H} outside (0, {self.max_pixels}] pixels")
        for m in maps:
            if m not in _VALID_MAPS:
                raise RequestError(f"unknown map {m!r}; valid: {_VALID_MAPS}")
        c2w = _as_pose(c2w, "c2w")
        if viewdirs_c2w is not None:
            viewdirs_c2w = _as_pose(viewdirs_c2w, "viewdirs_c2w")
        # Admission BEFORE any device work; the warmup render bypasses it.
        with self._admit(_record_stats):
            return self._render_admitted(c2w, viewdirs_c2w, H, W, focal, near,
                                         far, maps, _record_stats)

    @contextmanager
    def _admit(self, record: bool = True):
        """Admission slot: raises :class:`ServiceOverloaded` when
        ``max_queue`` requests are already rendering or waiting. Renders
        and mesh extractions share it: both hold the device."""
        if record:
            with self._stats_lock:
                if self.max_queue and self._inflight >= self.max_queue:
                    self.rejected += 1
                    raise ServiceOverloaded(
                        f"{self._inflight} renders in flight "
                        f"(max_queue={self.max_queue})")
                self._inflight += 1
        try:
            yield
        finally:
            if record:
                with self._stats_lock:
                    self._inflight -= 1

    def _render_admitted(self, c2w, viewdirs_c2w, H, W, focal, near, far,
                         maps, _record_stats):
        from nerfmlp_torch.ops.render import render_image_maps
        from nerfmlp_torch.parallel.render_parallel import (
            render_image_sharded,
        )
        from nerfmlp_torch.render_path import rays_for_pose_device

        t0 = time.perf_counter()
        with span("serve.wait"):
            self._lock.acquire()
        waited = time.perf_counter() - t0
        try:
            with span("serve.render"):
                # Rays are generated on the device from the 16-float pose.
                o, d, vd = rays_for_pose_device(
                    c2w, H, W, focal, self.cfg, viewdirs_pose=viewdirs_c2w,
                    device=self.device,
                )
                if self.replicas is None:
                    out = render_image_maps(
                        self.params, o, d, H, W, self.cfg, tile=self.tile,
                        near=near, far=far, occ_grid=self.occ_grid,
                        viewdirs=vd, maps=tuple(maps),
                    )
                else:
                    out = render_image_sharded(
                        self.params, o, d, H, W, self.cfg, self.replicas,
                        tile=max(256, -(-self.tile // len(self.devices))),
                        near=near, far=far, viewdirs=vd, maps=tuple(maps))
            # The copy to the host waits for the device.
            with span("serve.copy"):
                result = {k: v.float().cpu().numpy() for k, v in out.items()}
        finally:
            self._lock.release()
        if _record_stats:
            with self._stats_lock:
                self._waits.append(waited)
        return result

    def _record(self, seconds: float) -> None:
        """One served request's latency, for /health and Retry-After."""
        with self._stats_lock:
            self._times.append(seconds)
            self.renders += 1

    def warmup(self) -> float:
        """Render the default shape once (kernel build and first launches);
        excluded from the latency stats and the render count."""
        from nerfmlp_torch.ops.rays import pose_spherical

        t0 = time.perf_counter()
        self.render_pose(pose_spherical(0.0, -30.0, 4.0), _record_stats=False)
        dt = time.perf_counter() - t0
        self.warm = True
        self.warmup_s = dt
        self.log(f"warmup render ({self.defaults['W']}x{self.defaults['H']})"
                 f" in {dt:.1f}s")
        return dt

    # -------------------------------------------------------------- #
    # Request handling (transport-independent)
    # -------------------------------------------------------------- #
    def render_request(self, req: Dict) -> Tuple[bytes, str]:
        """JSON request dict -> (body bytes, content type): the core of
        ``POST /render``, callable without a socket. Its latency, from this
        call to the body, feeds :meth:`health` and :meth:`retry_after_s`."""
        t0 = time.perf_counter()
        with span("serve.request", group=next(self._request_ids)):
            body = self._render_request(req)
        self._record(time.perf_counter() - t0)
        return body

    def _render_request(self, req: Dict) -> Tuple[bytes, str]:
        """:meth:`render_request` without its latency record."""
        if not isinstance(req, dict):
            raise RequestError("request body must be a JSON object")
        c2w = _pose_from_request(req)
        fmt = req.get("format", "png")
        maps_req = req.get("maps", ("rgb_map",))
        if isinstance(maps_req, str):
            maps_req = (maps_req,)
        if not isinstance(maps_req, (list, tuple)) or not all(
            isinstance(m, str) for m in maps_req
        ):
            raise RequestError('"maps" must be a list of map names '
                               f"(valid: {_VALID_MAPS})")
        maps = tuple(maps_req)
        if fmt == "png" and maps != ("rgb_map",):
            raise RequestError('format "png" serves rgb_map only; use '
                               '"npy"/"json" for other maps')
        out = self._render_pose(
            c2w, req.get("H"), req.get("W"), req.get("focal"),
            req.get("near"), req.get("far"),
            (_as_pose(req["viewdirs_c2w"], "viewdirs_c2w")
             if "viewdirs_c2w" in req else None),
            maps, True,
        )
        with span("serve.encode"):
            return self._encode(req, out, fmt, maps)

    @staticmethod
    def _encode(req: Dict, out: Dict[str, np.ndarray], fmt, maps):
        """The rendered maps -> (body bytes, content type) in ``fmt``."""
        if "rgb_map" in out:
            # Brightness, then gamma (the reference CLI's order).
            try:
                brightness = float(req.get("brightness", 1.0))
            except (TypeError, ValueError) as e:
                raise RequestError(f"brightness must be numeric: {e}")
            rgb = np.clip(out["rgb_map"] * brightness, 0.0, 1.0)
            if req.get("gamma"):
                from nerfmlp_torch.data.blender import linear_to_srgb

                rgb = linear_to_srgb(rgb)
            out["rgb_map"] = rgb

        if fmt == "png":
            from nerfmlp_torch.utils.image import png_bytes

            arr = (out["rgb_map"] * 255).round().astype(np.uint8)
            return png_bytes(arr), "image/png"
        if fmt == "npy":
            if len(maps) != 1:
                raise RequestError('format "npy" serves exactly one map; '
                                   'use "json" for several')
            buf = io.BytesIO()
            np.save(buf, out[maps[0]].astype(np.float32))
            return buf.getvalue(), "application/octet-stream"
        if fmt == "json":
            body = {k: np.asarray(v, np.float32).tolist()
                    for k, v in out.items()}
            return json.dumps(body).encode(), "application/json"
        raise RequestError(f"unknown format {fmt!r}; png | npy | json")

    def mesh_request(self, req: Dict) -> Tuple[bytes, str]:
        """``POST /mesh``: the density-isosurface mesh of the served
        weights -> (body bytes, content type).

        Request keys, all optional: ``resolution`` (grid nodes per axis,
        default 128, at most ``max_mesh_resolution``), ``threshold`` (sigma
        iso level, default 25), ``aabb`` (6 floats; default the render
        config's box, which is then required), ``color`` (bake vertex RGB,
        default true), ``gamma`` (sRGB-encode it, default false),
        ``format`` ("ply" binary | "obj" | "json" counts). Takes an
        admission slot like a render, and the dispatch lock for the
        density evaluation and the colour bake only. Reads ``self.params``
        once: a reload during an extraction serves the next request.
        """
        if not isinstance(req, dict):
            raise RequestError("request body must be a JSON object")
        if not self.max_mesh_resolution:
            raise RequestError("mesh extraction disabled on this server "
                               "(max_mesh_resolution=0)")
        try:
            resolution = int(req.get("resolution", 128))
            threshold = float(req.get("threshold", 25.0))
        except (TypeError, ValueError) as e:
            raise RequestError(f"resolution/threshold must be numeric: {e}")
        if not 2 <= resolution <= self.max_mesh_resolution:
            raise RequestError(
                f"resolution must be in [2, {self.max_mesh_resolution}]")
        if not math.isfinite(threshold):
            raise RequestError("threshold must be finite")
        aabb = req.get("aabb", self.cfg.aabb)
        if aabb is None:
            raise RequestError(
                'no scene bounds: pass "aabb": [xmin,ymin,zmin,'
                "xmax,ymax,zmax] or start the server with --aabb")
        from nerfmlp_torch.ops.mesh import (
            _check_aabb, extract_mesh, obj_str, ply_bytes,
        )

        try:
            aabb = _check_aabb(aabb)
        except (TypeError, ValueError) as e:
            raise RequestError(str(e))
        color = bool(req.get("color", True))
        gamma = bool(req.get("gamma", False))
        fmt = req.get("format", "ply")
        if fmt not in ("ply", "obj", "json"):
            raise RequestError(f"unknown format {fmt!r}; ply | obj | json")

        with self._admit():
            with self._stats_lock:
                self._mesh_active += 1
            try:
                t0 = time.perf_counter()
                # One read: a swap replaces the attribute, never the dict;
                # over several devices, the replicas (placed together).
                reps = self.replicas
                params = (self.params if reps is None
                          else reps.params[reps.devices[0]])
                mesh = extract_mesh(params, self.cfg, resolution=resolution,
                                    threshold=threshold, aabb=aabb,
                                    color=color, gamma=gamma,
                                    device_lock=self._lock, mesh=reps)
                dt = time.perf_counter() - t0
            finally:
                with self._stats_lock:
                    self._mesh_active -= 1
        with self._stats_lock:
            self.meshes += 1
            self._mesh_times.append(dt)
        self.log(f"mesh {resolution}^3 iso {threshold:g}: "
                 f"{len(mesh['verts'])} verts / {len(mesh['faces'])} faces "
                 f"in {dt:.1f}s")
        if fmt == "json":
            return json.dumps({
                "verts": len(mesh["verts"]),
                "faces": len(mesh["faces"]),
                "sigma_min": mesh["sigma_min"],
                "sigma_max": mesh["sigma_max"],
                "resolution": resolution,
                "threshold": threshold,
                "aabb": list(aabb),
                "seconds": round(dt, 3),
            }).encode(), "application/json"
        if fmt == "obj":
            body = obj_str(mesh["verts"], mesh["faces"],
                           colors=mesh.get("colors"))
            return body.encode(), "text/plain; charset=utf-8"
        return ply_bytes(mesh["verts"], mesh["faces"],
                         colors=mesh.get("colors"), normals=mesh["normals"],
                         binary=True), "application/octet-stream"

    def spec(self) -> Dict:
        from nerfmlp_torch.ops.render import uses_kernel

        return {
            "defaults": dict(self.defaults),
            "tile": self.tile,
            "max_pixels": self.max_pixels,
            "max_queue": self.max_queue,
            "max_mesh_resolution": self.max_mesh_resolution,
            "hot_reload": self.reload_fn is not None,
            "watch_dir": self.watch_dir,
            "device": str(self.device),
            "devices": [str(d) for d in self.devices or (self.device,)],
            "kernel": uses_kernel(self.cfg),
            "occupancy": self.cfg.use_occupancy,
            "routes": list(ROUTES),
            "render_config": dataclasses.asdict(self.cfg),
        }

    def retry_after_s(self) -> int:
        """Whole-second Retry-After hint for shed requests: one median
        request of the last 128 (from the call of :meth:`render_request`
        or :meth:`render_pose` to its result, queue and encode included:
        a queue slot frees roughly that often), floor 1 s; while a mesh
        extraction runs, at least one median extraction (30 s before the
        first has finished)."""
        with self._stats_lock:
            times = sorted(self._times)
            mesh_times = sorted(self._mesh_times)
            mesh_active = self._mesh_active
        hint = times[len(times) // 2] if times else 1.0
        if mesh_active:
            hint = max(hint, mesh_times[len(mesh_times) // 2] if mesh_times
                       else 30.0)
        return max(1, round(hint))

    def health(self) -> Dict:
        """``GET /health``: counts, the queue, the served checkpoint and
        ``latency`` over the last 128 requests, each from the call of
        :meth:`render_request` (or :meth:`render_pose`) to its body (or
        maps): the parse, the wait for the dispatch lock, the render, the
        copy back and the encode, the window a client sees; ``wait_ms``
        holds the p50 and p95 of the wait for the lock alone."""
        # Stats lock only: /health answers at once even mid-render.
        with self._stats_lock:
            raw = list(self._times)
            waits = sorted(self._waits)
            renders = self.renders
            meshes = self.meshes
            mesh_times = list(self._mesh_times)
            inflight = self._inflight
            rejected = self.rejected
        times = sorted(raw)

        def pct(xs, q: float) -> float:  # ms at the nearest rank
            i = max(0, math.ceil(q * len(xs)) - 1)
            return round(xs[min(i, len(xs) - 1)] * 1e3, 2)

        lat = None
        if times:
            lat = {
                "n": len(times),
                "p50_ms": pct(times, 0.50),
                "p95_ms": pct(times, 0.95),
                "p99_ms": pct(times, 0.99),
                "max_ms": round(times[-1] * 1e3, 2),
                "last_ms": round(raw[-1] * 1e3, 2),
                "wait_ms": ({"p50": pct(waits, 0.50),
                             "p95": pct(waits, 0.95)} if waits else None),
            }
        return {
            "status": "ok",
            "renders": renders,
            "meshes": meshes,
            "mesh_last_s": round(mesh_times[-1], 3) if mesh_times else None,
            "queued": inflight,
            "max_queue": self.max_queue,
            "rejected": rejected,
            "warm": self.warm,
            "warmup_s": None if self.warmup_s is None
            else round(self.warmup_s, 2),
            "reloads": self.reloads,
            "ckpt": dict(self.ckpt),
            "device": str(self.device),
            "latency": lat,
        }

    def swap_params(self, params: Dict, source: str = "<direct>") -> None:
        """Atomically replace the served weights (and the density grid,
        rebuilt from them; both replicated over ``devices``): moved,
        packed and rebuilt here, outside the lock; in-flight renders
        finish on the old weights."""
        params = self._prepare(params)
        occ_grid = self._build_grid(params)
        replicas = self._replicate(params, occ_grid)
        with self._lock:
            self.params = params
            self.occ_grid = occ_grid
            self.replicas = replicas
            self.reloads += 1
        self.log(f"params swapped from {source} (reload #{self.reloads})")

    # -------------------------------------------------------------- #
    # Hot checkpoint reload (serve a model while it trains)
    # -------------------------------------------------------------- #
    def reload(self, force: bool = True) -> Optional[Dict]:
        """Load the newest checkpoint and serve it; returns the new
        ``ckpt`` record (path, mtime, step).

        The path is :func:`latest_params_checkpoint` of ``watch_dir``, or
        without one the served file; never one from the caller, so the
        HTTP layer loads no file a client names. ``force=False`` (the
        watcher's mode) is a no-op, returning None, unless the path or
        its mtime differs from the served one. The record is written only
        after the swap: a load that fails leaves it, so the watcher tries
        the file again.
        """
        if self.reload_fn is None:
            raise RequestError("server was started without reload support")
        # One reload at a time: an older file must not be swapped in last
        # while the record names the newer one.
        with self._reload_lock:
            path = (latest_params_checkpoint(self.watch_dir)
                    if self.watch_dir else self.ckpt["path"])
            if path is None:
                if force:
                    if self.watch_dir is None:
                        raise RequestError(
                            "server has no watch dir and no original "
                            "checkpoint path — nothing to reload")
                    raise RequestError(
                        f"no checkpoint found in {self.watch_dir!r}")
                return None
            mtime = _mtime(path)
            if not force and (path, mtime) == (self.ckpt["path"],
                                               self.ckpt["mtime"]):
                return None
            loaded = self.reload_fn(path)
            step = None
            if isinstance(loaded, tuple):   # (params, step): one decode
                loaded, step = loaded
            self.swap_params(loaded, source=path)
            self.ckpt = {"path": path, "mtime": mtime,
                         "step": step if step is not None
                         else _ckpt_step(path)}
            return dict(self.ckpt)

    def watch(self, interval_s: float,
              stop: Optional[threading.Event] = None) -> threading.Thread:
        """Poll ``watch_dir`` every ``interval_s`` and swap in newer
        checkpoints, on a daemon thread (``thread.stop_event`` stops it).
        A failed load is logged and tried again at the next poll."""
        stop = stop or threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    info = self.reload(force=False)
                    if info:
                        self.log(f"watch: now serving step {info['step']}"
                                 f" ({os.path.basename(info['path'])})")
                except Exception as e:  # a file being replaced: retry
                    self.log(f"watch: reload failed ({e}); retrying")

        thread = threading.Thread(target=loop, daemon=True,
                                  name="ckpt-watch")
        thread.stop_event = stop  # type: ignore[attr-defined]
        thread.start()
        return thread


def latest_params_checkpoint(save_dir: str) -> Optional[str]:
    """The newest checkpoint to serve from a Trainer's save dir, the port's
    or the JAX package's: the highest-step ``model_{step}.pt`` /
    ``model_{step}_latest.pt`` / ``.ckpt`` (the newer file on a tie),
    else the newer of ``metrics_latest.pt`` and ``metrics_latest.ckpt``
    (whole train states, whose parameters ``load_params_any`` takes).
    ``model_best`` / ``model_final`` carry no step and never match, nor
    does a ``.tmp`` file a Trainer is still writing."""
    from nerfmlp_torch.train.checkpoint import step_from_filename

    if not os.path.isdir(save_dir):
        return None
    best: Tuple[int, float, Optional[str]] = (0, 0.0, None)
    for name in os.listdir(save_dir):
        if name.startswith("model_") and name.endswith((".pt", ".ckpt")):
            step = step_from_filename(name)
            if step <= 0:
                continue
            key = (step, _mtime(os.path.join(save_dir, name)) or 0.0, name)
            if key[:2] > best[:2]:
                best = key
    if best[2] is not None:
        return os.path.join(save_dir, best[2])
    states = [os.path.join(save_dir, f"metrics_latest{ext}")
              for ext in (".pt", ".ckpt")]
    states = [p for p in states if os.path.exists(p)]
    return max(states, key=lambda p: _mtime(p) or 0.0) if states else None


def _ckpt_step(path: Optional[str]) -> int:
    """The step for /health: from the file name, else from inside a whole
    train state (``metrics_latest.pt`` / ``.ckpt``)."""
    if not path:
        return 0
    from nerfmlp_torch.train.checkpoint import (
        step_from_filename, step_in_checkpoint,
    )

    return step_from_filename(path) or step_in_checkpoint(path)


def _mtime(path: Optional[str]) -> Optional[float]:
    try:
        return os.path.getmtime(path) if path else None
    except OSError:
        return None


def _as_pose(x, name: str) -> np.ndarray:
    try:
        pose = np.asarray(x, dtype=np.float32)
    except (TypeError, ValueError) as e:  # ragged / non-numeric input
        raise RequestError(f"{name} is not a numeric matrix: {e}")
    if pose.shape == (3, 4):
        pose = np.concatenate([pose, np.array([[0, 0, 0, 1]], np.float32)],
                              axis=0)
    if pose.shape != (4, 4):
        raise RequestError(f"{name} must be 3x4 or 4x4, got {pose.shape}")
    if not np.all(np.isfinite(pose)):
        raise RequestError(f"{name} contains non-finite values")
    return pose


def _pose_from_request(req: Dict) -> np.ndarray:
    """One camera per request: c2w | eye/target | theta/phi/radius."""
    from nerfmlp_torch.ops.rays import look_at_matrix, pose_spherical

    specs = [k for k in ("c2w", "eye", "theta") if k in req]
    if len(specs) != 1:
        raise RequestError(
            'exactly one camera spec required: "c2w", "eye"+"target", or '
            '"theta"+"phi"+"radius"')
    if "c2w" in req:
        return _as_pose(req["c2w"], "c2w")
    if "eye" in req:
        if "target" not in req:
            raise RequestError('"eye" camera needs "target"')
        try:
            eye = np.asarray(req["eye"], np.float32)
            target = np.asarray(req["target"], np.float32)
            up = np.asarray(req["up"], np.float32) if "up" in req else None
        except (TypeError, ValueError) as e:
            raise RequestError(f'"eye"/"target"/"up" must be numeric: {e}')
        if eye.shape != (3,) or target.shape != (3,):
            raise RequestError('"eye"/"target" must be 3-vectors')
        if up is not None and up.shape != (3,):
            raise RequestError('"up" must be a 3-vector')
        return look_at_matrix(eye, target, up)
    try:
        return pose_spherical(float(req["theta"]), float(req["phi"]),
                              float(req["radius"]))
    except KeyError as e:
        raise RequestError('spherical camera needs "theta","phi","radius"'
                           f" (missing {e})")
    except (TypeError, ValueError) as e:
        raise RequestError(f"theta/phi/radius must be numeric: {e}")


# ------------------------------------------------------------------ #
# HTTP layer (stdlib only)
# ------------------------------------------------------------------ #
class _Handler(BaseHTTPRequestHandler):
    # A client that advertises a body and stalls must not hold its
    # handler thread forever.
    timeout = 60

    def log_message(self, fmt, *args):  # noqa: D102 (quiet by default)
        pass

    @property
    def service(self) -> RenderService:
        return self.server.service  # type: ignore[attr-defined]

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def _no_route(self):
        self._reply_json(404, {"error": f"no route {self.path}"})

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self._reply_json(200, self.service.health())
        elif self.path == "/spec":
            self._reply_json(200, self.service.spec())
        else:
            self._no_route()

    def do_POST(self):  # noqa: N802
        if self.path not in ("/render", "/mesh", "/reload"):
            self._no_route()
            return
        try:
            if self.path == "/reload":
                # The configured watch dir or served file only: no path
                # from the wire.
                info = self.service.reload(force=True)
                self._reply_json(200, {"reloaded": True, **info})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                n = -1
            if n < 0:
                # Unread bodies would be parsed as the next request line,
                # and a negative length would read until EOF: close.
                self._reply_json(400, {"error": "bad Content-Length"})
                self.close_connection = True
                return
            if n > MAX_BODY_BYTES:
                # Reject without buffering: drain in bounded chunks so a
                # well-behaved client sees the 413; past 8x, just close.
                remaining = n if n <= 8 * MAX_BODY_BYTES else 0
                while remaining > 0:
                    chunk = self.rfile.read(min(65536, remaining))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self._reply_json(413, {
                    "error": f"request body {n} bytes exceeds "
                             f"{MAX_BODY_BYTES} (a camera spec is tiny)"})
                self.close_connection = True
                return
            req = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/mesh":
                body, ctype = self.service.mesh_request(req)
            else:
                body, ctype = self.service.render_request(req)
            self._reply(200, body, ctype)
        except RequestError as e:
            self._reply_json(400, {"error": str(e)})
        except ServiceOverloaded as e:
            retry = self.service.retry_after_s()
            body = json.dumps({"error": str(e), "retry_after_s": retry}).encode()
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", str(retry))
            self.end_headers()
            self.wfile.write(body)
        except json.JSONDecodeError as e:
            self._reply_json(400, {"error": f"bad JSON: {e}"})
        except Exception as e:  # render bug: report, keep serving
            self.service.log(f"request failed: {type(e).__name__}: {e}")
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})


class RenderServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the :class:`RenderService`."""

    daemon_threads = True

    def __init__(self, service: RenderService, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__((host, port), _Handler)
        self.service = service


def serve(service: RenderService, host: str = "127.0.0.1", port: int = 8008,
          warmup: bool = True, watch_interval: float = 0.0) -> None:
    """Blocking server loop (the ``nerfmlp_torch.scripts.serve`` entry);
    ``watch_interval`` > 0 starts :meth:`RenderService.watch`."""
    server = RenderServer(service, host, port)
    if warmup:
        service.warmup()
    if watch_interval > 0:
        service.watch(watch_interval)
        service.log(f"watching {service.watch_dir} every "
                    f"{watch_interval:g}s for newer checkpoints")
    h, p = server.server_address[:2]
    service.log(f"serving on http://{h}:{p}  ({', '.join(ROUTES)})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        service.log("shutting down")
    finally:
        server.server_close()
