"""Isosurface mesh extraction from a trained NeRF's density field.

Counterpart of ``nerfmlp_tpu/ops/mesh.py``: query sigma on a regular grid
over the scene box and surface the level set as a triangle mesh. Density
and colour mean what they mean to the renderer (relu of the 4th raw
output, sigmoid of the first three), and the grid query goes through the
renderer's ``_query_mlp`` with the occupancy refresh's constant view
direction, so the mesh is the level set of the field the renderer
integrates. Three stages:

1. **Density evaluation** (the operations): the G^3 node sigmas in chunks
   of at most 2^20 points, one sample each — on the card one forward
   kernel launch per chunk, on nets packed once by ``prepare_params``.
2. **Surface-cell compaction** (host, numpy): shifted views of the
   read-back volume find the cells whose corners span the threshold.
3. **Marching tetrahedra** (the volume's device): each surviving cube is
   split into 6 tetrahedra along its main diagonal; each tet's case picks
   its triangles' edge points from ``TRI_TABLE`` by indexing (the JAX
   package contracts one-hot selectors instead: the TPU's idiom).

Then, on the host as in the JAX package: welding by exact equality,
dropping degenerate faces, orienting each face against the density
gradient; and, for colour, one forward pass over the vertices looking
along their inward normals. The PLY and OBJ writers give the JAX
package's bytes.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.ops import device_constant

# ------------------------------------------------------------------ #
# Tetrahedral decomposition tables (``nerfmlp_tpu/ops/mesh.py:60-114``)
# ------------------------------------------------------------------ #

# Cube corners are bit-coded: corner c sits at offset (c&1, c>>1&1, c>>2&1)
# in (x, y, z). The 6 tets all share the main diagonal corner0-corner7 and
# correspond to the 6 axis orders of the path 0 -> a -> a|b -> 7; together
# they exactly partition the cube with conforming faces.
TET_CORNERS = np.array(
    [
        [0, 1, 3, 7],  # x, y, z
        [0, 1, 5, 7],  # x, z, y
        [0, 2, 3, 7],  # y, x, z
        [0, 2, 6, 7],  # y, z, x
        [0, 4, 5, 7],  # z, x, y
        [0, 4, 6, 7],  # z, y, x
    ],
    np.int32,
)

# The 6 edges of a tetrahedron as local-corner pairs.
TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32
)

# For each of the 16 inside/outside cases (bit i = local corner i above
# threshold): up to two triangles, each as 3 tet-edge ids (-1 = unused).
# Single-corner cases surface the 3 edges touching that corner; two-corner
# cases surface the quad of 4 crossing edges split along a diagonal.
TRI_TABLE = np.array(
    [
        [[-1, -1, -1], [-1, -1, -1]],  # 0000
        [[0, 1, 2], [-1, -1, -1]],     # 0001  c0
        [[0, 3, 4], [-1, -1, -1]],     # 0010  c1
        [[1, 2, 4], [1, 4, 3]],        # 0011  c0 c1
        [[1, 3, 5], [-1, -1, -1]],     # 0100  c2
        [[0, 3, 5], [0, 5, 2]],        # 0101  c0 c2
        [[0, 1, 5], [0, 5, 4]],        # 0110  c1 c2
        [[2, 4, 5], [-1, -1, -1]],     # 0111  c0 c1 c2
        [[2, 4, 5], [-1, -1, -1]],     # 1000  c3
        [[0, 4, 5], [0, 5, 1]],        # 1001  c0 c3
        [[0, 2, 5], [0, 5, 3]],        # 1010  c1 c3
        [[1, 3, 5], [-1, -1, -1]],     # 1011  c0 c1 c3
        [[1, 2, 4], [1, 4, 3]],        # 1100  c2 c3
        [[0, 3, 4], [-1, -1, -1]],     # 1101  c0 c2 c3
        [[0, 1, 2], [-1, -1, -1]],     # 1110  c1 c2 c3
        [[-1, -1, -1], [-1, -1, -1]],  # 1111
    ],
    np.int32,
)

# The edge-point index of every (case, tri, slot): unused slots pick index
# 6, a zero point.
_EDGE_PICK = np.where(TRI_TABLE < 0, 6, TRI_TABLE).astype(np.int64)
# The JAX package's header comment, so both packages write the same bytes.
_WRITER = "nerfmlp_tpu extract_mesh"


def _corner_offsets() -> np.ndarray:
    """(8, 3) unit-cell corner offsets in (x, y, z) for bit-coded ids."""
    c = np.arange(8)
    return np.stack([c & 1, (c >> 1) & 1, (c >> 2) & 1], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The corner offsets (8, 3), the edge picks (16, 2, 3) and the
    triangles' validity (16, 2) on ``device``, copied once."""
    return (torch.from_numpy(_corner_offsets()).to(device),
            torch.from_numpy(_EDGE_PICK).to(device),
            torch.from_numpy(TRI_TABLE[:, :, 0] >= 0).to(device))


def _tet_triangles(
    corner_vals: torch.Tensor,  # (C, 8) f32 cube-corner densities
    cell_idx: torch.Tensor,     # (C, 3) i32 integer cell coordinates
    box_min: torch.Tensor,      # (3,) f32
    cell_size: torch.Tensor,    # (3,) f32
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marching tetrahedra over a batch of cells, on their device.

    Returns (C, 6, 2, 3, 3) triangle vertex positions and a (C, 6, 2)
    validity mask; cells whose corners lie on one side give none.

    Corner positions are computed from INTEGER node indices
    (``box_min + (cell_idx + corner_bits) * cell_size``), and each edge
    point as ``pos_a + t * (pos_b - pos_a)`` in separate operations with
    its endpoints in corner-id order: every cell and tet that shares a
    grid edge computes its point from the same values in the same order,
    so shared points come out bit-identical and ``mesh_from_volume`` welds
    them by exact equality (``nerfmlp_tpu/ops/mesh.py:135-147``)."""
    dev = corner_vals.device
    thr = float(np.float32(threshold))
    bits, pick, valid_tab = _tables(dev)
    cells = cell_idx.to(torch.float32)[:, None, :]
    rows = torch.arange(corner_vals.shape[0], device=dev)[:, None, None]
    tris, valids = [], []
    for ids in TET_CORNERS.tolist():
        vals = corner_vals[:, ids]                        # (C, 4)
        pos = box_min + (cells + bits[ids]) * cell_size   # (C, 4, 3)
        inside = (vals > thr).to(torch.int64)
        case = (inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
                + 8 * inside[:, 3])
        pts = []
        for a, b in TET_EDGES.tolist():
            va, vb = vals[:, a], vals[:, b]
            denom = vb - va
            tt = (thr - va) / torch.where(denom.abs() < 1e-12,
                                          torch.full_like(denom, 1e-12),
                                          denom)
            tt = tt.clamp(0.0, 1.0)[:, None]
            pts.append(pos[:, a] + tt * (pos[:, b] - pos[:, a]))
        edge_pts = torch.stack(pts + [torch.zeros_like(pts[0])], 1)
        tris.append(edge_pts[rows, pick[case]])           # (C, 2, 3, 3)
        valids.append(valid_tab[case])                    # (C, 2)
    return torch.stack(tris, 1), torch.stack(valids, 1)


def _check_aabb(aabb):
    aabb = tuple(float(v) for v in aabb)
    if len(aabb) != 6 or not all(np.isfinite(aabb)) or not all(
        aabb[i] < aabb[i + 3] for i in range(3)
    ):
        raise ValueError(
            "aabb must be 6 finite numbers with min < max per axis, got "
            f"{aabb!r}"
        )
    return aabb


def _final(params: Dict, cfg: RenderConfig):
    """(net, is_fine, device) of the net that renders the final image,
    laid out for the kernel once for the whole call."""
    from nerfmlp_torch.ops.render import _final_net, prepare_params
    from nerfmlp_torch.render_path import params_device

    params = prepare_params(params, cfg)
    net, fine = _final_net(params, cfg)
    return net, fine, params_device(params)


def _workers(params: Dict, cfg: RenderConfig, mesh):
    """The nets that query a chunk, and the ranks that share the chunks:
    ([(net, is_fine, device)], None) for one device or a list of devices
    (their :class:`~nerfmlp_torch.parallel.render_parallel.Replicas`),
    ([this rank's], mesh) for a :class:`~nerfmlp_torch.parallel.mesh.
    Mesh` of ranks."""
    from nerfmlp_torch.parallel.mesh import Mesh
    from nerfmlp_torch.parallel.render_parallel import (
        Replicas, data_parallel_mesh, replicate,
    )

    mesh = data_parallel_mesh(mesh)
    if mesh is None or isinstance(mesh, Mesh):
        return [_final(params, cfg)], mesh
    reps = mesh if isinstance(mesh, Replicas) else replicate(params, cfg,
                                                             mesh)
    return [_final(reps.params[d], cfg) for d in reps.devices], None


def _over_chunks(starts, workers, ranks, query, shape, home) -> torch.Tensor:
    """``query(worker, start)`` for every chunk start, dealt whole over the
    workers (chunk i to worker i mod n; each runs the one-device call's
    shape, so each value is the one-device value, bit for bit, and the
    launches sum to the one-device count), or over the ranks of
    ``ranks`` (rank r takes chunks r, r + n, ...; all-gathered to every
    rank). Returns the (chunks, *shape) results in chunk order on
    ``home``."""
    from nerfmlp_torch.parallel.mesh import all_gather_rows

    starts = list(starts)
    if ranks is None:
        return torch.stack([query(workers[i % len(workers)], s).to(home)
                            for i, s in enumerate(starts)])
    n, r = ranks.world_size, ranks.rank
    per = -(-len(starts) // n)
    mine = [query(workers[0], starts[i]) for i in range(r, len(starts), n)]
    mine += [torch.zeros(shape, device=home)] * (per - len(mine))
    every = all_gather_rows(torch.stack(mine), ranks)      # rank-major
    return every.reshape((n, per) + tuple(shape)).transpose(0, 1).reshape(
        (n * per,) + tuple(shape))[:len(starts)]


def density_volume(
    params: Dict,
    cfg: RenderConfig,
    resolution: int = 128,
    aabb=None,
    chunk: int = 65536,
    mesh=None,
) -> np.ndarray:
    """relu(sigma) at (G, G, G) grid NODES spanning the box (inclusive).

    The occupancy refresh's query (``ops/occupancy.py::update_grid``): the
    final net, the constant view direction, one sample per point, no
    autograd; on the nets' device, in chunks of a power of two (at most
    2^20 and the request), each one ``_query_mlp`` call — on the card one
    forward kernel launch. Node ids are int32, the tail chunk's clamped
    to g^3 - 1; node points ``box_min + (ijk / max(g - 1, 1)) * span``.

    ``mesh``: several devices (a list, or their ``Replicas``) or a
    :class:`~nerfmlp_torch.parallel.mesh.Mesh` of ranks (JAX's
    ``_shard_rows`` over ``mesh=``, ``nerfmlp_tpu/ops/mesh.py:205-265``):
    the chunks are dealt over them whole and gathered in node order; the
    volume is one device's, bit for bit.
    """
    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.occupancy import _QUERY_DIR
    from nerfmlp_torch.ops.render import _query_mlp

    aabb = cfg.aabb if aabb is None else aabb
    if aabb is None:
        raise ValueError(
            "mesh extraction needs scene bounds: pass aabb= or set "
            "RenderConfig.aabb"
        )
    aabb = _check_aabb(aabb)
    g = int(resolution)
    if g < 2:
        raise ValueError(f"resolution must be >= 2, got {g}")
    if g > 1289:
        # int32 node ids: the tail chunk's start + arange(chunk) comes
        # before the clamp, so g^3 plus the 2^20 cap must fit.
        raise ValueError(f"resolution must be <= 1289 (int32 node ids), "
                         f"got {g}")
    workers, ranks = _workers(params, cfg, mesh)
    lo = np.asarray(aabb[:3], np.float32)
    span = np.asarray(aabb[3:], np.float32) - lo
    n = g * g * g
    chunk = max(1, min(int(chunk), 1 << 20, 1 << (n - 1).bit_length()))
    denom = float(max(g - 1, 1))
    consts = {}   # per device: box min, span, encoded direction, arange

    def sigma_chunk(worker, s):
        net, fine, dev = worker
        if dev not in consts:
            consts[dev] = (
                torch.from_numpy(lo).to(dev), torch.from_numpy(span).to(dev),
                positional_encoding(device_constant(
                    _QUERY_DIR, torch.float32, dev).expand(chunk, 3),
                    cfg.dir_enc_L) if cfg.use_viewdirs else None,
                torch.arange(chunk, dtype=torch.int32, device=dev))
        box_min, box_span, dirs_enc, ar = consts[dev]
        ids = torch.clamp(ar + s, max=n - 1)
        ijk = torch.stack([ids // (g * g), (ids // g) % g, ids % g], -1)
        pts = box_min + (ijk.to(torch.float32) / denom) * box_span
        raw = _query_mlp(net, pts[:, None, :], dirs_enc, cfg, fine=fine)
        return torch.relu(raw[:, 0, 3])

    with torch.no_grad():
        out = _over_chunks(range(0, n, chunk), workers, ranks, sigma_chunk,
                           (chunk,), workers[0][2])
    return out.reshape(-1)[:n].cpu().numpy().reshape(g, g, g)


def _active_cells(vol: np.ndarray, threshold: float):
    """(cell ids (A, 3) int64 in (x, y, z), corner values (A, 8)) of the
    cells whose corners span the threshold: shifted views of the volume,
    on the host."""
    g = vol.shape[0]
    # (dz, dy, dx) loops: index dx + 2*dy + 4*dz, the bit-coded corner ids.
    stack = np.stack([
        vol[dx: g - 1 + dx, dy: g - 1 + dy, dz: g - 1 + dz]
        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
    ], -1)                                     # (g-1, g-1, g-1, 8)
    active = (stack.min(-1) <= threshold) & (stack.max(-1) > threshold)
    return np.argwhere(active), stack[active]


def _tet_stage(idx: np.ndarray, corner_vals: np.ndarray, box_min, cell,
               threshold: float, chunk: int, device) -> np.ndarray:
    """(T, 3, 3) valid triangles of the active cells, in cell order,
    through :func:`_tet_triangles` in batches of ``chunk`` cells on
    ``device``."""
    dev = torch.device(device)
    chunk = max(1, int(chunk))
    bmin = torch.from_numpy(np.asarray(box_min, np.float32)).to(dev)
    cs = torch.from_numpy(np.asarray(cell, np.float32)).to(dev)
    cv_all = torch.from_numpy(np.ascontiguousarray(corner_vals)).to(dev)
    ci_all = torch.from_numpy(idx.astype(np.int32)).to(dev)
    out = []
    for s in range(0, cv_all.shape[0], chunk):
        tris, valid = _tet_triangles(cv_all[s:s + chunk], ci_all[s:s + chunk],
                                     bmin, cs, threshold)
        out.append(tris[valid])
    return torch.cat(out).cpu().numpy()


def _weld_and_orient(tris: np.ndarray, vol: np.ndarray, box_min,
                     cell) -> Tuple[np.ndarray, np.ndarray]:
    """Weld the triangles' points by exact equality, drop degenerate faces
    and orient each face along decreasing density (host, numpy)."""
    g = vol.shape[0]
    flat = tris.reshape(-1, 3)
    _, first, inverse = np.unique(
        flat, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[first]
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # A corner exactly at the threshold collapses an edge point onto a
    # tet corner shared by two slots.
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]
    # The volume's gradient at the node nearest each centroid, per-axis in
    # world units (np.gradient works in index units).
    gx, gy, gz = (g_ / c_ for g_, c_ in zip(np.gradient(vol), cell))
    centroid = verts[faces].mean(1)
    node = np.clip(
        np.round((centroid - box_min) / cell).astype(np.int64), 0, g - 1
    )
    grad = np.stack(
        [g_[node[:, 0], node[:, 1], node[:, 2]] for g_ in (gx, gy, gz)], -1
    )
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    normal = np.cross(e1, e2)
    flip = (normal * grad).sum(-1) > 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def mesh_from_volume(
    vol: np.ndarray,
    aabb,
    threshold: float,
    chunk: int = 16384,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Surface the ``density > threshold`` level set of a (G, G, G) volume.

    Returns (verts (V, 3) float32 world coords, faces (T, 3) int32), welded
    by exact equality, each face's normal along DECREASING density; an
    empty level set gives (0, 3) arrays. ``vol``: numpy, or a tensor. The
    tet stage runs on ``device`` — default: the tensor's device, the CPU
    for numpy — in batches of ``chunk`` cells; the other stages on the
    host.
    """
    if isinstance(vol, torch.Tensor):
        device = vol.device if device is None else device
        vol = vol.detach().cpu().numpy()
    device = "cpu" if device is None else device
    vol = np.asarray(vol, np.float32)
    g = vol.shape[0]
    if vol.shape != (g, g, g) or g < 2:
        raise ValueError(f"volume must be (G,G,G) with G>=2, got {vol.shape}")
    aabb = _check_aabb(aabb)
    box_min = np.asarray(aabb[:3], np.float32)
    box_max = np.asarray(aabb[3:], np.float32)
    cell = (box_max - box_min) / (g - 1)
    empty = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    idx, corner_vals = _active_cells(vol, threshold)
    if idx.shape[0] == 0:
        return empty
    tris = _tet_stage(idx, corner_vals, box_min, cell, threshold, chunk,
                      device)
    if tris.shape[0] == 0:
        return empty
    return _weld_and_orient(tris, vol, box_min, cell)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals from oriented faces (unit length)."""
    vn = np.zeros_like(verts)
    if faces.shape[0]:
        e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
        e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
        fn = np.cross(e1, e2)  # |fn| = 2*area: area weighting for free
        for c in range(3):
            np.add.at(vn, faces[:, c], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def vertex_colors(
    params: Dict,
    cfg: RenderConfig,
    verts: np.ndarray,
    normals: np.ndarray,
    chunk: int = 65536,
    mesh=None,
) -> np.ndarray:
    """Per-vertex RGB, sigmoid(raw[:, :3]), looking INTO the surface: the
    view direction at each vertex is its inward normal. On the nets'
    device in chunks of ``chunk`` vertices (the tail padded with points at
    0 and direction (0, 0, -1)), each one ``_query_mlp`` call — on the
    card one forward kernel launch. ``mesh``: as :func:`density_volume`
    takes it, the chunks dealt whole over its devices or ranks."""
    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.render import _query_mlp

    n = verts.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.float32)
    workers, ranks = _workers(params, cfg, mesh)
    chunk = max(1, min(int(chunk), n))
    total = -(-n // chunk) * chunk
    xv = np.zeros((total, 3), np.float32)
    xv[:n] = verts
    dv = np.tile(np.array([[0, 0, -1]], np.float32), (total, 1))
    dv[:n] = -np.asarray(normals, np.float32)
    xv, dv = torch.from_numpy(xv), torch.from_numpy(dv)

    def color_chunk(worker, s):
        net, fine, dev = worker
        pts, dirs = xv[s:s + chunk].to(dev), dv[s:s + chunk].to(dev)
        dirs_enc = (positional_encoding(dirs, cfg.dir_enc_L)
                    if cfg.use_viewdirs else None)
        raw = _query_mlp(net, pts[:, None, :], dirs_enc, cfg, fine=fine)
        return torch.sigmoid(raw[:, 0, :3])

    with torch.no_grad():
        out = _over_chunks(range(0, n, chunk), workers, ranks, color_chunk,
                           (chunk, 3), workers[0][2])
    return out.reshape(-1, 3)[:n].cpu().numpy()


def extract_mesh(
    params: Dict,
    cfg: RenderConfig,
    resolution: int = 128,
    threshold: float = 25.0,
    aabb=None,
    color: bool = True,
    density_chunk: int = 65536,
    cell_chunk: int = 16384,
    gamma: bool = False,
    device_lock=None,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Weights -> triangle mesh, end to end, on the nets' device, or with
    ``mesh`` (several devices, their ``Replicas``, or a ``Mesh`` of ranks,
    JAX's ``extract_mesh(mesh=)``) the density and colour chunks dealt
    over them: the same volume and faces as on one device. Over ranks
    every rank gets the mesh.

    Returns verts (V, 3) f32, faces (T, 3) i32, normals (V, 3) f32, colors
    (V, 3) f32 in [0, 1] (with ``color``), and the sigma volume's min and
    max (``sigma_min``, ``sigma_max``) for choosing a threshold.
    ``device_lock``: a context manager held around the density evaluation
    and the colour bake only, so the host stages between them do not
    block a concurrent render (the server passes its dispatch lock).
    ``gamma``: encode the baked colours to sRGB (the model outputs linear
    radiance). An NDC-trained model's field lives in NDC: pass the box in
    NDC space.
    """
    from nerfmlp_torch.ops.render import prepare_params
    from nerfmlp_torch.parallel.mesh import Mesh
    from nerfmlp_torch.parallel.render_parallel import Replicas, replicate
    from nerfmlp_torch.render_path import params_device

    params = prepare_params(params, cfg)   # packed once for both stages
    if mesh is not None and not isinstance(mesh, (Mesh, Replicas)):
        mesh = replicate(params, cfg, mesh)    # placed once for both too
    lock = device_lock if device_lock is not None else nullcontext()
    with lock:
        vol = density_volume(params, cfg, resolution=resolution, aabb=aabb,
                             chunk=density_chunk, mesh=mesh)
    use_aabb = cfg.aabb if aabb is None else aabb
    verts, faces = mesh_from_volume(vol, use_aabb, threshold,
                                    chunk=cell_chunk,
                                    device=params_device(params))
    normals = vertex_normals(verts, faces)
    out = {
        "verts": verts,
        "faces": faces,
        "normals": normals,
        "sigma_min": float(vol.min()),
        "sigma_max": float(vol.max()),
    }
    if color:
        with lock:
            rgb = vertex_colors(params, cfg, verts, normals, mesh=mesh)
        if gamma:
            from nerfmlp_torch.data.blender import linear_to_srgb

            rgb = linear_to_srgb(np.clip(rgb, 0.0, 1.0))
        out["colors"] = rgb
    return out


# ------------------------------------------------------------------ #
# Writers (.ply binary/ascii with optional vertex color, .obj), pure
# numpy: ``nerfmlp_tpu/ops/mesh.py:583-718``
# ------------------------------------------------------------------ #
def ply_bytes(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    binary: bool = True,
) -> bytes:
    """Standard PLY: float32 xyz [+ float32 nxnynz] [+ uchar rgb], int32
    triangle lists. Binary little-endian by default (ascii for eyeballs).
    Returns the full file as bytes (the server sends it over HTTP;
    :func:`save_ply` writes it to disk)."""
    verts = np.asarray(verts, "<f4")
    faces = np.asarray(faces, "<i4")
    n_v, n_f = verts.shape[0], faces.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [verts]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(normals, "<f4"))
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        cols.append(
            np.clip(np.asarray(colors) * 255.0 + 0.5, 0, 255).astype("u1")
        )
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"comment {_WRITER}\n"
        f"element vertex {n_v}\n" + "\n".join(props) + "\n"
        f"element face {n_f}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    parts = [header.encode("ascii")]
    if binary:
        fields = []
        for c in cols:
            for k in range(c.shape[1]):
                fields.append((f"f{len(fields)}", c.dtype.str))
        rec = np.empty(n_v, np.dtype(fields))
        i = 0
        for c in cols:
            for k in range(c.shape[1]):
                rec[f"f{i}"] = c[:, k]
                i += 1
        parts.append(rec.tobytes())
        frec = np.empty(
            n_f, np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
        )
        frec["n"] = 3
        frec["idx"] = faces
        parts.append(frec.tobytes())
    else:
        for row in np.concatenate(
            [np.asarray(c, np.float64) for c in cols], 1
        ):
            parts.append((" ".join(_fmt_ascii(row, cols)) + "\n").encode())
        for face in faces:
            parts.append(f"3 {face[0]} {face[1]} {face[2]}\n".encode())
    return b"".join(parts)


def save_ply(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write :func:`ply_bytes` to disk."""
    with open(path, "wb") as f:
        f.write(ply_bytes(verts, faces, colors=colors, normals=normals,
                          binary=binary))


def _fmt_ascii(row, cols):
    """Format one ascii PLY vertex row: %g floats, int uchar colors."""
    out, i = [], 0
    for c in cols:
        for _ in range(c.shape[1]):
            v = row[i]
            out.append(str(int(v)) if c.dtype.kind == "u" else f"{v:.7g}")
            i += 1
    return out


def obj_str(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> str:
    """Wavefront OBJ (1-based faces). Vertex color uses the widely read
    'v x y z r g b' extension when given."""
    lines = [f"# {_WRITER}"]
    for i, v in enumerate(np.asarray(verts, np.float64)):
        line = f"v {v[0]:.7g} {v[1]:.7g} {v[2]:.7g}"
        if colors is not None:
            c = np.clip(np.asarray(colors[i], np.float64), 0.0, 1.0)
            line += f" {c[0]:.5g} {c[1]:.5g} {c[2]:.5g}"
        lines.append(line)
    for face in np.asarray(faces):
        lines.append(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}")
    return "\n".join(lines) + "\n"


def save_obj(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> None:
    """Write :func:`obj_str` to disk."""
    with open(path, "w") as f:
        f.write(obj_str(verts, faces, colors=colors))


def save_mesh(path: str, mesh: Dict[str, np.ndarray], binary: bool = True):
    """Dispatch on extension: .ply (binary/ascii) or .obj."""
    lower = path.lower()
    if lower.endswith(".obj"):
        save_obj(path, mesh["verts"], mesh["faces"], mesh.get("colors"))
    elif lower.endswith(".ply"):
        save_ply(
            path,
            mesh["verts"],
            mesh["faces"],
            colors=mesh.get("colors"),
            normals=mesh.get("normals"),
            binary=binary,
        )
    else:
        raise ValueError(f"unknown mesh extension (want .ply/.obj): {path}")
