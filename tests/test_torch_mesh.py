"""The port's mesh extraction (nerfmlp_torch/ops/mesh.py, its CLI and the
Trainer's i_mesh) against the JAX package's (nerfmlp_tpu/ops/mesh.py), on
the CPU at a small size.

Same tables, same volumes and the same weights (JAX init, converted;
depth 2, width 32, fp32 'highest'; the JAX package on its plain path, as
tests/test_mesh.py runs it). Bars: tet vertices and mesh vertices within
1e-6 of JAX's (XLA fuses ``box_min + node * cell`` into an FMA, the port
rounds twice: an ulp), validity, counts and matched faces equal; the
density volume at tests/test_mesh.py's 1e-5 on its box, and on the
synthetic scene's box (span 3, where that FMA moves a node point by an
ulp and the L = 10 encoding carries it past 1e-5) the same points through
both ``_query_mlp`` at 1e-5 and the volume at 5e-5 (ROADMAP.md, Queue 3);
vertex colours at 1e-5; the writers byte for byte.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JRC
from nerfmlp_tpu.config import TrainConfig as JTC
from nerfmlp_tpu.data.blender import BlenderDataset as JDS
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops import mesh as jm
from nerfmlp_tpu.train import loop as jloop

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops import mesh as tm
from nerfmlp_torch.train.loop import Trainer

BOX = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)          # tests/test_mesh.py's
SCENE_BOX = (-1.5, -1.5, -1.2, 1.5, 1.5, 1.5)    # the synthetic scene's
KW = dict(N_samples=8, N_importance=0, near=2.0, far=6.0, perturb=False,
          depth=2, width=32)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests and fixtures (restored
    after), so that parallel test workers do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(seed=1, box=BOX, **extra):
    """Both packages' configs and the same weights (the fine net too under
    ``separate_fine``)."""
    kw = dict(KW, aabb=box, **extra)
    jcfg, cfg = JRC(**kw), RenderConfig(**kw)
    keys = ["coarse"] + (["fine"] if extra.get("separate_fine") else [])
    jp = {k: jax_init_model(jax.random.PRNGKey(seed + i),
                            jcfg.model_config(fine=k == "fine"))
          for i, k in enumerate(keys)}
    tp = {k: model_from_params(jax.tree.map(np.asarray, v),
                               cfg.model_config(fine=k == "fine"),
                               device="cpu")
          for k, v in jp.items()}
    return jp, jcfg, tp, cfg


def _grid_points(g, aabb):
    lo, hi = np.asarray(aabb[:3], float), np.asarray(aabb[3:], float)
    lin = np.arange(g) / (g - 1)
    ii, jj, kk = np.meshgrid(lin, lin, lin, indexing="ij")
    return lo + np.stack([ii, jj, kk], -1) * (hi - lo)


def _fields():
    """name -> (volume, box, threshold): the analytic fields of
    tests/test_mesh.py and a random smooth one."""
    pts17 = _grid_points(17, BOX)
    pts21 = _grid_points(21, BOX)
    two = np.maximum(
        0.3 - np.linalg.norm(pts21 - np.array([0.45, 0, 0]), axis=-1),
        0.3 - np.linalg.norm(pts21 + np.array([0.45, 0, 0]), axis=-1))
    rng = np.random.default_rng(5)
    coarse = rng.normal(size=(5, 5, 5))
    smooth = np.kron(coarse, np.ones((4, 4, 4)))[:19, :19, :19]
    for axis in range(3):         # a box blur: smooth, with many crossings
        smooth = (smooth + np.roll(smooth, 1, axis)
                  + np.roll(smooth, -1, axis)) / 3
    return {
        "sphere": (0.6 - np.linalg.norm(pts17, axis=-1), BOX, 0.0),
        "two_components": (two, BOX, 0.0),
        "linear": (_grid_points(9, BOX)[..., 0], BOX, 0.137),
        "random_smooth": (smooth, SCENE_BOX, 0.05),
        "empty": (np.zeros((8, 8, 8)), BOX, 0.5),
    }


def _match(jv, tv):
    """For each JAX vertex, the index of the nearest port vertex, and the
    distance."""
    d = np.linalg.norm(jv[:, None, :] - tv[None, :, :], axis=-1)
    idx = d.argmin(1)
    return idx, d[np.arange(len(jv)), idx]


# ---- the tables ---------------------------------------------------------- #

def test_tables_equal_jax():
    for name in ("TET_CORNERS", "TET_EDGES", "TRI_TABLE"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    np.testing.assert_array_equal(tm._corner_offsets(), jm._corner_offsets())
    # The indexing table picks what the one-hot selector picks.
    np.testing.assert_array_equal(tm._EDGE_PICK, jm._SEL.argmax(-1))


def test_tet_table_is_exactly_the_crossing_edges():
    """Every case's triangles use exactly the tet edges whose endpoints
    straddle the threshold, with the right triangle count."""
    for case in range(16):
        inside = [(case >> i) & 1 for i in range(4)]
        crossing = {e for e, (a, b) in enumerate(tm.TET_EDGES)
                    if inside[a] != inside[b]}
        tris = [t for t in tm.TRI_TABLE[case] if t[0] >= 0]
        used = {int(e) for t in tris for e in t}
        n_in = sum(inside)
        if n_in in (0, 4):
            assert not tris and not crossing
        elif n_in in (1, 3):
            assert len(tris) == 1 and used == crossing and len(crossing) == 3
        else:
            assert len(tris) == 2 and used == crossing and len(crossing) == 4
            shared = set(map(int, tris[0])) & set(map(int, tris[1]))
            assert len(shared) == 2


def test_tet_decomposition_partitions_cube():
    corners = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)], float)
    vols = [abs(np.linalg.det(corners[t][1:] - corners[t][0])) / 6.0
            for t in tm.TET_CORNERS]
    assert np.allclose(vols, 1.0 / 6.0)
    pts = np.random.default_rng(0).uniform(0.05, 0.95, size=(500, 3))
    counts = np.zeros(len(pts), int)
    for tet in tm.TET_CORNERS:
        p = corners[tet]
        lam = (np.linalg.inv((p[1:] - p[0]).T) @ (pts - p[0]).T).T
        counts += (lam > -1e-9).all(1) & (lam.sum(1) < 1 + 1e-9)
    assert (counts >= 1).all() and (counts <= 2).all()
    assert (counts == 1).mean() > 0.9


# ---- _tet_triangles ------------------------------------------------------ #

@pytest.mark.parametrize("thr", [-0.3, 0.0, 0.7])
def test_tet_triangles_match_jax(thr):
    rng = np.random.default_rng(2)
    cv = rng.normal(size=(4096, 8)).astype(np.float32)
    ci = rng.integers(0, 60, size=(4096, 3)).astype(np.int32)
    bmin = np.array(SCENE_BOX[:3], np.float32)
    cs = np.array([0.031, 0.029, 0.027], np.float32)
    jt, jv = jm._tet_triangles(jnp.asarray(cv), jnp.asarray(ci),
                               jnp.asarray(bmin), jnp.asarray(cs),
                               jnp.float32(thr))
    tt, tv = tm._tet_triangles(torch.from_numpy(cv), torch.from_numpy(ci),
                               torch.from_numpy(bmin), torch.from_numpy(cs),
                               thr)
    jt, jv = np.asarray(jt), np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.any() and not jv.all()
    np.testing.assert_allclose(tt.numpy()[jv], jt[jv], rtol=0, atol=1e-6)


# ---- mesh_from_volume ---------------------------------------------------- #

@pytest.mark.parametrize("name", ["sphere", "two_components", "linear",
                                  "random_smooth", "empty"])
def test_mesh_from_volume_matches_jax(name):
    vol, box, thr = _fields()[name]
    vol = vol.astype(np.float32)
    jv, jf = jm.mesh_from_volume(vol, box, thr)
    tv, tf = tm.mesh_from_volume(vol, box, thr)
    assert tv.shape == jv.shape and tf.shape == jf.shape
    assert tv.dtype == np.float32 and tf.dtype == np.int32
    if name == "empty":
        assert tv.shape == (0, 3) and tf.shape == (0, 3)
        return
    assert len(tf) > 0
    idx, dist = _match(jv, tv)
    assert dist.max() <= 1e-6
    assert len(np.unique(idx)) == len(tv)         # a one-to-one matching
    np.testing.assert_array_equal(idx[jf], tf)    # faces, winding included


def test_sphere_mesh_is_closed_and_outward():
    vol, box, _ = _fields()["sphere"]
    verts, faces = tm.mesh_from_volume(vol.astype(np.float32), box, 0.0)
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    assert len(verts) - len(uniq) + len(faces) == 2      # Euler: a sphere
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    assert ((fn * verts[faces].mean(1)).sum(-1) > 0).all()
    vn = tm.vertex_normals(verts, faces)
    np.testing.assert_allclose(vn, jm.vertex_normals(verts, faces),
                               atol=1e-6)


def test_cell_chunking_is_invisible():
    vol, box, _ = _fields()["sphere"]
    vol = vol.astype(np.float32)
    v1, f1 = tm.mesh_from_volume(vol, box, 0.0, chunk=7)
    v2, f2 = tm.mesh_from_volume(torch.from_numpy(vol), box, 0.0,
                                 chunk=100000)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(f1, f2)


# ---- density_volume ------------------------------------------------------ #

def test_density_volume_matches_jax():
    """JAX's bar on JAX's box (a span of 2 scales node points exactly, so
    the FMA changes nothing), with the chunks padding the tail."""
    jp, jcfg, tp, cfg = _both(seed=1)
    a = jm.density_volume(jp, jcfg, resolution=9, chunk=100)
    b = tm.density_volume(tp, cfg, resolution=9, chunk=100)
    assert b.shape == (9, 9, 9) and b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_density_volume_on_the_scene_box():
    """On the scene's box: the same node points through both packages'
    ``_query_mlp`` at 1e-5, and the volumes (whose node points differ by
    JAX's FMA) at 5e-5."""
    from nerfmlp_tpu.ops.encoding import positional_encoding as jenc
    from nerfmlp_tpu.ops.render import _query_mlp as jquery
    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.render import _query_mlp

    jp, jcfg, tp, cfg = _both(seed=2, box=SCENE_BOX)
    g = 17
    vol = tm.density_volume(tp, cfg, resolution=g, chunk=1024)
    np.testing.assert_allclose(
        vol, jm.density_volume(jp, jcfg, resolution=g, chunk=1024),
        rtol=0, atol=5e-5)
    # The port's node points, computed as density_volume computes them.
    ids = torch.arange(g ** 3, dtype=torch.int32)
    ijk = torch.stack([ids // (g * g), (ids // g) % g, ids % g], -1)
    lo = np.asarray(SCENE_BOX[:3], np.float32)
    span = np.asarray(SCENE_BOX[3:], np.float32) - lo
    pts = torch.from_numpy(lo) + (ijk.float() / (g - 1)) * torch.from_numpy(
        span)
    with torch.no_grad():
        raw = _query_mlp(tp["coarse"], pts[:, None], positional_encoding(
            torch.tensor([[0.0, 0.0, -1.0]]).expand(g ** 3, 3),
            cfg.dir_enc_L), cfg)
    # Float noise only: the CPU's matrix products block by batch size.
    np.testing.assert_allclose(vol.reshape(-1),
                               torch.relu(raw[:, 0, 3]).numpy(), rtol=0,
                               atol=1e-6)
    want = jquery(jp["coarse"], jnp.asarray(pts.numpy())[:, None],
                  jenc(jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]),
                                        (g ** 3, 3)), jcfg.dir_enc_L), jcfg)
    np.testing.assert_allclose(vol.reshape(-1),
                               np.maximum(np.asarray(want[:, 0, 3]), 0),
                               rtol=0, atol=1e-5)


def test_density_chunking_leaves_no_trace():
    """Chunks of 1 to the whole grid, padded tails included, agree to float
    noise (the CPU's matrix products block by batch size), and a chunk of
    the same size gives the same bits."""
    _, _, tp, cfg = _both(seed=3)
    whole = tm.density_volume(tp, cfg, resolution=7, chunk=1 << 20)
    for chunk in (1, 50, 64, 343):
        np.testing.assert_allclose(
            tm.density_volume(tp, cfg, resolution=7, chunk=chunk), whole,
            rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tm.density_volume(tp, cfg, resolution=7, chunk=512), whole)


def test_density_volume_takes_the_fine_net_under_separate_fine():
    jp, jcfg, tp, cfg = _both(seed=4, separate_fine=True, depth_fine=3,
                              width_fine=48)
    vol = tm.density_volume(tp, cfg, resolution=5)
    np.testing.assert_allclose(
        vol, jm.density_volume(jp, jcfg, resolution=5), rtol=0, atol=1e-5)
    coarse = tm.density_volume({"coarse": tp["coarse"]},
                               dataclasses.replace(cfg, separate_fine=False),
                               resolution=5)
    assert np.abs(vol - coarse).max() > 1e-3


def test_density_volume_limits():
    _, _, tp, cfg = _both(seed=0)
    with pytest.raises(ValueError, match="1289"):
        tm.density_volume(tp, cfg, resolution=1290)
    with pytest.raises(ValueError, match=">= 2"):
        tm.density_volume(tp, cfg, resolution=1)
    with pytest.raises(ValueError, match="bounds"):
        tm.density_volume(tp, dataclasses.replace(cfg, aabb=None),
                          resolution=4)
    with pytest.raises(ValueError, match="min < max"):
        tm.density_volume(tp, cfg, resolution=4, aabb=(0, 0, 0, -1, 1, 1))


# ---- colours and the whole extraction ------------------------------------ #

def test_vertex_colors_match_jax():
    jp, jcfg, tp, cfg = _both(seed=5)
    rng = np.random.default_rng(0)
    verts = rng.uniform(-1, 1, (37, 3)).astype(np.float32)
    normals = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    rgb = tm.vertex_colors(tp, cfg, verts, normals, chunk=16)
    assert rgb.shape == (37, 3) and rgb.dtype == np.float32
    np.testing.assert_allclose(
        rgb, jm.vertex_colors(jp, jcfg, verts, normals, chunk=16),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        rgb, tm.vertex_colors(tp, cfg, verts, normals, chunk=1000),
        rtol=0, atol=1e-6)
    assert tm.vertex_colors(tp, cfg, verts[:0], normals[:0]).shape == (0, 3)


def test_extract_mesh_matches_jax_and_gamma_changes_colors_only():
    """The slice as a whole: extract_mesh of the same weights in both
    packages, then ``gamma`` moves the colours and nothing else."""
    from nerfmlp_torch.data.blender import linear_to_srgb

    jp, jcfg, tp, cfg = _both(seed=8)
    vol = tm.density_volume(tp, cfg, resolution=8)
    thr = float(0.5 * (vol.min() + vol.max()))
    lin = tm.extract_mesh(tp, cfg, resolution=8, threshold=thr)
    ref = jm.extract_mesh(jp, jcfg, resolution=8, threshold=thr)
    assert len(lin["faces"]) > 0
    for k in ("verts", "faces", "normals", "colors"):
        assert lin[k].shape == ref[k].shape, k
    idx, dist = _match(ref["verts"], lin["verts"])
    assert dist.max() <= 1e-5
    np.testing.assert_array_equal(idx[ref["faces"]], lin["faces"])
    np.testing.assert_allclose(lin["colors"][idx], ref["colors"], rtol=0,
                               atol=1e-5)
    assert abs(lin["sigma_max"] - ref["sigma_max"]) <= 1e-5
    srgb = tm.extract_mesh(tp, cfg, resolution=8, threshold=thr, gamma=True)
    for k in ("verts", "faces", "normals"):
        np.testing.assert_array_equal(srgb[k], lin[k])
    np.testing.assert_allclose(
        srgb["colors"], linear_to_srgb(np.clip(lin["colors"], 0, 1)),
        atol=1e-6)
    assert (srgb["colors"] >= lin["colors"] - 1e-6).all()
    empty = tm.extract_mesh(tp, cfg, resolution=8, threshold=1e9)
    assert empty["verts"].shape == (0, 3) and empty["colors"].shape == (0, 3)


# ---- the writers --------------------------------------------------------- #

def _sphere_mesh():
    vol = (0.5 - np.linalg.norm(_grid_points(9, BOX), axis=-1))
    verts, faces = tm.mesh_from_volume(vol.astype(np.float32), BOX, 0.0)
    normals = tm.vertex_normals(verts, faces)
    colors = np.linspace(0, 1, verts.size).reshape(verts.shape)
    return verts, faces, normals, colors


@pytest.mark.parametrize("binary", [True, False])
def test_ply_bytes_equal_jax(binary):
    v, f, n, c = _sphere_mesh()
    for kw in (dict(colors=c, normals=n), dict(colors=c), dict(), ):
        assert (tm.ply_bytes(v, f, binary=binary, **kw)
                == jm.ply_bytes(v, f, binary=binary, **kw))


def test_obj_str_equals_jax():
    v, f, _, c = _sphere_mesh()
    assert tm.obj_str(v, f, colors=c) == jm.obj_str(v, f, colors=c)
    assert tm.obj_str(v, f) == jm.obj_str(v, f)


def _parse_ply(data):
    """(vertex rows, faces, property names) of a PLY, parsed here."""
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode("ascii").splitlines()
    fmt = next(ln.split()[1] for ln in lines if ln.startswith("format"))
    n_v = int(next(ln.split()[2] for ln in lines
                   if ln.startswith("element vertex")))
    n_f = int(next(ln.split()[2] for ln in lines
                   if ln.startswith("element face")))
    props = [ln.split() for ln in lines if ln.startswith("property ")
             and not ln.startswith("property list")]
    if fmt == "ascii":
        rows = body.decode().splitlines()
        vdat = np.array([[float(x) for x in r.split()] for r in rows[:n_v]])
        fdat = np.array([[int(x) for x in r.split()[1:]]
                         for r in rows[n_v:]])
        return vdat, fdat, [p[2] for p in props]
    dt = np.dtype([(f"p{i}", {"float": "<f4", "uchar": "u1"}[p[1]])
                   for i, p in enumerate(props)])
    vrec = np.frombuffer(body, dtype=dt, count=n_v)
    vdat = np.stack([vrec[k].astype(np.float64) for k in dt.names], -1)
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    fdat = np.frombuffer(body, dtype=fdt, count=n_f,
                         offset=n_v * dt.itemsize)["idx"]
    return vdat, fdat, [p[2] for p in props]


@pytest.mark.parametrize("ext, binary", [("ply", True), ("ply", False),
                                         ("obj", True)])
def test_mesh_survives_a_file_round_trip(tmp_path, ext, binary):
    v, f, n, c = _sphere_mesh()
    path = str(tmp_path / f"m.{ext}")
    tm.save_mesh(path, {"verts": v, "faces": f, "normals": n, "colors": c},
                 binary=binary)
    if ext == "ply":
        vdat, fdat, names = _parse_ply(open(path, "rb").read())
        assert names == ["x", "y", "z", "nx", "ny", "nz", "red", "green",
                         "blue"]
        np.testing.assert_allclose(vdat[:, :3], v, atol=1e-5)
        np.testing.assert_allclose(vdat[:, 3:6], n, atol=1e-5)
        np.testing.assert_array_equal(
            vdat[:, 6:], np.clip(c * 255 + 0.5, 0, 255).astype(int))
    else:
        rows = [ln.split() for ln in open(path) if ln.strip()]
        vdat = np.array([[float(x) for x in r[1:]] for r in rows
                         if r[0] == "v"])
        fdat = np.array([[int(x) - 1 for x in r[1:]] for r in rows
                         if r[0] == "f"])
        np.testing.assert_allclose(vdat[:, :3], v, atol=1e-5)
        np.testing.assert_allclose(vdat[:, 3:], c, atol=1e-4)
    np.testing.assert_array_equal(fdat, f)
    with pytest.raises(ValueError, match="extension"):
        tm.save_mesh(str(tmp_path / "m.stl"), {"verts": v, "faces": f})


# ---- the CLI ------------------------------------------------------------- #

def test_extract_mesh_cli_on_a_pt_checkpoint(tmp_path):
    from nerfmlp_torch.scripts import extract_mesh as cli
    from nerfmlp_torch.train.checkpoint import save_params

    _, _, tp, cfg = _both(seed=9)
    ckpt = str(tmp_path / "model_final.pt")
    save_params(ckpt, tp)
    thr = float(np.median(tm.density_volume(tp, cfg, resolution=8)))
    out = str(tmp_path / "mesh.ply")
    base = ["--ckpt", ckpt, "--aabb", *map(str, BOX), "--resolution", "8",
            "--netdepth", "2", "--netwidth", "32", "--compute_dtype",
            "float32", "--fp32_precision", "highest", "--device", "cpu"]
    mesh = cli.main(base + ["--threshold", str(thr), "--out", out])
    want = tm.extract_mesh(tp, cfg, resolution=8, threshold=thr)
    assert len(want["faces"]) > 0
    for k in ("verts", "faces", "colors"):
        np.testing.assert_array_equal(mesh[k], want[k])
    vdat, fdat, _ = _parse_ply(open(out, "rb").read())
    np.testing.assert_allclose(vdat[:, :3], want["verts"], atol=1e-6)
    np.testing.assert_array_equal(fdat, want["faces"])
    obj = str(tmp_path / "m.obj")
    cli.main(base + ["--threshold", str(thr), "--out", obj, "--no_color"])
    assert sum(ln.startswith("f ") for ln in open(obj)) == len(fdat)
    for bad in (["--resolution", "1"], ["--aabb", "0", "0", "0", "-1", "1",
                                        "1"], ["--threshold", "nan"]):
        with pytest.raises(SystemExit):
            cli.main(base + bad + ["--out", out])


# ---- the Trainer's i_mesh ------------------------------------------------ #

WH = (40, 40)
LOOP = dict(batch_size=256, iters=12, quick_val_interval=0,
            full_val_interval=0, log_interval=4, ckpt_interval=0, i_mesh=2,
            mesh_resolution=8)


def _meshes(save_dir):
    return sorted(f for f in os.listdir(save_dir) if "_mesh_" in f)


@pytest.mark.parametrize("k", [1, 4])
def test_i_mesh_steps_match_the_jax_trainer(synthetic_scene, tmp_path, k):
    """Meshes on the JAX Trainer's steps: at K = 1 every multiple of i_mesh
    before the last step; at K = 4 only where a window ends on one (4, 8),
    since neither Trainer's windows stop at i_mesh."""
    rc = dict(N_samples=8, N_importance=8, perturb=True, depth=2, width=32,
              aabb=SCENE_BOX)
    ds = BlenderDataset(synthetic_scene, "train", img_wh=WH)
    near, far = ds.dynamic_near_far()
    tr = Trainer(RenderConfig(near=near, far=far, **rc),
                 TrainConfig(**LOOP, steps_per_dispatch=k), ds,
                 save_dir=str(tmp_path / "port"), device="cpu",
                 verbose=False)
    tr.train()
    jds = JDS(synthetic_scene, "train", img_wh=WH)
    jt = jloop.Trainer(JRC(near=near, far=far, **rc),
                       JTC(**LOOP, steps_per_dispatch=k), jds,
                       save_dir=str(tmp_path / "jax"), verbose=False)
    jt.train()
    want = [2, 4, 6, 8, 10] if k == 1 else [4, 8]
    ours = [f.replace("port_", "") for f in _meshes(tmp_path / "port")]
    theirs = [f.replace("jax_", "") for f in _meshes(tmp_path / "jax")]
    assert ours == theirs == [f"mesh_{s:06d}.ply" for s in want]
    head = open(tmp_path / "port" / f"port_mesh_{want[0]:06d}.ply",
                "rb").read(64)
    assert head.startswith(b"ply\nformat binary_little_endian 1.0\n")


def test_i_mesh_meshes_the_weights_of_its_step(synthetic_scene, tmp_path,
                                               monkeypatch):
    """At K = 4 each event meshes the nets as they are at its step: a
    fresh extraction from a copy taken there gives the same mesh, and the
    weights moved between the events."""
    import copy

    ds = BlenderDataset(synthetic_scene, "train", img_wh=WH)
    near, far = ds.dynamic_near_far()
    rc = RenderConfig(near=near, far=far, N_samples=8, N_importance=8,
                      depth=2, width=32, aabb=SCENE_BOX)
    tr = Trainer(rc, TrainConfig(**LOOP, steps_per_dispatch=4), ds,
                 save_dir=str(tmp_path / "live"), device="cpu",
                 verbose=False)
    events, inner = [], tm.extract_mesh

    def spy(params, cfg, **kw):
        out = inner(params, cfg, **kw)
        events.append((copy.deepcopy(params), kw, out))
        return out

    monkeypatch.setattr(tm, "extract_mesh", spy)
    tr.train()
    assert len(events) == 2                              # steps 4 and 8
    for params, kw, out in events:
        again = inner(params, rc, **kw)
        assert again["sigma_max"] == out["sigma_max"]
        np.testing.assert_array_equal(again["verts"], out["verts"])
    assert events[0][2]["sigma_max"] != events[1][2]["sigma_max"]


def test_i_mesh_without_a_box_warns_once(synthetic_scene, tmp_path, capsys):
    ds = BlenderDataset(synthetic_scene, "train", img_wh=WH)
    near, far = ds.dynamic_near_far()
    tr = Trainer(RenderConfig(near=near, far=far, N_samples=4,
                              N_importance=0, depth=2, width=16),
                 TrainConfig(**dict(LOOP, iters=6)), ds,
                 save_dir=str(tmp_path / "nobox"), device="cpu")
    tr.train()
    assert _meshes(tmp_path / "nobox") == []
    assert capsys.readouterr().out.count("i_mesh skipped") == 1
