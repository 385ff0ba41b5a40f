"""The JAX package's flax-msgpack ``.ckpt`` files in the port
(nerfmlp_torch/train/flax_msgpack.py, train/checkpoint.py, the Trainer's
resume, the server's watcher and scripts/convert_checkpoint.py), against
the files the JAX package writes with its own
``save_checkpoint`` and read with its own ``load_params_any``, at depth 3,
width 32.

Bars: loaded parameters and restored optimizer state bit for bit (both
sides are the same float32 bytes); three deterministic steps after a
resume at the scan bars of PERF.md §2 (losses rtol 1e-3, parameters rtol
2e-4 / atol 2e-6).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nerfmlp_tpu.config import RenderConfig as JRC
from nerfmlp_tpu.config import TrainConfig as JTC
from nerfmlp_tpu.parallel import multi_scene as jms
from nerfmlp_tpu.parallel import train_step as jts
from nerfmlp_tpu.train import checkpoint as jck
from nerfmlp_tpu.utils.cli import params_template

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.models.convert import params_from_model
from nerfmlp_torch.ops.rays import pose_spherical
from nerfmlp_torch.scripts import convert_checkpoint as conv
from nerfmlp_torch.serve import RenderService
from nerfmlp_torch.train import checkpoint as ckpt
from nerfmlp_torch.train import flax_msgpack
from nerfmlp_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(depth=3, width=32, N_samples=16, N_importance=16, near=2.0,
          far=6.0, white_bkgd=True, perturb=False, raw_noise_std=0.0)
FINE = dict(separate_fine=True, depth_fine=2, width_fine=16)
ARCH = ["--netdepth", "3", "--netwidth", "32"]
FINE_ARCH = ["--netdepth_fine", "2", "--netwidth_fine", "16",
             "--separate_fine"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module (restored after), so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, n=64):
    o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[:, 2] = -1.0
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    return np.concatenate([o, d, target], axis=1)


def _jax_state(extra, clip, steps=4, seed=0):
    """A JAX train state after a few jitted steps (non-zero moments)."""
    jrc = JRC(**dict(KW, **extra))
    jtc = JTC(batch_size=64, grad_clip=clip, lr=5e-3, seed=seed)
    state = jts.create_train_state(jrc, jtc)
    step = jax.jit(jts.make_step_fn(jrc, jtc))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        state, _ = step(state, jnp.asarray(_batch(rng)))
    return jax.device_get(state), jrc, jtc


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Files the JAX package writes, by kind: (path, JAX RenderConfig)."""
    d = tmp_path_factory.mktemp("jaxckpt")
    out = {}
    state, jrc, _ = _jax_state({}, 0.0)
    out["shared"] = (str(d / "model_120.ckpt"), jrc)
    jck.save_checkpoint(out["shared"][0], state.params)
    out["bare"] = (str(d / "bare.ckpt"), jrc)
    jck.save_checkpoint(out["bare"][0], state.params["coarse"])
    out["state"] = (str(d / "metrics_latest.ckpt"), jrc)
    jck.save_checkpoint(out["state"][0], state)
    fstate, fjrc, _ = _jax_state(FINE, 0.5, seed=1)
    out["separate_fine"] = (str(d / "model_final.ckpt"), fjrc)
    jck.save_checkpoint(out["separate_fine"][0], fstate.params)
    out["state_clip"] = (str(d / "model_full_val_final.ckpt"), fjrc)
    jck.save_checkpoint(out["state_clip"][0], fstate)
    # train_multi_scene's per-scene file (scripts/train_multi_scene.py:
    # 232-241): one scene of the stacked state.
    mstate = jax.device_get(jms.create_multi_scene_state(3, jrc, JTC()))
    out["multi_scene"] = (str(d / "model_lego_final.ckpt"), jrc)
    jck.save_checkpoint(out["multi_scene"][0],
                        jax.tree.map(lambda x: x[1], mstate.params))
    return out


def _fine_cfg(jrc):
    rc = RenderConfig(**{k: getattr(jrc, k) for k in (
        "depth", "width", "depth_fine", "width_fine", "separate_fine")})
    return rc.model_config(), (rc.model_config(fine=True)
                               if rc.separate_fine else None)


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


KINDS = ["shared", "bare", "state", "separate_fine", "state_clip",
         "multi_scene"]


@pytest.mark.parametrize("kind", KINDS)
def test_load_params_any_matches_jax(files, kind):
    """Each kind of file through the port's load_params_any: the same
    nets, bit-equal to JAX's load_params_any tree (kernels in (in, out)
    after params_from_model), and the same step."""
    path, jrc = files[kind]
    cfg, fine_cfg = _fine_cfg(jrc)
    nets, step = ckpt.load_params_any(path, cfg, device="cpu",
                                      fine_cfg=fine_cfg, with_step=True)
    want, jstep = jck.load_params_any(path, params_template(jrc),
                                      jrc.model_config(), with_step=True)
    assert step == jstep and set(nets) == set(want)
    assert step == {"shared": 120, "state": 4, "state_clip": 4}.get(kind, 0)
    for k, net in nets.items():
        _assert_tree_equal(params_from_model(net),
                           jax.tree.map(np.asarray, want[k]))


@pytest.mark.parametrize("kind", KINDS)
def test_step_in_checkpoint_agrees_with_jax(files, kind):
    path = files[kind][0]
    assert ckpt.step_in_checkpoint(path) == jck.step_in_checkpoint(path)


def test_corrupt_and_mismatched_files(files, tmp_path):
    """Truncated bytes and trailing bytes raise CheckpointCorruptError; a
    width or depth that does not fit raises ValueError naming the layer;
    step_in_checkpoint reads 0 from a corrupt file, as JAX's does."""
    path, _ = files["state"]
    data = open(path, "rb").read()
    cut = str(tmp_path / "metrics_latest.ckpt")
    with open(cut, "wb") as f:
        f.write(data[: len(data) // 2])
    for fn in (lambda: ckpt.load_params_any(cut, device="cpu"),
               lambda: ckpt.load_checkpoint(cut),
               lambda: flax_msgpack.load(cut)):
        with pytest.raises(ckpt.CheckpointCorruptError, match="truncated"):
            fn()
    with pytest.raises(ckpt.CheckpointCorruptError, match="after the end"):
        flax_msgpack.decode(data + b"\x00")
    with pytest.raises(ckpt.CheckpointCorruptError):
        flax_msgpack.decode(b"\xc1")
    assert ckpt.step_in_checkpoint(cut) == jck.step_in_checkpoint(cut) == 0
    cfg = RenderConfig(depth=3, width=16).model_config()
    with pytest.raises(ValueError, match="pts_0"):
        ckpt.load_params_any(path, cfg, device="cpu")
    with pytest.raises(ValueError, match="pts_3"):
        ckpt.load_params_any(path, RenderConfig(depth=4, width=32)
                             .model_config(), device="cpu")
    with pytest.raises(ValueError, match="pts_0"):
        ckpt.load_checkpoint(path, cfg)


def test_chunked_and_bfloat16_leaves_decode(monkeypatch):
    """Leaves flax chunks (its MAX_CHUNK_SIZE lowered so that a small leaf
    chunks) and bfloat16 leaves, written by flax's msgpack_serialize, and
    the codec's own chunking, byte-equal to flax's."""
    fs = serialization
    rng = np.random.default_rng(0)
    big = rng.normal(size=(10, 7)).astype(np.float32)
    tree = {"big": big, "bf": jnp.asarray(big[:2], jnp.bfloat16),
            "small": np.arange(3, dtype=np.int32)}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    data = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.decode(data)
    np.testing.assert_array_equal(got["big"], big)
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf"].float().numpy(),
                                  np.asarray(tree["bf"], np.float32))
    np.testing.assert_array_equal(got["small"], tree["small"])
    assert flax_msgpack.encode(got) == data


def test_encoding_is_byte_equal_to_flax(files):
    """The codec's bytes for a params tree and for a whole train state are
    flax's serialization.to_bytes of the same tree, byte for byte (so key
    order is the tree's own in both); the port's .ckpt of a net is the
    JAX package's file of the same weights."""
    state, _, _ = _jax_state({}, 0.5, steps=1)
    assert flax_msgpack.encode(state.params) == serialization.to_bytes(
        state.params)
    restored = serialization.msgpack_restore(serialization.to_bytes(state))
    assert flax_msgpack.encode(restored) == serialization.to_bytes(state)
    _assert_tree_equal(flax_msgpack.decode(serialization.to_bytes(state)),
                       restored)
    path, jrc = files["shared"]
    nets = ckpt.load_params_any(path, _fine_cfg(jrc)[0], device="cpu")
    assert flax_msgpack.encode(ckpt.jax_params_tree(nets)) == \
        open(path, "rb").read()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckptscene"))
    make_synthetic_scene(root, n_train=2, n_val=1, n_test=0, img_wh=(16, 16))
    return (BlenderDataset(root, "train", img_wh=(16, 16)),
            BlenderDataset(root, "val", img_wh=(16, 16)))


# The three steps after the resume are held for the coarse-only step: with
# importance samples the fine depths move with fp32 op order (ROADMAP.md,
# Queue 3: the inverse CDF divides a CDF's ulps by a near-empty bin's mass),
# and Adam's first steps turn that into ~3e-5 on elements whose moments are
# small, in the port's own step as in any reordering of JAX's.
@pytest.mark.parametrize("extra, clip, steps", [
    (dict(N_importance=0), 0.05, 3),   # Adam behind the clip's state
    (FINE, 0.0, 0),                    # Adam at opt_state/0/0, two nets
])
def test_resume_from_a_jax_train_state(scene, tmp_path, extra, clip, steps):
    """The Trainer resumes a JAX metrics_latest.ckpt: its params, step and
    optax Adam state (mu, nu, count; found behind the clip's state when
    grad_clip > 0) bit-equal, the generator seeded from the config's seed;
    then deterministic steps on the same batches track JAX's make_step_fn
    from the same file."""
    jstate, jrc, jtc = _jax_state(extra, clip)
    path = str(tmp_path / "metrics_latest.ckpt")
    jck.save_checkpoint(path, jstate)
    rc = RenderConfig(**dict(KW, **extra))
    tc = TrainConfig(batch_size=64, grad_clip=clip, lr=5e-3, seed=9,
                     iters=10, quick_val_interval=0, full_val_interval=0,
                     log_interval=0)
    logs = []
    tr = Trainer(rc, tc, *scene, save_dir=str(tmp_path / "port"),
                 device="cpu", verbose=False)
    tr._log = logs.append
    assert tr.resume(path)
    st = tr.state
    assert st.step == int(jstate.step) == 4 and int(st.counter) == 4
    assert any("PRNG key" in line for line in logs)
    assert torch.equal(st.generator.get_state(),
                       torch.Generator().manual_seed(9).get_state())
    adam = [t for t in jax.tree.leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(t, "mu")][0]
    assert float(st.optimizer.count) == int(adam.count) == 4
    i = 0
    for k, net in st.params.items():
        _assert_tree_equal(params_from_model(net), jstate.params[k])
        for name, p in net.named_parameters():
            mod, leaf = name.rsplit(".", 1)
            jname = {"sigma_linear": "sigma", "bottleneck_linear":
                     "bottleneck", "view_linear": "view",
                     "rgb_linear": "rgb"}.get(
                         mod, mod.replace("pts_linears.", "pts_"))
            for mine, theirs in ((st.optimizer.exp_avg[i], adam.mu),
                                 (st.optimizer.exp_avg_sq[i], adam.nu)):
                want = np.asarray(theirs[k][jname][
                    "kernel" if leaf == "weight" else "bias"])
                np.testing.assert_array_equal(
                    mine.numpy(), want.T if leaf == "weight" else want)
            assert st.optimizer.params[i] is p
            i += 1
    assert i == len(st.optimizer.params)
    if not steps:
        return
    jst, params_only = jck.load_state_or_params(
        path, jts.create_train_state(jrc, jtc))
    assert not params_only
    jstep = jts.make_step_fn(jrc, jtc)
    rng = np.random.default_rng(7)
    losses = []
    for _ in range(steps):
        b = _batch(rng)
        m = tr.step_fn(st, torch.from_numpy(b))
        jst, jm = jstep(jst, jnp.asarray(b))
        losses.append((float(m["loss"]), float(jm["loss"])))
    np.testing.assert_allclose(*zip(*losses), rtol=1e-3)
    for k, net in st.params.items():
        got = params_from_model(net)
        for name, leaves in jst.params[k].items():
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(got[name][leaf],
                                           np.asarray(leaves[leaf]),
                                           rtol=2e-4, atol=2e-6)


def test_resume_from_params_and_corrupt_ckpt(files, scene, tmp_path):
    """A params-only .ckpt resumes as model_{step}.pt does (step from the
    name, fresh moments); one that does not decode warns and starts
    fresh."""
    path, _ = files["shared"]
    tc = TrainConfig(batch_size=64, iters=10, quick_val_interval=0,
                     full_val_interval=0, log_interval=0)
    logs = []
    tr = Trainer(RenderConfig(**KW), tc, *scene,
                 save_dir=str(tmp_path / "a"), device="cpu", verbose=False)
    tr._log = logs.append
    assert tr.resume(path)
    assert tr.state.step == 120 and float(tr.state.optimizer.count) == 0
    assert any("params only" in line for line in logs)
    bad = tmp_path / "metrics_latest.ckpt"
    bad.write_bytes(open(path, "rb").read()[:100])
    tr = Trainer(RenderConfig(**KW), tc, *scene,
                 save_dir=str(tmp_path / "b"), device="cpu", verbose=False)
    tr._log = logs.append
    assert not tr.resume(str(bad)) and tr.state.step == 0
    assert "failed to decode" in logs[-1]


def _jax_cli():
    sys.path.insert(0, ROOT)
    from scripts import convert_checkpoint as jconv

    return jconv


def _decoded(path):
    if path.endswith(".ckpt"):
        return serialization.msgpack_restore(open(path, "rb").read())
    if path.endswith(".npy"):
        return {str(i): a for i, a in enumerate(
            np.load(path, allow_pickle=True))}
    return {k: v.numpy() for k, v in torch.load(path).items()}


@pytest.fixture(scope="module")
def sources(files, tmp_path_factory):
    """One source file of each format, written by the JAX package."""
    d = tmp_path_factory.mktemp("convsrc")
    path, _ = files["shared"]
    src = {".ckpt": path, "fine.ckpt": files["separate_fine"][0]}
    for ext in (".npy", ".pth"):
        src[ext] = str(d / f"src{ext}")
        _jax_cli().main(["--in", path, "--out", src[ext]] + ARCH)
    return src


@pytest.mark.parametrize("src, dst, extra", [
    (s, d, []) for s in (".ckpt", ".npy", ".pth")
    for d in (".ckpt", ".npy", ".pth")
] + [("fine.ckpt", d, FINE_ARCH + net) for d in (".ckpt", ".npy", ".pth")
     for net in ([], ["--net", "fine"])])
def test_convert_checkpoint_matches_the_jax_cli(sources, tmp_path, src, dst,
                                                extra):
    """Both CLIs on the same source: outputs that decode to equal arrays
    (a .ckpt byte for byte); the port's .ckpt read by JAX's
    load_params_any."""
    argv = ["--in", sources[src]] + ARCH + extra
    mine, theirs = str(tmp_path / f"port{dst}"), str(tmp_path / f"jax{dst}")
    assert conv.main(argv + ["--out", mine]) == mine
    _jax_cli().main(argv + ["--out", theirs])
    _assert_tree_equal(_decoded(mine), _decoded(theirs))
    if dst == ".ckpt":
        assert open(mine, "rb").read() == open(theirs, "rb").read()
        jrc = JRC(**dict(KW, **(FINE if "--separate_fine" in extra else {})))
        if "fine" in extra:   # the fine net alone, as the "coarse" net
            jrc = JRC(**dict(KW, depth=2, width=16))
        got = jck.load_params_any(mine, params_template(jrc),
                                  jrc.model_config())
        assert set(got) == set(_decoded(theirs))


def test_convert_refuses_what_it_cannot_write(sources, tmp_path):
    with pytest.raises(SystemExit, match="no separate fine"):
        conv.main(["--in", sources[".npy"], "--out", str(tmp_path / "a.pth"),
                   "--net", "fine"] + ARCH)
    with pytest.raises(SystemExit, match="extension"):
        conv.main(["--in", sources[".npy"], "--out", str(tmp_path / "a.bin")]
                  + ARCH)


FRAME = dict(H=12, W=12, focal=15.0, tile=64)


def _service(path, **kw):
    rc = RenderConfig(**KW)
    params, step = ckpt.load_params_any(path, rc.model_config(),
                                        device="cpu", with_step=True)
    return RenderService(params, rc, **dict(
        FRAME, log=lambda *a: None, device="cpu", ckpt_path=path,
        ckpt_step=step, **kw))


def test_served_frame_from_ckpt_equals_pth(files, tmp_path):
    """A frame served from a JAX .ckpt equals, bit for bit, the frame served
    from the same weights as the reference .pth."""
    path, _ = files["state"]
    pth = str(tmp_path / "model.pth")
    conv.main(["--in", path, "--out", pth] + ARCH)
    pose = pose_spherical(30.0, -30.0, 4.0)
    maps = ("rgb_map", "disp_map")
    a = _service(path).render_pose(pose, maps=maps)
    b = _service(pth).render_pose(pose, maps=maps)
    for key in maps:
        np.testing.assert_array_equal(a[key], b[key])
    assert _service(path).ckpt["step"] == 4


def test_watcher_serves_a_jax_save_dir(files, tmp_path):
    """The watcher of a save dir a JAX Trainer writes into: its
    metrics_latest.ckpt first (step from inside), then each newer
    model_{step}.ckpt, ordered with the port's .pt names by step."""
    rc = RenderConfig(**KW)

    def reload_fn(p):
        return ckpt.load_params_any(p, rc.model_config(), device="cpu",
                                    with_step=True)

    state_path = str(tmp_path / "metrics_latest.ckpt")
    with open(files["state"][0], "rb") as f, open(state_path, "wb") as g:
        g.write(f.read())
    svc = _service(state_path, reload_fn=reload_fn,
                   watch_dir=str(tmp_path))
    assert svc.ckpt["step"] == 4
    pose = pose_spherical(10.0, -20.0, 4.0)
    first = svc.render_pose(pose)["rgb_map"]
    state, _, _ = _jax_state({}, 0.0, steps=6, seed=3)
    jck.save_checkpoint(str(tmp_path / "model_200.ckpt"), state.params)
    rec = svc.reload(force=False)
    assert rec["step"] == 200 and rec["path"].endswith("model_200.ckpt")
    fresh = _service(str(tmp_path / "model_200.ckpt"))
    again = fresh.render_pose(pose)["rgb_map"]
    np.testing.assert_array_equal(svc.render_pose(pose)["rgb_map"], again)
    assert not np.array_equal(first, again)
    ckpt.save_params(str(tmp_path / "model_300.pt"),
                     ckpt.load_params_any(files["shared"][0],
                                          rc.model_config(), device="cpu"))
    assert svc.reload(force=False)["step"] == 300
    assert svc.reload(force=False) is None


def test_chip_smoke_train_state_file_is_a_jax_train_state(scene, tmp_path):
    """The JAX-layout train state chip_smoke.py's phase 12 writes from the
    port's metrics_latest.pt: JAX's load_state_or_params restores it as a
    whole TrainState into its own template (optax.adam, grad_clip 0), with
    the port's params, moments, count and step; the port's Trainer resumes
    it to the same state as the .pt."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    rc = RenderConfig(**dict(KW, perturb=True))
    tc = TrainConfig(batch_size=64, iters=3, quick_val_interval=0,
                     full_val_interval=0, log_interval=0, ckpt_interval=0)
    tr = Trainer(rc, tc, *scene, save_dir=str(tmp_path / "pt"), device="cpu",
                 verbose=False)
    tr.train()
    pt = str(tmp_path / "pt" / "metrics_latest.pt")
    raw = torch.load(pt, weights_only=True)
    path = str(tmp_path / "metrics_latest.ckpt")
    ckpt.save_ckpt(path, chip_smoke.jax_train_state_tree(
        raw, {"coarse": rc.model_config()}))
    jrc = JRC(**KW)
    jst, params_only = jck.load_state_or_params(
        path, jts.create_train_state(jrc, JTC()))
    assert not params_only and int(jst.step) == 3
    adam = jst.opt_state[0][0]
    assert int(adam.count) == 3 and int(jst.opt_state[0][1].count) == 3
    want = params_from_model(tr.state.params["coarse"])
    _assert_tree_equal(jax.tree.map(np.asarray, jst.params["coarse"]), want)
    mu = jax.tree.map(np.asarray, adam.mu["coarse"])
    names = [n for n, _ in tr.state.params["coarse"].named_parameters()]
    assert np.array_equal(
        mu["pts_0"]["kernel"],
        tr.state.optimizer.exp_avg[names.index("pts_linears.0.weight")]
        .numpy().T)
    resumed = []
    for p in (pt, path):
        other = Trainer(rc, tc, *scene, save_dir=str(tmp_path / "r"),
                        device="cpu", verbose=False)
        assert other.resume(p)
        resumed.append(other.state)
    a, b = resumed
    assert a.step == b.step == 3
    for x, y in zip(a.optimizer.exp_avg + a.optimizer.exp_avg_sq
                    + a.optimizer.params, b.optimizer.exp_avg
                    + b.optimizer.exp_avg_sq + b.optimizer.params):
        assert torch.equal(x, y)
    assert torch.equal(a.optimizer.count, b.optimizer.count)
