"""Tensor parallelism in the port (nerfmlp_torch/parallel/tensor_parallel.py,
the TP train step, the Trainer and the train CLI on a ("data", "model")
mesh) on the CPU: gloo ranks spawned as in tests/test_torch_parallel.py,
each pinned to one intra-op thread; the ranks run functions of
nerfmlp_torch/parallel/checks.py, so they import neither JAX nor this
module.

Bars:
  * the placement rule: every parameter's split dimension equals JAX's
    ``_spec_for`` on the same layer, after the (out, in) <-> (in, out)
    transpose, exactly;
  * the TP step against JAX's ``make_tp_train_step`` on a (2, 2) mesh of
    the conftest's fake CPU devices, the same weights, deterministic:
    JAX's own bars (tests/test_parallel.py:248-252), the first loss rtol
    1e-5, parameters atol 5e-3; the losses of the next steps at
    tests/test_torch_parallel.py's rtol 1e-3;
  * against the port's one-process step on the same global batch: the
    first loss rtol 1e-5, the first gradient within 1e-5 of its largest
    element, parameters atol 5e-3 (Adam's first update is ~lr sign(g),
    which flips where g is ~0);
  * the Trainer and the train CLI over a TP mesh against one process:
    validation before training at JAX's data-parallel bars
    (tests/test_parallel.py:123-149: PSNR 0.05 dB, SSIM 1e-3; measured
    equal); after a few steps the nets part by Adam's sign flips
    (parameters atol 5e-3, measured 2.0e-3 after 2 steps), PSNR within
    0.05 dB (measured 0.007), while SSIM, near 0 on an untrained net's
    frame, moves by ~3e-2 and is not held.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.config import TrainConfig as JaxTrainConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.parallel import tensor_parallel as jtp
from nerfmlp_tpu.parallel import train_step as jts

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.parallel import checks
from nerfmlp_torch.parallel.mesh import Mesh, launch
from nerfmlp_torch.parallel.tensor_parallel import spec_for
from nerfmlp_torch.train import checkpoint as ckpt
from nerfmlp_torch.train.loop import Trainer

TIMEOUT_S = 60   # a collective waiting longer fails the test, not the run


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests, and so for the ranks
    they spawn (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n, seed):
    """A (n, 9) ray batch toward the origin, as tests/test_parallel.py's."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(n, 9)).astype(np.float32)
    b[:, 5] = -1.0
    b[:, 6:9] = np.abs(b[:, 6:9]) % 1.0
    return b


def _port_name(path) -> str:
    """A JAX param path (layer, kernel | bias) -> the port's name."""
    layer, kind = (k.key for k in path[-2:])
    layer = (f"pts_linears.{layer[4:]}" if layer.startswith("pts_")
             else f"{layer}_linear")
    return f"{layer}.{'weight' if kind == 'kernel' else 'bias'}"


def _jax_dim(spec):
    """A JAX PartitionSpec of a kernel (in, out) or bias -> the split
    dimension of the port's (out, in) weight or bias, or None."""
    spec = tuple(spec)
    if "model" not in spec:
        return None
    if len(spec) == 1:
        return 0
    return 0 if spec.index("model") == 1 else 1


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("width", [256, 32])
def test_spec_for_matches_jax(width, tp):
    """Every parameter of an 8-layer net with view directions: the port's
    split dimension is JAX's _spec_for's, transposed."""
    cfg = JaxRenderConfig(depth=8, width=width).model_config()
    params = jax_init_model(jax.random.PRNGKey(0), cfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert len(flat) == 2 * (8 + 4)
    seen = set()
    for path, leaf in flat:
        name = _port_name(path)
        shape = tuple(leaf.shape[::-1])           # (out, in) / (out,)
        assert spec_for(name, shape, tp) == _jax_dim(
            jtp._spec_for(path, leaf, tp)), name
        seen.add(spec_for(name, shape, tp))
    assert seen == {0, 1, None}
    if width == 256 and tp == 2:
        # The skip layer's input, 63 + 256 = 319, does not divide: whole.
        assert spec_for("pts_linears.5.weight", (256, 319), 2) is None
        assert spec_for("pts_linears.4.weight", (256, 256), 2) == 0
        assert spec_for("sigma_linear.weight", (1, 256), 2) == 1
        assert spec_for("view_linear.weight", (128, 283), 2) == 0


def test_tp_step_matches_jax_and_one_process():
    """Three steps of an 8x32 net (the skip and every head split or
    whole), batch 32, 8 + 8 samples, fp32, deterministic, over 4 gloo
    ranks as (data 2, model 2), against JAX's make_tp_train_step on a
    (2, 2) mesh of fake CPU devices and against the port's one-process
    step, all from the same weights."""
    kw = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, depth=8,
              width=32, perturb=False, raw_noise_std=0.0)
    jrc, rc = JaxRenderConfig(**kw), RenderConfig(compute_dtype="float32",
                                                   **kw)
    jtc = JaxTrainConfig(batch_size=32)
    tc = TrainConfig(batch_size=32)
    params = jax_init_model(jax.random.PRNGKey(3), jrc.model_config())
    net = model_from_params(jax.tree.map(np.asarray, params),
                            rc.model_config(), device="cpu")
    nets = {"coarse": {k: v.numpy() for k, v in net.state_dict().items()}}
    batches = [_batch(32, seed=21 + i) for i in range(3)]

    mesh = jtp.make_tp_mesh(n_devices=4, model_parallel=2)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params={"coarse": params},
        opt_state=jts.make_optimizer(jtc).init({"coarse": params}),
        rng=jax.random.PRNGKey(0))
    sharding = jtp.tp_state_sharding(state, mesh)
    state = jax.device_put(state, sharding)
    jstep, _ = jtp.make_tp_train_step(jrc, jtc, mesh,
                                      state_sharding=sharding)
    jlosses = []
    for b in batches:
        state, m = jstep(state, jax.device_put(
            jnp.asarray(b), NamedSharding(mesh, P("data"))))
        jlosses.append(float(m["loss"]))
    jparams = jax.tree.map(np.asarray, state.params["coarse"])

    one = checks.dp_steps(None, rc, tc, batches, nets=nets, device="cpu")
    tp = launch(checks.dp_steps, 4, args=(rc, tc, batches),
                kwargs=dict(nets=nets, tensor_parallel=2), device="cpu",
                timeout_s=TIMEOUT_S)
    # Each model rank holds its shards: column rows, row columns.
    shards = tp["shard_shapes"]
    assert shards["pts_linears.0.weight"] == (16, 63)
    assert shards["pts_linears.1.weight"] == (32, 16)
    assert shards["pts_linears.5.weight"] == (32, 95)     # 63 + 32: whole
    assert shards["rgb_linear.weight"] == (3, 8)
    assert tp["ranks_bit_equal"]
    assert tp["launches"] == [0, 0, 0, 0]
    # Against JAX's TP step: its bars on the first step; the later losses
    # at tests/test_torch_parallel.py's rtol 1e-3 (Adam divides by
    # sqrt(v) + eps, which amplifies sum-order noise in near-zero
    # gradients from the second step on).
    np.testing.assert_allclose(tp["loss"][0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tp["loss"], jlosses, rtol=1e-3)
    ours = model_from_params(jparams, rc.model_config(), device="cpu")
    for name, want in ours.state_dict().items():
        np.testing.assert_allclose(tp["params"]["coarse"][name], want,
                                   atol=5e-3, err_msg=name)
    # Against one process on the same global batch.
    np.testing.assert_allclose(tp["loss"][0], one["loss"][0], rtol=1e-5)
    g1 = one["grads0"]
    assert np.abs(tp["grads0"] - g1).max() <= 1e-5 * np.abs(g1).max()
    np.testing.assert_allclose(tp["grad_norm"][0], one["grad_norm"][0],
                               rtol=1e-5)
    for name, want in one["params"]["coarse"].items():
        np.testing.assert_allclose(tp["params"]["coarse"][name], want,
                                   atol=5e-3, err_msg=name)


def _tp_mesh(tp=2):
    """A ("data", "model") mesh description with no process group: enough
    for the Trainer's checks that come before any collective."""
    sub = lambda r, w: Mesh(rank=r, world_size=w,  # noqa: E731
                            device=torch.device("cpu"), backend="gloo")
    return Mesh(rank=0, world_size=tp, device=torch.device("cpu"),
                backend="gloo", data=sub(0, 1), model=sub(0, tp))


def test_tp_trainer_refuses_occupancy(synthetic_scene):
    """JAX's message (nerfmlp_tpu/train/loop.py:122-127)."""
    from nerfmlp_torch.data.blender import BlenderDataset

    ds = BlenderDataset(synthetic_scene, "train", img_wh=(16, 16))
    rc = RenderConfig(N_samples=4, N_importance=0, depth=2, width=32,
                      use_occupancy=True, aabb=(-1.5, -1.5, -1.2, 1.5, 1.5,
                                                1.5))
    with pytest.raises(ValueError, match="tensor parallelism \\+ occupancy "
                                         "sampling is not wired"):
        Trainer(rc, TrainConfig(batch_size=64), ds, verbose=False,
                mesh=_tp_mesh())


def test_tp_trainer_matches_one_process(tmp_path):
    """The Trainer on 2 gloo ranks as (data 1, model 2), kernels asked for
    (turned off, as JAX turns Pallas off), against the one-process
    Trainer: validation before and after 2 steps, the written files on
    rank 0 only, the gathered parameters."""
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, n_train=4, n_val=1, n_test=1, img_wh=(16, 16))
    rc = RenderConfig(N_samples=8, N_importance=8, near=2.0, far=6.0,
                      depth=8, width=32, compute_dtype="float32")
    tc = TrainConfig(batch_size=64, iters=2, quick_val_interval=2,
                     quick_val_subset=1, full_val_interval=0,
                     log_interval=2, ckpt_interval=0, seed=0)
    one = checks.dp_trainer(None, rc, tc, scene, (16, 16),
                            str(tmp_path / "one"), device="cpu")
    tp = launch(checks.dp_trainer, 2,
                args=(rc, tc, scene, (16, 16), str(tmp_path / "tp")),
                kwargs=dict(tensor_parallel=2), device="cpu",
                timeout_s=TIMEOUT_S)
    assert not tp["render_mesh"] and tp["ranks_bit_equal"]
    assert tp["writes"][1] == 0 and tp["writes"][0] == one["writes"][0]
    assert tp["launches"] == [[0, 0, 0, 0]] * 2
    assert abs(tp["before"]["psnr"] - one["before"]["psnr"]) <= 0.05
    assert abs(tp["before"]["ssim"] - one["before"]["ssim"]) <= 1e-3
    assert abs(tp["after"]["psnr"] - one["after"]["psnr"]) <= 0.05
    np.testing.assert_allclose(tp["params"], one["params"], atol=5e-3)
    assert tp["history"]["step"] == one["history"]["step"] == 2


def test_train_cli_tensor_parallel(tmp_path, capsys):
    """--device cpu --n_devices 2 --tensor_parallel 2 trains end to end
    (tests/test_cli.py:557-585's run) and resumes under the same layout;
    its model_final.pt serves from a one-process RenderService, and its
    weights lie at JAX's bar from a one-process run's; with occupancy it
    is refused with JAX's message."""
    from nerfmlp_torch.scripts import train as cli
    from nerfmlp_torch.serve import RenderService

    out, ref = tmp_path / "tp", tmp_path / "one"
    args = ["--datadir", str(tmp_path / "scene"), "--make_synthetic_scene",
            "--img_wh", "16", "16", "--device", "cpu", "--iters", "4",
            "--batch_size", "64", "--N_samples", "8", "--N_importance", "8",
            "--netdepth", "8", "--netwidth", "32", "--compute_dtype",
            "float32", "--quick_val_interval", "2", "--quick_val_subset", "1",
            "--quick_val_res", "16", "16", "--full_val_interval", "0",
            "--i_print", "2", "--no_device_pool"]   # TP ignores the pool
    m = cli.main(args + ["--save_dir", str(out), "--n_devices", "2",
                         "--tensor_parallel", "2"])
    assert "Mesh: dp=1 x tp=2 over 2 devices" in capsys.readouterr().out
    assert m["step"] == 4
    h = json.load(open(out / "metrics_latest.json"))
    assert h["quick_val_psnrs"] and h["quick_val_psnrs"][-1] > 5.0
    one = cli.main(args + ["--save_dir", str(ref), "--n_devices", "1"])
    assert abs(m["final_val"]["psnr"] - one["final_val"]["psnr"]) <= 0.05
    sd = ckpt.load_checkpoint(str(out / "model_final.pt"))
    want = ckpt.load_checkpoint(str(ref / "model_final.pt"))
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=5e-3,
                                   err_msg=k)
    # Auto-resume continues under the same TP layout.
    argv2 = args + ["--save_dir", str(out), "--n_devices", "2",
                    "--tensor_parallel", "2"]
    argv2[argv2.index("--iters") + 1] = "6"
    assert cli.main(argv2)["step"] == 6
    assert json.load(open(out / "metrics_latest.json"))["step"] == 6
    assert ckpt.step_in_checkpoint(str(out / "metrics_latest.pt")) == 6
    # The gathered checkpoint serves on one device.
    from nerfmlp_torch.ops.rays import pose_spherical

    cfg = RenderConfig(N_samples=8, N_importance=8, near=2.0, far=6.0,
                       depth=8, width=32)
    pose = pose_spherical(0.0, -30.0, 4.0)
    frames = []
    for path in (out / "model_final.pt", out / "model_6_latest.pt"):
        svc = RenderService(ckpt.load_params_any(
            str(path), cfg.model_config(), device="cpu"), cfg, H=8, W=8,
            focal=10.0, device="cpu", log=lambda *a: None)
        frames.append(svc.render_pose(pose)["rgb_map"])
    assert np.isfinite(frames[0]).all()
    np.testing.assert_array_equal(frames[0], frames[1])
    with pytest.raises(Exception, match="tensor parallelism \\+ occupancy"):
        cli.main(args + ["--save_dir", str(tmp_path / "occ"), "--n_devices",
                         "2", "--tensor_parallel", "2", "--use_occupancy",
                         "--aabb", "-1.5", "-1.5", "-1.2", "1.5", "1.5",
                         "1.5", "--occ_grid_size", "16"])
