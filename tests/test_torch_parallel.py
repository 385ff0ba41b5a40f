"""Data parallelism in the port (nerfmlp_torch/parallel/mesh.py, the train
step, the Trainer and the train CLI over ranks) on the CPU: 2 and 4 gloo
ranks, spawned processes meeting at a file:// rendezvous in a temporary
directory, each pinned to one intra-op thread; the ranks run functions of
nerfmlp_torch/parallel/checks.py, so they import neither JAX nor this
module.

Sharding is a layout, not a change to the math (tests/test_parallel.py:
45-64): a step over N ranks on a global batch of B rays computes what one
process computes on those B rays, up to the order of one sum (the
gradient all-reduce). Bars:
  * the first step's loss at rtol 1e-5 (JAX's); the losses of the next
    steps at rtol 1e-3 (Adam divides by sqrt(v) + eps, which amplifies
    sum-order noise in near-zero gradients from the second step on);
  * the first step's gradient at 1e-5 of its largest element (fp32 sums
    over 64 rays in another order; measured 1.1e-7);
  * parameters after 3 steps at atol 5e-3, JAX's own bar
    (tests/test_parallel.py:57-64), and bit-equal across ranks;
  * against JAX's step over its 8 fake CPU devices, the bars of
    tests/test_torch_train_step.py: the first loss within 1e-3
    (relative), the losses at rtol 5e-2;
  * validation of a Trainer over ranks against the one-process Trainer:
    JAX's bars (tests/test_parallel.py:123-149), PSNR 0.05 dB, SSIM 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.config import TrainConfig as JaxTrainConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.parallel import train_step as jts
from nerfmlp_tpu.parallel.mesh import (
    batch_sharding, make_mesh as jax_make_mesh, replicated_sharding,
)

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import RankDraws, draw
from nerfmlp_torch.parallel import checks
from nerfmlp_torch.parallel.mesh import Mesh, launch, make_mesh, shard_batch
from nerfmlp_torch.train import checkpoint as ckpt
from nerfmlp_torch.train.loop import Trainer

TIMEOUT_S = 60   # a collective waiting longer fails the test, not the run
RC = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, depth=2, width=32)


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


def _mesh(rank, world, device="cpu", backend="gloo"):
    return Mesh(rank=rank, world_size=world, device=torch.device(device),
                backend=backend)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dp_step_over_ranks_matches_one_process(n_ranks):
    rc = RenderConfig(perturb=True, compute_dtype="float32", **RC)
    tc = TrainConfig(batch_size=64, seed=0)
    batches = [_batch(64, seed=3 + i) for i in range(3)]
    one = checks.dp_steps(None, rc, tc, batches, device="cpu")
    dp = launch(checks.dp_steps, n_ranks, args=(rc, tc, batches),
                device="cpu", timeout_s=TIMEOUT_S)
    assert dp["ranks_bit_equal"]
    np.testing.assert_allclose(dp["loss"][0], one["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-3)
    g1 = one["grads0"]
    assert np.abs(dp["grads0"] - g1).max() <= 1e-5 * np.abs(g1).max()
    for name, want in one["params"]["coarse"].items():
        np.testing.assert_allclose(dp["params"]["coarse"][name], want,
                                   atol=5e-3, err_msg=name)


def test_dp_step_matches_jax_eight_device_mesh():
    """The port's step over 2 gloo ranks against JAX's make_train_step
    with mesh=make_mesh(8) on the 8 fake CPU devices (conftest), the same
    weights and 64-ray batches, deterministic (perturb off, no noise)."""
    kw = dict(RC, depth=6, width=64, perturb=False, raw_noise_std=0.0)
    jrc = JaxRenderConfig(**kw)
    rc = RenderConfig(compute_dtype="float32", **kw)
    jtc = JaxTrainConfig(batch_size=64, lr_decay_rate=1.0)
    tc = TrainConfig(batch_size=64, lr_decay_rate=1.0)
    params = jax_init_model(jax.random.PRNGKey(5), jrc.model_config())
    net = model_from_params(jax.tree.map(np.asarray, params),
                            rc.model_config(), device="cpu")
    nets = {"coarse": {k: v.numpy() for k, v in net.state_dict().items()}}
    batches = [_batch(64, seed=11 + i) for i in range(3)]

    mesh = jax_make_mesh(n_devices=8)
    state = jax.device_put(jts.TrainState(
        step=jnp.zeros((), jnp.int32), params={"coarse": params},
        opt_state=jts.make_optimizer(jtc).init({"coarse": params}),
        rng=jax.random.PRNGKey(0)), replicated_sharding(mesh))
    jstep = jts.make_train_step(jrc, jtc, mesh=mesh)
    jlosses = []
    for b in batches:
        state, m = jstep(state, jax.device_put(jnp.asarray(b),
                                               batch_sharding(mesh)))
        jlosses.append(float(m["loss"]))

    dp = launch(checks.dp_steps, 2, args=(rc, tc, batches, nets),
                device="cpu", timeout_s=TIMEOUT_S)
    assert dp["ranks_bit_equal"]
    assert abs(dp["loss"][0] - jlosses[0]) / jlosses[0] < 1e-3
    np.testing.assert_allclose(dp["loss"], jlosses, rtol=5e-2)


def test_rank_draws_are_the_global_draws_sliced():
    """Each rank keeps its rows of the draw one process makes at the
    global shape, per scene for a tuple of generators; the generators
    advance alike on every rank."""
    def gens(n=1):
        return tuple(torch.Generator().manual_seed(7 + s) for s in range(n))

    whole = draw(gens()[0], (8, 3), "cpu")
    states = []
    for r in range(2):
        g = gens()[0]
        got = draw(RankDraws(g, r, 2), (4, 3), "cpu")
        np.testing.assert_array_equal(got, whole[4 * r:4 * r + 4])
        states.append(g.get_state())
    assert torch.equal(states[0], states[1])
    for r in range(2):   # 2 scenes of 2 rows a rank, 4 a scene in all
        got = draw(RankDraws(gens(2), r, 2), (4, 3), "cpu")
        for s in range(2):
            scene = draw(gens(2)[s], (4, 3), "cpu")
            np.testing.assert_array_equal(got[2 * s:2 * s + 2],
                                          scene[2 * r:2 * r + 2])


def test_shard_batch_and_refusals():
    b = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch(b, _mesh(1, 3)), b[2:4])
    np.testing.assert_array_equal(shard_batch(b, None), b)
    np.testing.assert_array_equal(
        shard_batch(np.arange(12).reshape(1, 6, 2), _mesh(0, 2), axis=1),
        b[None, :3])
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        shard_batch(b, _mesh(0, 4))
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")
    with pytest.raises(ValueError, match="0 ranks"):
        launch(checks.dp_steps, 0, device="cpu")


def test_trainer_refuses_what_cannot_run(tmp_path):
    """B % N != 0, and K > 1 under gloo on cuda (its collectives go
    through the host: a CUDA graph cannot capture them), refused by name
    before any work."""
    d = str(tmp_path / "scene")
    make_synthetic_scene(d, n_train=2, n_val=1, n_test=0, img_wh=(8, 8))
    from nerfmlp_torch.data.blender import BlenderDataset

    ds = BlenderDataset(d, "train", img_wh=(8, 8))
    rc = RenderConfig(**RC)
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        Trainer(rc, TrainConfig(batch_size=64), ds, mesh=_mesh(0, 3),
                save_dir=str(tmp_path / "o"), verbose=False)
    with pytest.raises(ValueError, match="cannot be captured"):
        Trainer(rc, TrainConfig(batch_size=64, steps_per_dispatch=4), ds,
                mesh=_mesh(0, 2, device="cuda:0"),
                save_dir=str(tmp_path / "o"), verbose=False)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dpscene"))
    make_synthetic_scene(d, n_train=4, n_val=2, n_test=2, img_wh=(16, 16))
    return d


@pytest.mark.parametrize("k", [1, 2])
def test_trainer_over_two_ranks(scene, tmp_path, k):
    """The Trainer on 2 ranks (pool batches; at K = 2 in eager windows):
    validation of the same (seed-equal) nets equals the one-process
    Trainer's before training and after 4 steps at JAX's bars; rank 0
    alone writes, and the two runs write the same files; the ranks'
    parameters stay bit-equal; the frames of the i_img / i_testset /
    i_video events are rendered over the ranks."""
    from nerfmlp_torch.ops.rays import blender_render_poses

    rc = RenderConfig(perturb=True, **RC)
    tc = TrainConfig(batch_size=64, iters=4, seed=0, quick_val_interval=2,
                     quick_val_subset=1, full_val_interval=0,
                     log_interval=2, ckpt_interval=2, i_img=2, i_testset=2,
                     i_video=2, steps_per_dispatch=k)
    poses = blender_render_poses(n_frames=2, radius=4.0)
    # One basename: the videos are named after the run's directory.
    dirs = [tmp_path / w / "run" for w in ("one", "two")]
    one = checks.dp_trainer(None, rc, tc, scene, (16, 16), str(dirs[0]),
                            device="cpu", test_split=True,
                            render_poses=poses)
    dp = launch(checks.dp_trainer, 2,
                args=(rc, tc, scene, (16, 16), str(dirs[1])),
                kwargs=dict(test_split=True, render_poses=poses),
                device="cpu", timeout_s=TIMEOUT_S)
    assert dp["render_mesh"] and not one["render_mesh"]
    assert dp["ranks_bit_equal"]
    assert dp["writes"][0] > 0 and dp["writes"][1:] == [0]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    for when in ("before", "after"):
        assert abs(dp[when]["psnr"] - one[when]["psnr"]) < 0.05, when
        assert abs(dp[when]["ssim"] - one[when]["ssim"]) < 1e-3, when
    assert dp["history"]["step"] == 4
    assert len(dp["history"]["testset_psnrs"]) == 1
    np.testing.assert_allclose(dp["history"]["train_losses"],
                               one["history"]["train_losses"], rtol=1e-3)


def test_train_cli_over_two_ranks(tmp_path):
    """--device cpu --n_devices 2 runs two gloo ranks and writes the run's
    files; --tensor_parallel 2 stays refused, naming its ROADMAP item."""
    from nerfmlp_torch.scripts import train as cli

    out = tmp_path / "out"
    args = ["--datadir", str(tmp_path / "scene"), "--make_synthetic_scene",
            "--img_wh", "16", "16", "--device", "cpu", "--iters", "4",
            "--batch_size", "64", "--N_samples", "8", "--N_importance", "8",
            "--netdepth", "2", "--netwidth", "32", "--quick_val_interval",
            "2", "--quick_val_subset", "1", "--quick_val_res", "16", "16",
            "--i_print", "2", "--save_dir", str(out)]
    m = cli.main(args + ["--n_devices", "2"])
    assert m["step"] == 4 and np.isfinite(m["final_val"]["psnr"])
    for name in ("model_final.pt", "metrics_latest.pt", "args.txt",
                 "comprehensive_metrics.json"):
        assert os.path.exists(out / name), name
    assert ckpt.step_in_checkpoint(str(out / "metrics_latest.pt")) == 4
    # --tensor_parallel 2 (refused until tensor parallelism was ported)
    # on one rank fails JAX's divisibility check.
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        cli.main(args + ["--tensor_parallel", "2"])


def test_shard_render_on_one_device(tmp_path, capsys):
    """--shard_render (refused until this port rendered over several
    devices) with one visible device: the local renderer, with a note,
    the same frame as without the flag."""
    from nerfmlp_torch.scripts import eval as eval_cli
    from nerfmlp_torch.scripts import render_example, render_video

    d = str(tmp_path / "scene")
    make_synthetic_scene(d, n_train=2, n_val=1, n_test=1, img_wh=(8, 8))
    rc = RenderConfig(**RC)
    path = str(tmp_path / "m.pt")
    ckpt.save_params(path, {"coarse": init_model(rc.model_config(), seed=0,
                                                 device="cpu")})
    base = ["--datadir", d, "--ckpt", path, "--device", "cpu",
            "--N_samples", "8", "--N_importance", "8", "--netdepth", "2",
            "--netwidth", "32"]
    outs = {}
    for flag in ([], ["--shard_render"]):
        capsys.readouterr()
        outs[bool(flag)] = render_video.main(
            base + ["--size", "8", "--n_frames", "2", "--out_dir",
                    str(tmp_path / f"v{len(flag)}")] + flag)["rgbs"]
        noted = "one visible device" in capsys.readouterr().out
        assert noted == bool(flag)
    np.testing.assert_array_equal(outs[True], outs[False])
    for cli in (render_example, eval_cli):
        capsys.readouterr()
        argv = base + ["--img_wh", "8", "8", "--shard_render"]
        argv += (["--out_dir", str(tmp_path / "ex"), "--split", "val"]
                 if cli is render_example else
                 ["--split", "val", "--out", str(tmp_path / "e.json")])
        cli.main(argv)
        assert "one visible device" in capsys.readouterr().out
