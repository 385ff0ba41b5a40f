"""``--remat`` in the port (``RenderConfig.remat``: the module path's MLP
query checkpointed, ops/render.py, and the module's runs of layers,
models/mlp.py) against the JAX package's (``jax.checkpoint`` of the query,
nerfmlp_tpu/ops/render.py:116-119), on the CPU at a small size.

On the same weights (converted with models/convert.py) and the same rays,
made from a numpy seed: the port's loss and gradients with remat equal the
port's without it bit for bit (the same operations on the same values) and
lie within JAX's remat bars (tests/test_utils_extras.py:26-46: loss 1e-6,
every gradient atol 1e-5) of JAX's render_rays with remat. The same on a
stacked module path of two scenes, through a K = 2 StepWindows run,
through a tensor-parallel step over two gloo ranks, and on the kernel path
(which ignores the flag, as JAX's Pallas path does). The train CLI takes
``--remat``; the NaN checks still name the query.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops import render as jrender
from nerfmlp_tpu.ops.sampling import sample_pdf as jax_sample_pdf

from nerfmlp_torch import check_numerics
from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.convert import (
    model_from_params, params_from_state_dict,
)
from nerfmlp_torch.models.mlp import remat_runs
from nerfmlp_torch.ops.fused_mlp import NetStack
from nerfmlp_torch.ops import render as render_mod
from nerfmlp_torch.parallel import checks
from nerfmlp_torch.parallel import train_step as ts
from nerfmlp_torch.parallel.mesh import launch
from nerfmlp_torch.train.graph import StepWindows

LOSS_TOL, GRAD_ATOL = 1e-6, 1e-5   # tests/test_utils_extras.py:43-46
N_RAYS = 6
TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(seed, n=N_RAYS):
    """(n, 3) origins near (0, 0, 4) and directions towards -z."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, 4.0], np.float32) + rng.normal(
        0.0, 0.05, (n, 3)).astype(np.float32)
    d = rng.normal(0.0, 0.1, (n, 3)).astype(np.float32)
    d[:, 2] = -1.0
    return o, d


def _nets(kw, n, seed=0):
    """``n`` JAX param trees and the port's modules holding them."""
    jkw = {k.replace("use_kernel", "use_pallas"): v for k, v in kw.items()}
    jcfg, rc = JaxRenderConfig(**jkw), RenderConfig(**kw)
    trees = [jax_init_model(jax.random.PRNGKey(seed + i), jcfg.model_config())
             for i in range(n)]
    nets = [model_from_params(jax.tree.map(np.asarray, t), rc.model_config(),
                              device="cpu") for t in trees]
    return jcfg, rc, trees, nets


def _port(params, o, d, rc, remat, near=None, far=None, z_fine=None):
    """The port's loss (mean rgb^2, the coarse map's added with a separate
    fine net) and every net's gradients. ``z_fine``: the fine pass's
    depths to use in place of the port's own draw (JAX's)."""
    nets = [m for net in params.values()
            for m in (net.nets if isinstance(net, NetStack) else [net])]
    for net in nets:
        net.zero_grad(set_to_none=True)
    with pytest.MonkeyPatch.context() as mp:
        if z_fine is not None:
            mp.setattr(render_mod, "sample_pdf",
                       lambda *a, **k: torch.from_numpy(z_fine))
        out = render_mod.render_rays(
            params, torch.from_numpy(o), torch.from_numpy(d), None,
            dataclasses.replace(rc, remat=remat), near=near, far=far)
    loss = torch.mean(out["rgb_map"] ** 2)
    if rc.separate_fine:
        loss = loss + torch.mean(out["rgb_map_coarse"] ** 2)
    loss.backward()
    return loss.detach(), [p.grad.clone() for net in nets
                           for p in net.parameters()]


def _jax(tree, o, d, jcfg):
    """JAX's loss and gradients with remat, as test_remat_matches_plain,
    and the fine pass's depths it drew (recorded from an eager render of
    the same rays). The port takes those depths: the fine pass is
    discontinuous in the coarse outputs (ROADMAP Queue 3), so depths
    drawn from fp32 weights that differ in the last bits may part."""
    cfg = dataclasses.replace(jcfg, remat=True)
    drawn = []

    def recorder(*args, **kwargs):
        out = jax_sample_pdf(*args, **kwargs)
        drawn.append(np.array(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "sample_pdf", recorder)
        jrender.render_rays({"coarse": tree}, jnp.asarray(o), jnp.asarray(d),
                            None, cfg)

    def loss(p):
        return jnp.mean(jrender.render_rays(p, jnp.asarray(o), jnp.asarray(d),
                                            None, cfg)["rgb_map"] ** 2)

    value, grads = jax.value_and_grad(loss)({"coarse": tree})
    return float(value), grads["coarse"], drawn[0]


def _within_jax_bars(loss, net, jloss, jgrads):
    assert abs(float(loss) - jloss) < LOSS_TOL
    ours = params_from_state_dict(
        {n: p.grad for n, p in net.named_parameters()}, net.cfg)
    for layer, leaves in jgrads.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(ours[layer][leaf], np.asarray(want),
                                       atol=GRAD_ATOL,
                                       err_msg=f"{layer}.{leaf}")


KW = dict(N_samples=8, N_importance=8, perturb=False)


@pytest.mark.parametrize("case", ["fp32", "fp32_depth_4", "bf16",
                                  "kernel_bf16", "fine_net"])
def test_render_rays_remat_is_exact_and_matches_jax(case):
    """One net (8x256, or 4x64) or a separate fine net: remat equals no
    remat bit for bit, fp32 within JAX's remat bars of JAX's; bf16 on the
    module path and the kernel path (its plain version on the CPU, which
    ignores the flag) bit for bit."""
    kw = dict(KW, **{"fp32_depth_4": dict(depth=4, width=64),
                     "bf16": dict(compute_dtype="bfloat16"),
                     "kernel_bf16": dict(compute_dtype="bfloat16",
                                         use_kernel=True),
                     "fine_net": dict(separate_fine=True)}.get(case, {}))
    fine = case == "fine_net"
    jcfg, rc, trees, nets = _nets(kw, 2 if fine else 1)
    params = {"coarse": nets[0]}
    if fine:
        params["fine"] = nets[1]
    o, d = _rays(1)
    loss0, grads0 = _port(params, o, d, rc, remat=False)
    loss1, grads1 = _port(params, o, d, rc, remat=True)
    assert torch.equal(loss0, loss1)
    assert len(grads0) == len(grads1) > 0
    for a, b in zip(grads0, grads1):
        assert torch.equal(a, b)
    if case in ("fp32", "fp32_depth_4"):
        jloss, jgrads, z_fine = _jax(trees[0], o, d, jcfg)
        loss, _ = _port(params, o, d, rc, True, z_fine=z_fine)
        _within_jax_bars(loss, nets[0], jloss, jgrads)


def test_stacked_module_path_remat():
    """Two scenes' nets as a NetStack on the module path, scene-major rays
    with per-ray bounds: remat equals no remat bit for bit; each scene's
    gradients lie within JAX's remat bars of JAX's render_rays with remat
    on that scene's net and rays (the loss is the scenes' mean)."""
    jcfg, rc, trees, nets = _nets(dict(KW, depth=4, width=64), 2, seed=5)
    rays = [_rays(10 + s) for s in range(2)]
    o = np.concatenate([r[0] for r in rays])
    d = np.concatenate([r[1] for r in rays])
    near = torch.full((2 * N_RAYS,), rc.near)
    far = torch.full((2 * N_RAYS,), rc.far)
    params = {"coarse": NetStack(tuple(nets))}
    loss0, grads0 = _port(params, o, d, rc, False, near, far)
    loss1, grads1 = _port(params, o, d, rc, True, near, far)
    assert torch.equal(loss0, loss1)
    for a, b in zip(grads0, grads1):
        assert torch.equal(a, b)
    jax_runs = [_jax(trees[s], *rays[s], jcfg) for s in range(2)]
    loss, _ = _port(params, o, d, rc, True, near, far, z_fine=np.concatenate(
        [z for _, _, z in jax_runs]))
    assert abs(float(loss) - np.mean([jl for jl, _, _ in jax_runs])) \
        < LOSS_TOL
    for s, (_, jgrads, _) in enumerate(jax_runs):
        # The stacked loss is the mean over both scenes' rays: each
        # scene's share of the gradient is half its own mean's.
        _within_jax_bars(0.0, nets[s], 0.0,
                         jax.tree.map(lambda g: g / 2, jgrads))


def _window_setup(remat):
    """A 8x32 net (the skip inside the second of three runs), batch 32,
    perturb and raw noise on, with its batches."""
    rc = RenderConfig(depth=8, width=32, N_samples=8, N_importance=8,
                      near=2.0, far=6.0, perturb=True, raw_noise_std=1.0,
                      remat=remat)
    tc = TrainConfig(batch_size=32, seed=3, grad_clip=0.05)
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(4):
        o, d = _rays(int(rng.integers(1 << 30)), 32)
        batches.append(np.concatenate(
            [o, d, rng.uniform(size=(32, 3)).astype(np.float32)], -1))
    return rc, tc, ts.create_train_state(rc, tc, device="cpu"), \
        np.stack(batches)


def test_step_windows_with_remat_equal_eager_steps():
    """Four steps through StepWindows' host windows at K = 2 with remat
    equal four eager steps without it, bit for bit: parameters, Adam's
    moments, the generator and the loss sums."""
    assert [list(r) for r in remat_runs(8)] == [[0, 1, 2], [3, 4, 5], [6, 7]]
    rc, tc, eager, batches = _window_setup(remat=False)
    step = ts.make_step_fn(rc, tc)
    want = torch.zeros(2)
    for b in batches:
        m = step(eager, torch.from_numpy(b))
        want += torch.stack((m["loss"], m["psnr"]))
    rc_r, tc_r, windowed, _ = _window_setup(remat=True)
    sums = torch.zeros(2)
    win = StepWindows(windowed, ts.make_step_body(rc_r, tc_r), 2, sums)
    win.run_host(batches[:2])
    win.run_host(batches[2:])
    assert windowed.step == eager.step == 4
    for p, q in zip(windowed.optimizer.params, eager.optimizer.params):
        assert torch.equal(p, q)
    for a, b in zip(windowed.optimizer.exp_avg_sq, eager.optimizer.exp_avg_sq):
        assert torch.equal(a, b)
    assert torch.equal(windowed.generator.get_state(),
                       eager.generator.get_state())
    assert torch.equal(sums, want)


def test_tensor_parallel_step_with_remat():
    """Two steps over two gloo ranks as a (1, 2) ("data", "model") mesh
    (TPNeRFMLP: a recomputed run repeats its collectives): remat equals
    no remat bit for bit, loss, gradient and parameters."""
    kw = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, depth=8,
              width=32, perturb=False, raw_noise_std=0.0)
    tc = TrainConfig(batch_size=32)
    batches = list(_window_setup(False)[3][:2])
    runs = [launch(checks.dp_steps, 2, args=(RenderConfig(remat=r, **kw), tc,
                                             batches),
                   kwargs=dict(tensor_parallel=2), device="cpu",
                   timeout_s=TIMEOUT_S) for r in (False, True)]
    plain, remat = runs
    assert plain["loss"] == remat["loss"]
    np.testing.assert_array_equal(plain["grads0"], remat["grads0"])
    for name, want in plain["params"]["coarse"].items():
        np.testing.assert_array_equal(remat["params"]["coarse"][name], want,
                                      err_msg=name)
    assert remat["ranks_bit_equal"]


def test_nan_is_named_with_remat():
    """With the NaN checks on, a NaN weight on the remat path raises
    naming the module path's output and the query, as without remat."""
    rc, tc, state, batches = _window_setup(remat=True)
    state.params["coarse"].pts_linears[0].weight.data[0, 0] = float("nan")
    check_numerics(True)
    try:
        with pytest.raises(FloatingPointError,
                           match=r"MLP's module path \(train step 1, "
                                 r"coarse call\)"):
            ts.make_step_fn(rc, tc)(state, torch.from_numpy(batches[0]))
    finally:
        check_numerics(False)


def test_train_cli_takes_remat(tmp_path, monkeypatch):
    """``train.main([... "--remat"])`` trains on the module path with
    ``RenderConfig.remat`` set."""
    from nerfmlp_torch.data.synthetic import make_synthetic_scene
    from nerfmlp_torch.scripts import train as train_cli
    from nerfmlp_torch.train import loop

    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, n_train=2, n_val=1, n_test=1, img_wh=(16, 16))
    seen = []

    class Recording(loop.Trainer):
        def __init__(self, rc, *args, **kwargs):
            seen.append(rc)
            super().__init__(rc, *args, **kwargs)

    monkeypatch.setattr(loop, "Trainer", Recording)
    m = train_cli.main([
        "--datadir", scene, "--device", "cpu", "--img_wh", "16", "16",
        "--netdepth", "2", "--netwidth", "32", "--N_samples", "8",
        "--N_importance", "8", "--batch_size", "64", "--iters", "4",
        "--compute_dtype", "float32", "--quick_val_interval", "4",
        "--quick_val_res", "16", "16", "--quick_val_subset", "1",
        "--save_dir", str(tmp_path / "out"), "--remat"])
    assert [rc.remat for rc in seen] == [True]
    assert m["step"] == 4 and np.isfinite(m["final_val"]["psnr"])
