"""Multi-scene batched training in the port (nerfmlp_torch/parallel/
multi_scene.py, the stacked step of parallel/train_step.py, the stacked
grids of ops/occupancy.py, the stacked calls of ops/fused_mlp.py and the
train_multi_scene CLI) against the JAX package's (nerfmlp_tpu/parallel/
multi_scene.py, scripts/train_multi_scene.py), on the CPU at a small size:
depth 3, width 32, 8 + 8 samples, batch 32, 3 scenes.

Bars are tests/test_torch_train_step.py's: with stratified depths only
(coarse only) the loss within 1e-5 and per-leaf gradients at atol 5e-5;
where depths are drawn from a pdf (importance samples, the grid's
one-shot or probe depths) the fine depths move with fp32 op order, so the
loss within rtol 1e-3 (its first-step bar of ten steps) and per-leaf
relative Frobenius < 5e-2 and cosine > 0.995; the one-step optax chain at
rtol 1e-6; a grid refresh at tests/test_torch_occupancy.py's
atol 2e-4. A scene of the stack is held bit for bit to a single-scene step
seeded as that scene.
"""

import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.config import TrainConfig as JaxTrainConfig
from nerfmlp_tpu.ops import occupancy as jocc
from nerfmlp_tpu.ops import render as jrender
from nerfmlp_tpu.parallel import multi_scene as jms
from nerfmlp_tpu.parallel import train_step as jts

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.convert import (
    model_from_params, params_from_model, params_from_state_dict,
)
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp as fm
from nerfmlp_torch.ops import occupancy as occ
from nerfmlp_torch.ops import render as render_mod
from nerfmlp_torch.ops.sampling import _invert_cdf
from nerfmlp_torch.ops.fused_mlp import NetStack
from nerfmlp_torch.parallel import multi_scene as ms
from nerfmlp_torch.parallel import train_step as ts

S, B = 3, 32
AABB = (-1.5, -1.5, -1.2, 1.5, 1.5, 1.5)
KW = dict(depth=3, width=32, N_samples=8, N_importance=8, near=2.0, far=6.0,
          white_bkgd=True)
OCC = dict(use_occupancy=True, aabb=AABB, occ_grid_size=12,
           occ_dense_samples=32)
BOUNDS = np.asarray([[2.0 + 0.25 * s, 6.0 - 0.25 * s] for s in range(S)],
                    np.float32)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests and fixtures (restored
    after), so that parallel test workers do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seed=0, n=B):
    """(S, n, 9) rays from (0, 0, 4) towards the box, random targets."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (S, n, 1))
    d = rng.normal(size=(S, n, 3)).astype(np.float32) * 0.3
    d[..., 2] = -1.0
    target = rng.uniform(size=(S, n, 3)).astype(np.float32)
    return np.concatenate([o, d, target], axis=-1).astype(np.float32)


def _configs(**extra):
    kw = dict(KW, **extra)
    jkw = {k.replace("use_kernel", "use_pallas"): v for k, v in kw.items()}
    return JaxRenderConfig(**jkw), RenderConfig(**kw)


def _scene(tree, s):
    return jax.tree.map(lambda x: np.asarray(x)[s], tree)


def _stack_state(jparams, rc, tc):
    """The port's stacked state holding JAX's per-scene weights."""
    nets = [model_from_params(_scene(jparams, s)["coarse"], rc.model_config(),
                              device="cpu") for s in range(S)]
    return ts.StackState(
        step=0, params={"coarse": NetStack(tuple(nets))},
        optimizer=ts.Adam([p for n in nets for p in n.parameters()]),
        generators=tuple(torch.Generator().manual_seed(s) for s in range(S)))


def _jax_grids(jstate, jcfg):
    """Stacked grids with empty and occupied cells: one refresh of each
    scene's model, half of each box emptied."""
    g = jms.create_multi_scene_grids(S, jcfg)
    upd = jax.vmap(lambda gr, p, r: jocc.update_grid(gr, p, jcfg, r,
                                                     decay=0.0))
    g = upd(g, jstate.params, jax.vmap(jax.random.PRNGKey)(jnp.arange(S)))
    dens = np.asarray(g.density).copy()
    dens[:, : dens.shape[1] // 2] = 0.0
    return jocc.OccupancyGrid(density=jnp.asarray(dens))


def _rel_and_cos(got, want):
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    nw = np.linalg.norm(want)
    rel = np.linalg.norm(got - want) / max(nw, 1e-12)
    cos = float(got @ want) / max(np.linalg.norm(got) * nw, 1e-24)
    return rel, cos


_value_and_grad = jax.value_and_grad(jts.loss_and_metrics, has_aux=True)


def _jax_render_trace(jcfg, jparams, jgrids, batch, monkeypatch):
    """JAX's eager single-scene render of each scene of the fixture, with
    the inputs and the depths of each sample_pdf call (probes, then
    refinement samples) and the grid's sampling prior recorded."""
    calls = []

    def recorder(fn, name):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[-1].append((name, args, np.asarray(out)))
            return out
        return wrapped

    with monkeypatch.context() as m:
        m.setattr(jrender, "sample_pdf", recorder(jrender.sample_pdf, "pdf"))
        m.setattr(jocc, "occupancy_weights",
                  recorder(jocc.occupancy_weights, "prior"))
        for s in range(S):
            calls.append([])
            b = jnp.asarray(batch[s])
            jrender.render_rays(
                jax.tree.map(jnp.asarray, _scene(jparams, s)), b[:, :3],
                b[:, 3:6], None, jcfg, near=jnp.asarray(BOUNDS[s, 0]),
                far=jnp.asarray(BOUNDS[s, 1]),
                occ_grid=_scene(jgrids, s))
    return calls


def _jax_cdf(weights):
    """The CDF JAX's sample_pdf builds (nerfmlp_tpu/ops/sampling.py:76-79),
    in JAX's own ops."""
    w = jnp.asarray(weights) + 1e-5
    cdf = jnp.cumsum(w / jnp.sum(w, axis=-1, keepdims=True), axis=-1)
    return np.array(jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf],
                                    axis=-1))


# Hierarchical occupancy draws its probes and its refinement samples by
# inverse CDFs; their depths depart from JAX's by up to ~3e-4 on a few rays
# (test_hierarchical_departure_is_the_cdf_sum_order), which the L = 10
# encoding turns into ~0.2 of the first layer's gradient. So that case takes
# JAX's depths for both draws, checks the port's own beside them, and holds
# the rest of the step at the bars of the other cases.
@pytest.mark.parametrize("mode", ["dense", "coarse_only",
                                  "occupancy_one_shot",
                                  "occupancy_hierarchical"])
def test_step_matches_jax_make_multi_scene_step(mode, monkeypatch):
    """The port's multi-scene step against JAX's make_multi_scene_step on a
    one-device mesh, with per-scene bounds (and per-scene grids), the same
    per-scene weights: per-scene losses, psnr and grad_norm; each scene's
    gradients against JAX's loss_and_metrics of that scene; each scene's
    updated parameters against the optax chain (JAX's make_optimizer) on
    the port's gradients, with a clip that fires for some scenes."""
    extra = {"coarse_only": dict(N_importance=0),
             "occupancy_one_shot": dict(OCC, occ_one_shot=True),
             "occupancy_hierarchical": OCC}.get(mode, {})
    jcfg, rc = _configs(perturb=False, raw_noise_std=0.0, **extra)
    jstate = jms.create_multi_scene_state(S, jcfg, JaxTrainConfig())
    start = jax.tree.map(np.asarray, jstate.params)
    batch = _batches(seed=3)
    grids, jgrids = (), None
    if rc.use_occupancy:
        jgrids = _jax_grids(jstate, jcfg)
        grids = (occ.OccupancyGrid(torch.from_numpy(
            np.asarray(jgrids.density).copy())),)
    # Each scene's loss and gradients alone, from JAX's loss_and_metrics;
    # the clip sits between the scenes' norms, so it fires for some only.
    jaxs = [_value_and_grad(
        _scene(start, s), jnp.asarray(batch[s]), jax.random.PRNGKey(0),
        jcfg, JaxTrainConfig(), None if jgrids is None else _scene(jgrids, s),
        jnp.asarray(BOUNDS[s])) for s in range(S)]
    norms = sorted(float(optax.global_norm(g)) for _, g in jaxs)
    kw = dict(lr=5e-4, lr_decay_rate=0.1, lr_decay_steps=1000,
              grad_clip=0.5 * (norms[0] + norms[1]))
    jtc, tc = JaxTrainConfig(batch_size=B, **kw), TrainConfig(batch_size=B,
                                                              **kw)
    jstate = jms.create_multi_scene_state(S, jcfg, jtc)   # the clip's state
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstep = jms.make_multi_scene_step(jcfg, jtc, mesh, with_bounds=True)
    jnew, jm = jstep(jstate, jnp.asarray(batch),
                     *(() if jgrids is None else (jgrids,)),
                     jnp.asarray(BOUNDS))

    state = _stack_state(start, rc, tc)
    if mode == "occupancy_hierarchical":
        trace = _jax_render_trace(jcfg, start, jgrids, batch, monkeypatch)
        fed = [np.concatenate([[c for c in trace[s] if c[0] == "pdf"][k][2]
                               for s in range(S)]) for k in range(2)]
        port_pdf = render_mod.sample_pdf

        def jax_depths(*args, **kwargs):
            mine, want = port_pdf(*args, **kwargs), fed.pop(0)
            assert mine.shape == want.shape
            np.testing.assert_allclose(mine.numpy(), want, atol=1e-3)
            return torch.from_numpy(want)

        monkeypatch.setattr(render_mod, "sample_pdf", jax_depths)
    step = ms.make_multi_scene_step(rc, tc, with_bounds=True)
    m = step(state, torch.from_numpy(batch), *grids, torch.from_numpy(BOUNDS))
    if mode == "occupancy_hierarchical":
        assert fed == []   # both draws took JAX's depths
    assert state.step == 1
    for key in ("loss", "psnr", "grad_norm"):
        assert m[key].shape == (S,)
    one_query = mode == "coarse_only"   # no depth drawn from a pdf
    loss_bar = dict(atol=1e-5) if one_query else dict(rtol=1e-3)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               **loss_bar)
    np.testing.assert_allclose(m["psnr"].numpy(), np.asarray(jm["psnr"]),
                               atol=1e-2)
    # grad_norm: the norm of gradients that agree per leaf at the bars below.
    # The fed depths are JAX's eager draws; its jitted step draws its own
    # (JAX's jit and eager occupancy renders differ), so that case holds
    # the norms of the eager gradients.
    want_gn = np.asarray(jm["grad_norm"])
    if mode == "occupancy_hierarchical":
        want_gn = np.asarray([float(optax.global_norm(g)) for _, g in jaxs])
    np.testing.assert_allclose(m["grad_norm"].numpy(), want_gn, rtol=5e-2)
    gn = m["grad_norm"].numpy()
    assert (gn > tc.grad_clip).any() and (gn < tc.grad_clip).any(), gn

    opt = jts.make_optimizer(jtc)
    for s in range(S):
        net = state.params["coarse"].nets[s]
        # This scene's gradients, before the clip: JAX's for the scene.
        (loss_j, _), jg = jaxs[s]
        np.testing.assert_allclose(float(m["loss"][s]), float(loss_j),
                                   **loss_bar)
        scale = min(1.0, tc.grad_clip / float(gn[s]))
        got = params_from_state_dict(
            {n: p.grad / scale for n, p in net.named_parameters()}, net.cfg)
        for name, leaves in jg["coarse"].items():
            for leaf in ("kernel", "bias"):
                a, b = np.asarray(got[name][leaf]), np.asarray(leaves[leaf])
                if one_query:
                    np.testing.assert_allclose(a, b, atol=5e-5,
                                               err_msg=f"{s} {name}.{leaf}")
                else:
                    rel, cos = _rel_and_cos(a, b)
                    assert rel < 5e-2 and cos > 0.995, (s, name, leaf, rel)
        # The one-step optax chain on the port's (unclipped) gradients.
        mine = {"coarse": got}
        updates, _ = opt.update(mine, opt.init(_scene(start, s)),
                                _scene(start, s))
        want = optax.apply_updates(_scene(start, s), updates)["coarse"]
        new = params_from_model(net)
        for name, leaf in want.items():
            for part in ("kernel", "bias"):
                np.testing.assert_allclose(new[name][part],
                                           np.asarray(leaf[part]), rtol=1e-6,
                                           atol=1e-7,
                                           err_msg=f"{s} {name}.{part}")


def test_hierarchical_departure_is_the_cdf_sum_order():
    """Where hierarchical occupancy's depths depart from JAX's on this
    fixture (single-scene renders, deterministic): the grid's sampling
    prior and the first draw's inputs are bit-equal, so the grid lookup, the
    bounds and the dense depths are JAX's. The port's CDF lies a few ulps
    from XLA's (another summation order of the normalising sum and the
    cumsum), and the port's inversion of JAX's CDF gives JAX's depths bit
    for bit, for the probes and for the refinement draw. The own depths
    depart only where u falls in a bin holding almost no mass (a cell the
    grid left empty, or the empty last bin at u = 1), where the inversion
    divides by that mass."""
    jcfg, rc = _configs(perturb=False, raw_noise_std=0.0, **OCC)
    jstate = jms.create_multi_scene_state(S, jcfg, JaxTrainConfig())
    start = jax.tree.map(np.asarray, jstate.params)
    batch = _batches(seed=3)
    jgrids = _jax_grids(jstate, jcfg)
    trace = _jax_render_trace(jcfg, start, jgrids, batch,
                              pytest.MonkeyPatch())
    departed = 0
    for s in range(S):
        grid = occ.OccupancyGrid(torch.from_numpy(
            np.asarray(jgrids.density[s]).copy()))
        b = torch.from_numpy(batch[s])
        near, far = torch.from_numpy(BOUNDS[s])
        ports = []
        with pytest.MonkeyPatch.context() as m:
            port_pdf = render_mod.sample_pdf

            def recorded(*args, **kwargs):
                out = port_pdf(*args, **kwargs)
                ports.append(args)
                return out

            m.setattr(render_mod, "sample_pdf", recorded)
            with torch.no_grad():
                render_mod.render_rays(
                    {"coarse": model_from_params(
                        _scene(start, s)["coarse"], rc.model_config(),
                        device="cpu")},
                    b[:, :3], b[:, 3:6], None, rc, near=near, far=far,
                    occ_grid=grid)
        prior = [c for c in trace[s] if c[0] == "prior"][0][2]
        draws = [c for c in trace[s] if c[0] == "pdf"]
        assert len(draws) == len(ports) == 2
        (_, (_, bins0, w0, _), _), args0 = draws[0], ports[0]
        np.testing.assert_array_equal(args0[1].numpy(), np.asarray(bins0))
        np.testing.assert_array_equal(args0[2].numpy(), np.asarray(w0))
        np.testing.assert_array_equal(
            occ.occupancy_weights(grid, b[:, :3], b[:, 3:6], args0[1], rc,
                                  rc.occ_threshold).numpy(), prior)
        for _, (_, bins, w, n), want in draws:
            bins, w = np.array(bins), np.array(w)
            cdf = _jax_cdf(w)
            wt = torch.from_numpy(w) + 1e-5
            port_cdf = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)
            assert np.abs(port_cdf.numpy() - cdf[:, 1:]).max() < 1e-6
            u = torch.from_numpy(np.array(jnp.linspace(0.0, 1.0, n)))
            u = u.expand(cdf.shape[0], n)
            np.testing.assert_array_equal(
                _invert_cdf(torch.from_numpy(bins), torch.from_numpy(cdf),
                            u).numpy(), want)
            # The port's own draw from JAX's inputs: the mass of the bin
            # each u falls in (JAX's CDF), and the departure there.
            own = render_mod.sample_pdf(None, torch.from_numpy(bins),
                                        torch.from_numpy(w), n,
                                        det=True).numpy()
            idx = np.stack([np.searchsorted(c, uu, side="right")
                            for c, uu in zip(cdf, u.numpy())])
            m_ = cdf.shape[-1]
            mass = (np.take_along_axis(cdf, np.minimum(idx, m_ - 1), -1)
                    - np.take_along_axis(cdf, np.maximum(idx - 1, 0), -1))
            gap = np.abs(own - want)
            assert gap[mass > 1e-2].max() < 1e-5
            assert (mass[gap > 1e-5] < 2e-3).all()
            departed += int((gap > 1e-5).sum())
    assert departed > 0


def _solo_state(rc, tc, s):
    return ts.create_train_state(
        rc, dataclasses.replace(tc, seed=tc.seed + ms.SCENE_SEED_STRIDE * s),
        device="cpu")


@pytest.mark.parametrize("mode", ["module", "kernel", "occupancy_kernel",
                                  "separate_fine_coarse_loss"])
def test_scene_of_the_stack_equals_its_solo_step(mode):
    """Scene s of a stack, three steps with its own draws (perturb, raw
    noise) and bounds, equals a single-scene step seeded tc.seed + 1000 s
    on the same batches, bit for bit: parameters, loss, grad_norm (JAX's
    test_scenes_are_independent, tests/test_multi_scene.py:40-66)."""
    extra = {"kernel": dict(use_kernel=True, compute_dtype="bfloat16"),
             "occupancy_kernel": dict(OCC, use_kernel=True,
                                      compute_dtype="bfloat16"),
             "separate_fine_coarse_loss": dict(separate_fine=True)}.get(
                 mode, {})
    rc = RenderConfig(**dict(KW, perturb=True, raw_noise_std=1.0, **extra))
    tc = TrainConfig(batch_size=B, seed=4, grad_clip=0.05,
                     coarse_loss=mode == "separate_fine_coarse_loss")
    state = ms.create_multi_scene_state(S, rc, tc, device="cpu")
    step = ms.make_multi_scene_step(rc, tc, with_bounds=True)
    batch = torch.from_numpy(_batches(seed=7))
    bounds = torch.from_numpy(BOUNDS)
    grids = ()
    if rc.use_occupancy:
        gens = [torch.Generator().manual_seed(50 + s) for s in range(S)]
        grids = (ms.make_multi_scene_grid_update(rc)(
            ms.create_multi_scene_grids(S, rc, device="cpu"), state.params,
            gens, 0.95),)
    metrics = [step(state, batch, *grids, bounds) for _ in range(3)]
    for s in range(S):
        solo = _solo_state(rc, tc, s)
        grid = None
        if rc.use_occupancy:
            grid = occ.update_grid(occ.create_grid(rc.occ_grid_size,
                                                   device="cpu"),
                                   solo.params, rc,
                                   torch.Generator().manual_seed(50 + s),
                                   decay=0.95)
            assert torch.equal(grid.density, grids[0].density[s])
        fn = ts.make_step_fn(rc, tc)
        for k in range(3):
            mk = fn(solo, batch[s], grid, bounds[s])
            for key in ("loss", "psnr", "grad_norm", "total_loss"):
                assert torch.equal(mk[key], metrics[k][key][s]), (s, k, key)
        mine = ms.scene_params(state, s)
        assert set(mine) == set(solo.params)
        for key in mine:
            for (n, p), q in zip(mine[key].named_parameters(),
                                 solo.params[key].parameters()):
                assert torch.equal(p, q), (s, key, n)
    assert not torch.equal(state.params["coarse"].nets[0].pts_linears[0]
                           .weight, state.params["coarse"].nets[1]
                           .pts_linears[0].weight)


def test_clip_is_per_scene():
    """One scene with a huge gradient (targets far outside [0, 1]) is
    clipped alone: the others take their unclipped step, as vmap clips
    each scene alone — a global norm over the stack would have scaled
    them too."""
    rc = RenderConfig(**dict(KW, perturb=False))
    tc = TrainConfig(batch_size=B, grad_clip=1.0, seed=2)
    batch = _batches(seed=1)
    batch[1, :, -3:] = 1e4
    state = ms.create_multi_scene_state(S, rc, tc, device="cpu")
    m = ms.make_multi_scene_step(rc, tc)(state, torch.from_numpy(batch))
    gn = m["grad_norm"].numpy()
    assert gn[1] > 1e3 * tc.grad_clip and (gn[[0, 2]] < tc.grad_clip).all()
    assert float(np.sqrt((gn ** 2).sum())) > tc.grad_clip
    for s in (0, 2):
        solo = _solo_state(rc, dataclasses.replace(tc, grad_clip=0.0), s)
        ts.make_step_fn(rc, dataclasses.replace(tc, grad_clip=0.0))(
            solo, torch.from_numpy(batch[s]))
        for p, q in zip(state.params["coarse"].nets[s].parameters(),
                        solo.params["coarse"].parameters()):
            assert torch.equal(p, q)
    # The clipped scene moved as its own clipped step moves it.
    solo = _solo_state(rc, tc, 1)
    ts.make_step_fn(rc, tc)(solo, torch.from_numpy(batch[1]))
    for p, q in zip(state.params["coarse"].nets[1].parameters(),
                    solo.params["coarse"].parameters()):
        assert torch.equal(p, q)


def _stack_inputs(n_s, vdirs, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy((rng.normal(size=(S * n_s, 3)) * 2).astype(
        np.float32))
    d = rng.normal(size=(S * n_s, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    from nerfmlp_torch.ops.encoding import positional_encoding

    dirs = positional_encoding(d, 4) if vdirs else None
    g = torch.from_numpy(rng.normal(size=(S * n_s, 4)).astype(np.float32))
    return pts, dirs, g


@pytest.mark.parametrize("vdirs, hi_lo, n_s, chunk", [
    (True, False, 200, fm.BWD_CHUNK_ROWS),
    (False, False, 200, fm.BWD_CHUNK_ROWS),
    (True, True, 150, fm.BWD_CHUNK_ROWS),
    (True, False, 300, 128),      # three chunks of every scene
])
def test_stacked_plain_functions_equal_the_per_scene_ones(vdirs, hi_lo, n_s,
                                                          chunk, monkeypatch):
    """The stacked calls on CPU tensors (the plain versions the wrappers
    take) against each scene's single-net call: the forward, the
    workspace rows of phase 1, phase 2's partial slots, the reduction and
    the whole backward through the wrappers, chunks included — bit for
    bit; and no launch is counted."""
    monkeypatch.setattr(fm, "BWD_CHUNK_ROWS", chunk)
    monkeypatch.setattr(fm, "BWD_MIN_SPLIT_ROWS", 64)
    cfg = RenderConfig(depth=6, width=32, use_viewdirs=vdirs,
                       compute_dtype="float32" if hi_lo else "bfloat16",
                       fp32_precision="high", use_kernel=True)
    nets = [init_model(cfg.model_config(), seed=20 + s, device="cpu")
            for s in range(S)]
    pts, dirs, g = _stack_inputs(n_s, vdirs)
    stack = fm.pack_params_stack(nets, cfg.pos_enc_L, vdirs, hi_lo)
    assert stack.n_scenes == S and stack.w_stride * S == stack.weights.numel()
    one = [fm.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo) for net in nets]
    assert torch.equal(stack.weights[:stack.w_stride], one[0].weights)
    assert torch.equal(stack.biases[-stack.b_stride:], one[-1].biases)
    sl = [slice(s * n_s, (s + 1) * n_s) for s in range(S)]
    # Each scene's inputs alone, copied (a slice may miss 16-byte alignment)
    sp = [pts[x].clone() for x in sl]
    sd = [None if dirs is None else dirs[x].clone() for x in sl]
    sg = [g[x].clone() for x in sl]
    counts = lambda: (fm.fused_nerf_mlp.launches, fm.bwd_workspace.launches,
                      fm.weight_grads.launches, fm.reduce_partials.launches)
    before = counts()

    with torch.no_grad():
        got = fm.fused_nerf_mlp(stack, pts, dirs, cfg)
    want = torch.cat([fm.fused_nerf_mlp_plain(net, p, d, 10, hi_lo=hi_lo)
                      for net, p, d in zip(nets, sp, sd)])
    assert torch.equal(got, want)

    tile = fm.bwd_tile_rows(hi_lo)
    rows_s = -(-n_s // tile) * tile
    ws = fm.bwd_workspace_plain(stack, pts, dirs, g, S * rows_s)
    for s, p1 in enumerate(one):
        w1 = fm.bwd_workspace_plain(p1, sp[s], sd[s], sg[s], rows_s)
        for m in range(len(p1.ws_mats)):
            assert torch.equal(
                fm.ws_matrix(stack, ws, m)[:, s * rows_s:(s + 1) * rows_s],
                fm.ws_matrix(p1, w1, m)), (s, p1.ws_mats[m][0])
    splits, split_rows = fm.bwd_splits(rows_s)
    part = fm.weight_grads_plain(stack, ws, rows_s, split_rows)
    assert part.shape == (S, splits, fm.part_stride(stack.grad_total))
    for s, p1 in enumerate(one):
        w1 = fm.bwd_workspace_plain(p1, sp[s], sd[s], sg[s], rows_s)
        assert torch.equal(part[s], fm.weight_grads_plain(p1, w1, rows_s,
                                                          split_rows))
    red = fm.reduce_partials(part, stack.grad_total)
    assert red.shape == (S, stack.grad_total)
    for s in range(S):
        assert torch.equal(red[s], fm.reduce_partials_plain(
            part[s], stack.grad_total))

    flat = fm._launch_bwd(stack, pts, dirs, g)
    grads = fm.unpack_grads(stack, flat)
    plain = fm.fused_nerf_mlp_bwd_stack_plain(nets, pts, dirs, g, 10,
                                              hi_lo=hi_lo)
    for s, p1 in enumerate(one):
        assert torch.equal(flat[s], fm._launch_bwd(p1, sp[s], sd[s], sg[s]))
        one_grads = fm.unpack_grads(p1, flat[s])
        for name, want_g in fm.fused_nerf_mlp_bwd_plain(
                nets[s], sp[s], sd[s], sg[s], 10, hi_lo=hi_lo).items():
            assert torch.equal(one_grads[name], grads[s][name])
            assert torch.equal(plain[s][name], want_g)
            scale = max(float(want_g.abs().max()), 1e-8)
            np.testing.assert_allclose(grads[s][name].numpy() / scale,
                                       want_g.numpy() / scale,
                                       atol=1e-5 if hi_lo else 1e-4,
                                       err_msg=f"{s} {name}")
    assert counts() == before


def test_fused_call_on_a_stack_differentiates_each_net():
    """fused_nerf_mlp on a NetStack under autograd: each net's gradient is
    its own scene's (the stacked plain backward), and equals a call of
    that net alone."""
    cfg = RenderConfig(depth=4, width=32, compute_dtype="bfloat16",
                       use_kernel=True)
    nets = [init_model(cfg.model_config(), seed=30 + s, device="cpu")
            for s in range(S)]
    pts, dirs, g = _stack_inputs(40, True, seed=2)
    out = fm.fused_nerf_mlp(NetStack(tuple(nets)), pts, dirs, cfg)
    (out * g).sum().backward()
    for s, net in enumerate(nets):
        x = slice(s * 40, (s + 1) * 40)
        twin = init_model(cfg.model_config(), seed=30 + s, device="cpu")
        (fm.fused_nerf_mlp(twin, pts[x], dirs[x], cfg) * g[x]).sum().backward()
        for (n, p), q in zip(net.named_parameters(), twin.parameters()):
            assert torch.equal(p.grad, q.grad), (s, n)
    with pytest.raises(ValueError, match="equal scenes"):
        fm.fused_nerf_mlp(NetStack(tuple(nets)), pts[:-1], dirs[:-1], cfg)
    other = init_model(dataclasses.replace(cfg, width=16).model_config(),
                       seed=0, device="cpu")
    with pytest.raises(ValueError, match="one architecture"):
        fm.pack_params_stack([nets[0], other], 10, True)


def test_grid_refresh_matches_jax_make_multi_scene_grid_update():
    """The stacked refresh (one query of S x G^3 points, each scene's from
    its own net) against JAX's make_multi_scene_grid_update on a
    one-device mesh, each scene's jitter JAX's draw from its key."""
    jcfg, rc = _configs(**OCC)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstate = jms.create_multi_scene_state(S, jcfg, JaxTrainConfig())
    g = jcfg.occ_grid_size
    start = np.random.default_rng(3).uniform(
        0.0, 0.5, size=(S, g, g, g)).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(S) + 11)
    upd = jms.make_multi_scene_grid_update(jcfg, mesh)
    want = np.asarray(upd(jocc.OccupancyGrid(jnp.asarray(start)),
                          jstate.params, keys, jnp.float32(0.95)).density)
    jitter = np.concatenate([np.asarray(jax.random.uniform(
        jax.random.split(keys[s])[0], (g ** 3, 3))) for s in range(S)])
    params = {"coarse": NetStack(tuple(
        model_from_params(_scene(jstate.params, s)["coarse"],
                          rc.model_config(), device="cpu")
        for s in range(S)))}
    got = occ.update_grid(occ.OccupancyGrid(torch.from_numpy(start.copy())),
                          params, rc, decay=0.95,
                          jitter=torch.from_numpy(jitter)).density
    assert got.shape == (S, g, g, g)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert (want > 0.95 * start + 1e-3).any()
    # Each scene's slice is its own single-grid refresh, bit for bit.
    for s in range(S):
        one = occ.update_grid(
            occ.OccupancyGrid(torch.from_numpy(start[s].copy())),
            {"coarse": params["coarse"].nets[s]}, rc, decay=0.95,
            jitter=torch.from_numpy(jitter[s * g ** 3:(s + 1) * g ** 3]))
        assert torch.equal(one.density, got[s])
    fresh = ms.create_multi_scene_grids(S, rc, device="cpu")
    np.testing.assert_array_equal(
        fresh.density.numpy(),
        np.asarray(jms.create_multi_scene_grids(S, jcfg).density))


def test_stacked_lookup_reads_each_scene_grid():
    """occupancy_weights over scene-major rays with a stack of grids: the
    rays of scene s read grid s (bit-equal to a lookup in that grid)."""
    rc = RenderConfig(**dict(KW, **OCC))
    rng = np.random.default_rng(5)
    dens = torch.from_numpy(rng.uniform(0, 0.02, size=(S, 12, 12, 12))
                            .astype(np.float32))
    grids = occ.OccupancyGrid(dens)
    batch = torch.from_numpy(_batches(seed=5)).reshape(S * B, 9)
    z = torch.linspace(2.0, 6.0, 16).expand(S * B, 16)
    w = occ.occupancy_weights(grids, batch[:, :3], batch[:, 3:6], z, rc)
    for s in range(S):
        x = slice(s * B, (s + 1) * B)
        assert torch.equal(w[x], occ.occupancy_weights(
            occ.OccupancyGrid(dens[s]), batch[x, :3], batch[x, 3:6], z[x],
            rc))
    assert grids.n_scenes == S and grids.resolution == 12


def test_step_with_bounds_matches_jax_step_fn():
    """The single-scene step takes per-call [near, far] bounds, as JAX's
    step_fn does (nerfmlp_tpu/parallel/train_step.py:111-117): loss and
    the updated parameters against JAX's step with the same bounds, and
    the bounds change the result."""
    jcfg, rc = _configs(perturb=False, raw_noise_std=0.0, N_importance=0)
    jtc, tc = JaxTrainConfig(batch_size=B), TrainConfig(batch_size=B)
    jstate = jts.create_train_state(jcfg, jtc)
    start = jax.tree.map(np.asarray, jstate.params)
    batch = _batches(seed=9)[0]
    bounds = np.asarray([2.5, 5.0], np.float32)
    jnew, jm = jax.jit(jts.make_step_fn(jcfg, jtc))(
        jstate, jnp.asarray(batch), None, jnp.asarray(bounds))
    nets = {"coarse": model_from_params(start["coarse"], rc.model_config(),
                                        device="cpu")}
    state = ts.TrainState(step=0, params=nets,
                          optimizer=ts.make_optimizer(nets, tc),
                          generator=torch.Generator().manual_seed(0))
    m = ts.make_step_fn(rc, tc)(state, torch.from_numpy(batch), None,
                                torch.from_numpy(bounds))
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
    (loss_b, _), jg = _value_and_grad(
        start, jnp.asarray(batch), jax.random.PRNGKey(0), jcfg, jtc, None,
        jnp.asarray(bounds))
    got = params_from_state_dict(
        {n: p.grad for n, p in nets["coarse"].named_parameters()},
        nets["coarse"].cfg)
    for name, leaves in jg["coarse"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][leaf],
                                       np.asarray(leaves[leaf]), atol=5e-5)
    plain, _ = ts.loss_and_metrics(
        {"coarse": model_from_params(start["coarse"], rc.model_config(),
                                     device="cpu")},
        torch.from_numpy(batch), None, rc, tc)
    assert abs(float(plain.detach()) - float(m["loss"])) > 1e-6   # bounds used


# --------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------- #
def _jax_cli():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from scripts import train_multi_scene as jcli

    return jcli


@pytest.mark.parametrize("names", [
    ["lego", "chair"], ["lego", "lego"], ["a_0", "a", "a"],
    ["a", "a", "a_0", "a_1", "a"], ["x_0", "x", "x", "x_1"],
])
def test_unique_scene_names_match_jax(names):
    from nerfmlp_torch.scripts.train_multi_scene import unique_scene_names

    got = unique_scene_names(names)
    assert got == _jax_cli().unique_scene_names(names)
    assert len(set(got)) == len(got)


def test_cli_blender_and_llff_match_the_jax_cli(tmp_path, capsys):
    """Blender + LLFF (NDC) through both CLIs (tests/test_multi_scene.py:
    233-272): the same per-scene bounds (2-6-ish vs 0/1), the same
    white-background warning, log lines of the same format, checkpoint
    names equal but for the suffix (.pt for .ckpt), each read by
    load_params_any and rendered."""
    from nerfmlp_torch.data.synthetic import (
        make_synthetic_llff_scene, make_synthetic_scene,
    )
    from nerfmlp_torch.scripts.train_multi_scene import main
    from nerfmlp_torch.train.checkpoint import load_params_any

    d_blender = str(tmp_path / "blender_scene")
    make_synthetic_scene(d_blender, n_train=3, n_val=1, n_test=1,
                         img_wh=(24, 24), seed=0)
    d_llff = str(tmp_path / "llff_scene")
    make_synthetic_llff_scene(d_llff, n_images=6, img_wh=(24, 24),
                              style="forward", seed=1)
    common = ["--datadirs", d_blender, d_llff,
              "--dataset_types", "blender", "llff", "--img_wh", "24", "24",
              "--batch_size", "64", "--iters", "4", "--N_samples", "4",
              "--N_importance", "4", "--log_interval", "2",
              "--compute_dtype", "float32", "--no_pallas"]
    out = str(tmp_path / "port_out")
    state, grids = main(common + ["--save_dir", out, "--device", "cpu"])
    port = capsys.readouterr().out
    jout = str(tmp_path / "jax_out")
    _jax_cli().main(common + ["--save_dir", jout])
    jax_out = capsys.readouterr().out

    bounds = r"(\w+)\s+\S+: near/far (\d+\.\d+)/(\d+\.\d+)"
    assert re.findall(bounds, port) == re.findall(bounds, jax_out)
    nf = re.findall(bounds, port)
    assert [t for t, _, _ in nf] == ["blender", "llff"]
    assert (nf[1][1], nf[1][2]) == ("0.00", "1.00") and float(nf[0][1]) > 1
    warn = [ln for ln in jax_out.splitlines() if "white_bkgd" in ln]
    assert len(warn) == 1 and warn[0] in port.splitlines()
    line = re.compile(r"^iter +(\d+) \| mean loss \d+\.\d{6} \| PSNR "
                      r"s0:\d+\.\d s1:\d+\.\d$")
    got = [int(line.match(ln).group(1)) for ln in port.splitlines()
           if ln.startswith("iter")]
    want = [int(line.match(ln).group(1)) for ln in jax_out.splitlines()
            if ln.startswith("iter")]
    assert got == want == [2, 4]
    jnames = sorted(f[:-len(".ckpt")] for f in os.listdir(jout)
                    if f.endswith(".ckpt"))
    names = sorted(f[:-len(".pt")] for f in os.listdir(out))
    assert names == jnames == ["model_blender_scene_final",
                               "model_llff_scene_final"]
    assert grids is None and state.step == 4
    from nerfmlp_torch.ops.render import render_rays

    for s, name in enumerate(("blender_scene", "llff_scene")):
        params = load_params_any(os.path.join(out, f"model_{name}_final.pt"),
                                 device="cpu")
        for p, q in zip(params["coarse"].parameters(),
                        state.params["coarse"].nets[s].parameters()):
            assert torch.equal(p, q)
        rc = RenderConfig(N_samples=4, N_importance=4, perturb=False)
        o = torch.zeros(8, 3)
        d = torch.tensor([[0.0, 0.0, -1.0]]).expand(8, 3)
        rgb = render_rays(params, o + torch.tensor([0.0, 0.0, 4.0]), d, None,
                          rc)["rgb_map"]
        assert torch.isfinite(rgb).all()


def test_cli_occupancy_refreshes_each_scene_grid(tmp_path, capsys):
    """--use_occupancy: per-scene grids refreshed on the JAX CLI's
    schedule (steps 1, 5 of 6 at --occ_update_every 4), decay 1 through
    the warmup; the kernel path's plain versions on the CPU."""
    from nerfmlp_torch.data.synthetic import make_synthetic_scene
    from nerfmlp_torch.scripts import train_multi_scene as cli

    dirs = []
    for i in range(2):
        d = str(tmp_path / f"scene{i}")
        make_synthetic_scene(d, n_train=3, n_val=1, n_test=1,
                             img_wh=(24, 24), seed=i)
        dirs.append(d)
    calls = []
    real = cli._refresh_generators

    def spy(it, n, device):
        calls.append(it)
        return real(it, n, device)

    cli._refresh_generators = spy
    try:
        state, grids = cli.main([
            "--datadirs", *dirs, "--img_wh", "24", "24", "--batch_size",
            "64", "--iters", "6", "--save_dir", str(tmp_path / "out"),
            "--N_samples", "4", "--N_importance", "4", "--log_interval",
            "3", "--use_occupancy", "--aabb", "-1.5", "-1.5", "-1.5", "1.5",
            "1.5", "1.5", "--occ_grid_size", "8", "--occ_dense_samples",
            "16", "--occ_update_every", "4", "--device", "cpu"])
    finally:
        cli._refresh_generators = real
    assert calls == [1, 5]
    assert grids.density.shape == (2, 8, 8, 8)
    assert not torch.equal(grids.density[0], grids.density[1])
    assert "8^3 grids per scene" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "out")) == [
        "model_scene0_final.pt", "model_scene1_final.pt"]
