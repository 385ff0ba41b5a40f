"""The port's train step (nerfmlp_torch/parallel/train_step.py) against the
JAX package's (nerfmlp_tpu/parallel/train_step.py), with the same weights
and the same ray batch, deterministic (perturb off, no noise).

Bars are those of tests/test_reference_parity.py:374-513, where the JAX
package is held against the torch original: coarse-only loss to 1e-6 and
per-leaf gradients at atol 5e-5; with importance sampling the fine depths
move with fp32 op-order noise, so per-leaf relative Frobenius < 5e-2 and
cosine > 0.995; ten steps' losses within rtol 5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.config import TrainConfig as JaxTrainConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.parallel import train_step as jts

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.convert import model_from_params, params_from_model
from nerfmlp_torch.parallel import train_step as ts

N_RAYS = 32
ARCH = dict(depth=6, width=64)   # depth 6: the skip before layer 5 exists


def _setup(n_importance=16, seed=5, **cfg):
    """Shared weights (JAX init), a ray batch and both packages' configs."""
    kw = dict(N_samples=32, N_importance=n_importance, near=2.0, far=6.0,
              white_bkgd=True, perturb=False, raw_noise_std=0.0, **ARCH,
              **cfg)
    jcfg = JaxRenderConfig(**{k.replace("use_kernel", "use_pallas"): v
                              for k, v in kw.items()})
    rc = RenderConfig(**kw)
    params = jax_init_model(jax.random.PRNGKey(seed), jcfg.model_config())
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (N_RAYS, 1))
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    batch = np.concatenate([o, d, target], axis=1)
    return jcfg, rc, params, batch


def _port_params(params, rc):
    return {"coarse": model_from_params(jax.tree.map(np.asarray, params),
                                        rc.model_config(), device="cpu")}


_value_and_grad = jax.value_and_grad(jts.loss_and_metrics, has_aux=True)
_jit_value_and_grad = jax.jit(_value_and_grad, static_argnums=(3, 4))


def _jax_loss_grads(params, batch, jcfg, jtc, jit=False):
    """JAX's loss and gradients. Op by op (``jit=False``) as the JAX
    package's own elementwise parity tests take them: XLA's jit of the
    whole loss reorders enough to flip a few ReLU masks and move some
    gradient elements by ~1e-3, which the per-leaf relative-Frobenius
    checks absorb and an elementwise 5e-5 bar does not."""
    fn = _jit_value_and_grad if jit else _value_and_grad
    (loss, _), grads = fn({"coarse": params}, jnp.asarray(batch),
                          jax.random.PRNGKey(0), jcfg, jtc)
    return float(loss), grads["coarse"]


def _port_loss_grads(net_params, batch, rc, tc):
    loss, _ = ts.loss_and_metrics(net_params, torch.from_numpy(batch), None,
                                  rc, tc)
    loss.backward()
    net = net_params["coarse"]
    grads = {name: p.grad for name, p in net.named_parameters()}
    from nerfmlp_torch.models.convert import params_from_state_dict

    return float(loss.detach()), params_from_state_dict(grads, net.cfg)


def check_hierarchical(extra, loss_tol, jit):
    """Loss and per-leaf gradients of the coarse + fine render against
    JAX's: relative Frobenius < 5e-2 and cosine > 0.995."""
    jcfg, rc, params, batch = _setup(**extra)
    loss_j, grads_j = _jax_loss_grads(params, batch, jcfg, JaxTrainConfig(),
                                      jit=jit)
    loss_t, grads_t = _port_loss_grads(_port_params(params, rc), batch, rc,
                                       TrainConfig())
    assert abs(loss_j - loss_t) < loss_tol
    for name in grads_j:
        for leaf in ("kernel", "bias"):
            rel, cos = _rel_and_cos(grads_t[name][leaf], grads_j[name][leaf])
            assert rel < 5e-2, f"{name}.{leaf}: relF {rel:.2e}"
            assert cos > 0.995, f"{name}.{leaf}: cosine {cos:.5f}"


def _rel_and_cos(got, want):
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    nw = np.linalg.norm(want)
    rel = np.linalg.norm(got - want) / max(nw, 1e-12)
    cos = float(got @ want) / max(np.linalg.norm(got) * nw, 1e-24)
    return rel, cos


def test_grads_match_jax_hierarchical_fp32():
    """Coarse + fine with the shared net, the module path against JAX's
    XLA path in fp32."""
    check_hierarchical({}, loss_tol=1e-5, jit=True)


def test_lr_schedule_matches_optax():
    """Update k (0-based) uses lr * rate ** (k / steps): optax's
    continuous exponential_decay at count k — no off-by-one."""
    tc = TrainConfig(lr=5e-4, lr_decay_rate=0.1, lr_decay_steps=1000)
    sched = optax.exponential_decay(init_value=tc.lr, transition_steps=1000,
                                    decay_rate=0.1)
    for k in (0, 1, 2, 537, 1000, 2500):
        assert ts.lr_at(tc, k) == pytest.approx(float(sched(k)), rel=1e-6)


def test_adam_update_equals_optax():
    """The port's Adam (optax's defaults, its learning rate a device
    tensor) computes optax.adam's update (eps outside the square root,
    bias correction), step by step."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(7, 5)).astype(np.float32)
    gs = [rng.normal(size=(7, 5)).astype(np.float32) * s
          for s in (1.0, 1e-3, 10.0)]
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = ts.Adam([p], betas=ts.ADAM_BETAS, eps=ts.ADAM_EPS)
    ox = optax.adam(1e-2)
    w, st = jnp.asarray(w0), ox.init(jnp.asarray(w0))
    for g in gs:
        opt.step([torch.from_numpy(g)], torch.tensor(1e-2))
        upd, st = ox.update(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-7)


def test_one_step_matches_the_optax_chain():
    """One full port step — pack, render, backward, clip_by_global_norm
    (which fires: the clip is below the gradient norm), the LR at count 0
    of a decaying schedule, Adam — against the JAX package's optimizer
    chain (make_optimizer) applied to the same gradients; grad_norm is the
    norm before clipping."""
    jcfg, rc, params, batch = _setup(n_importance=0)
    kw = dict(lr=5e-4, lr_decay_rate=0.1, lr_decay_steps=1000, grad_clip=0.01)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    # The step's gradients (deterministic render), before clipping.
    _, grads = _port_loss_grads(_port_params(params, rc), batch, rc, tc)
    jgrads = {"coarse": grads}
    start = {"coarse": jax.tree.map(np.asarray, params)}
    nets = _port_params(params, rc)
    state = ts.TrainState(step=0, params=nets,
                          optimizer=ts.make_optimizer(nets, tc),
                          generator=torch.Generator().manual_seed(0))
    m = ts.make_step_fn(rc, tc)(state, torch.from_numpy(batch))
    assert state.step == 1
    gnorm = float(optax.global_norm(jgrads))
    assert gnorm > 0.01                                  # clipping fired
    assert float(m["grad_norm"]) == pytest.approx(gnorm, rel=1e-6)
    opt = jts.make_optimizer(jtc)
    updates, _ = opt.update(jgrads, opt.init(start), start)
    want = optax.apply_updates(start, updates)["coarse"]
    got = params_from_model(nets["coarse"])
    for name, leaf in want.items():
        for part in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][part], np.asarray(leaf[part]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name}.{part}")


def test_clip_is_optax_rule():
    """g * min(1, c / |g|), no epsilon: at |g| = 2c every gradient halves."""
    net = torch.nn.Linear(3, 2)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    grads = [p.grad for p in net.parameters()]
    norm = ts.global_norm(grads)
    want = optax.clip_by_global_norm(float(norm) / 2).update(
        [jnp.ones(p.shape) for p in net.parameters()], None)[0]
    assert float(norm) == pytest.approx(np.sqrt(8.0))
    tc = TrainConfig(grad_clip=float(norm) / 2)
    scale = torch.where(norm < tc.grad_clip, torch.ones_like(norm),
                        tc.grad_clip / norm)
    for g, w in zip(grads, want):
        np.testing.assert_allclose((g * scale).numpy(), np.asarray(w),
                                   rtol=1e-6)


def test_ten_steps_track_jax():
    """Ten deterministic Adam steps on one batch in both packages: the
    losses track each other and fall."""
    jcfg, rc, params, batch = _setup()
    jtc = JaxTrainConfig(lr=5e-4, lr_decay_rate=1.0)
    tc = TrainConfig(lr=5e-4, lr_decay_rate=1.0)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params={"coarse": params},
        opt_state=jts.make_optimizer(jtc).init({"coarse": params}),
        rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_step_fn(jcfg, jtc))
    nets = _port_params(params, rc)
    state = ts.TrainState(step=0, params=nets,
                          optimizer=ts.make_optimizer(nets, tc),
                          generator=torch.Generator().manual_seed(0))
    step = ts.make_step_fn(rc, tc)
    bt, bj = torch.from_numpy(batch), jnp.asarray(batch)
    losses_t, losses_j = [], []
    for _ in range(10):
        jstate, jm = jstep(jstate, bj)
        losses_j.append(float(jm["loss"]))
        losses_t.append(float(step(state, bt)["loss"]))
    assert abs(losses_j[0] - losses_t[0]) / losses_j[0] < 1e-3
    np.testing.assert_allclose(losses_t, losses_j, rtol=5e-2)
    assert losses_t[-1] < 0.9 * losses_t[0]


def test_create_train_state_is_seeded():
    rc = RenderConfig(depth=2, width=16, separate_fine=True)
    a = ts.create_train_state(rc, TrainConfig(seed=3), device="cpu")
    b = ts.create_train_state(rc, TrainConfig(seed=3), device="cpu")
    assert set(a.params) == {"coarse", "fine"} and a.step == 0
    for k in a.params:
        for (n, p), (_, q) in zip(a.params[k].named_parameters(),
                                  b.params[k].named_parameters()):
            assert torch.equal(p, q), n
    assert not torch.equal(a.params["coarse"].pts_linears[0].weight,
                           a.params["fine"].pts_linears[0].weight)
    assert len(a.optimizer.params) == 2 * len(
        list(a.params["coarse"].parameters()))
