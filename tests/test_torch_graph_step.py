"""The graph-safe train step (parallel/train_step.py) and what it needs:
Adam and the learning rate on the device against optax, at the bars of
tests/test_torch_train_step.py (Adam rtol 1e-5 / atol 1e-7, the schedule
rel 1e-6); the device constants that replace per-call host copies, bit
for bit; the step body in a window against the eager step."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.ops import device_constant, device_scalar
from nerfmlp_torch.ops import encoding, integrate, rays, sampling
from nerfmlp_torch.parallel import train_step as ts
from nerfmlp_torch.train.graph import StepWindows


@pytest.mark.parametrize("rate, steps", [(0.1, 1000), (0.1, 250_000),
                                         (0.5, 37)])
def test_device_lr_matches_optax(rate, steps):
    """lr_tensor(counter) is optax's exponential_decay at count k, in fp32
    on the device, for counts past the decay horizon too."""
    tc = TrainConfig(lr=5e-4, lr_decay_rate=rate, lr_decay_steps=steps)
    sched = optax.exponential_decay(init_value=tc.lr, transition_steps=steps,
                                    decay_rate=rate)
    for k in (0, 1, 2, 36, 537, 1000, 2500, 199_999):
        got = ts.lr_tensor(tc, torch.tensor(k))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(float(sched(k)), rel=1e-6)
        assert float(got) == pytest.approx(ts.lr_at(tc, k), rel=1e-6)


def test_adam_tracks_optax_over_many_leaves_and_steps():
    """Several leaves, eight updates with a decaying device learning rate
    (optax.adam(schedule)); the count and moments match optax's state."""
    rng = np.random.default_rng(1)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    w0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    opt = ts.Adam(params)
    tc = TrainConfig(lr=1e-2, lr_decay_rate=0.1, lr_decay_steps=5)
    sched = optax.exponential_decay(init_value=tc.lr, transition_steps=5,
                                    decay_rate=0.1)
    ox = optax.adam(sched)
    w = [jnp.asarray(x) for x in w0]
    st = ox.init(w)
    counter = torch.zeros((), dtype=torch.int64)
    for i in range(8):
        gs = [rng.normal(size=s).astype(np.float32) * 10.0 ** (i % 3 - 1)
              for s in shapes]
        opt.step([torch.from_numpy(g) for g in gs], ts.lr_tensor(tc, counter))
        counter += 1
        upd, st = ox.update([jnp.asarray(g) for g in gs], st, w)
        w = optax.apply_updates(w, upd)
        for p, x in zip(params, w):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(x),
                                       rtol=1e-5, atol=1e-7)
    assert float(opt.count) == 8
    for m, v, mo, vo in zip(opt.exp_avg, opt.exp_avg_sq, st[0].mu, st[0].nu):
        np.testing.assert_allclose(m.numpy(), np.asarray(mo), rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(v.numpy(), np.asarray(vo), rtol=1e-5,
                                   atol=1e-8)


def test_adam_state_round_trips_torch_optim_adam():
    """The state file has torch.optim.Adam's layout: the port reads what
    torch.optim.Adam wrote (as checkpoints of earlier versions hold) and
    torch.optim.Adam reads the port's and goes on from it as the port
    does, over several parameters; loading writes in place."""
    rng = np.random.default_rng(2)
    shapes = ((4, 3), (5,), (2, 2))

    def draw():
        return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                for s in shapes]

    ps = [torch.nn.Parameter(t) for t in draw()]
    ref = torch.optim.Adam(ps, lr=1e-3, betas=ts.ADAM_BETAS, eps=ts.ADAM_EPS)
    for _ in range(3):
        for p, g in zip(ps, draw()):
            p.grad = g
        ref.step()
    ours = ts.Adam(ps)
    moments = ours.exp_avg[0]
    ours.load_state_dict(ref.state_dict())
    assert ours.exp_avg[0] is moments and float(ours.count) == 3
    for p, v in zip(ps, ours.exp_avg_sq):
        assert torch.equal(v, ref.state[p]["exp_avg_sq"])
    back = torch.optim.Adam(ps, lr=1e-3, betas=ts.ADAM_BETAS,
                            eps=ts.ADAM_EPS)
    back.load_state_dict(ours.state_dict())
    for p, m in zip(ps, ours.exp_avg):
        assert torch.equal(back.state[p]["exp_avg"], m)
        assert float(back.state[p]["step"]) == 3
    # One more update from the same state and gradients on both sides.
    grads = draw()
    for p, g in zip(ps, grads):
        p.grad = g
    start = [p.detach().clone() for p in ps]
    back.step()
    theirs = [p.detach().clone() for p in ps]
    with torch.no_grad():
        for p, s in zip(ps, start):
            p.copy_(s)
    ours.step(grads, torch.tensor(1e-3))
    for p, t in zip(ps, theirs):
        assert float(back.state[p]["step"]) == 4
        np.testing.assert_allclose(p.detach().numpy(), t.numpy(),
                                   rtol=1e-6, atol=1e-9)
    assert float(ours.count) == 4
    ours.load_state_dict(torch.optim.Adam(ps).state_dict())   # fresh
    assert float(ours.count) == 0 and not ours.exp_avg[0].any()
    with pytest.raises(ValueError, match="parameters"):
        ts.Adam(ps[:2]).load_state_dict(ref.state_dict())


@pytest.mark.parametrize("n, log_sampling", [(10, True), (4, True),
                                              (6, False), (1, True)])
def test_cached_bands_equal_numpy(n, log_sampling):
    """The bands on the device are the numpy ones, bit for bit, in each
    type, and one tensor per (L, sampling, device, type)."""
    want = encoding.frequency_bands(n, log_sampling)
    cpu = torch.device("cpu")
    got = encoding.band_tensor(n, log_sampling, torch.float32, cpu)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got is encoding.band_tensor(n, log_sampling, torch.float32, cpu)
    bf = encoding.band_tensor(n, log_sampling, torch.bfloat16, cpu)
    assert torch.equal(bf, torch.from_numpy(want.copy()).to(torch.bfloat16))
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(5, 3)).astype(np.float32))
    xb = x.numpy()[:, None, :] * want[:, None]
    ref = np.concatenate([x.numpy()] + [
        f(xb[:, i]) for i in range(n) for f in (np.sin, np.cos)], axis=-1)
    np.testing.assert_allclose(
        encoding.positional_encoding(x, n, log_sampling=log_sampling).numpy(),
        ref, rtol=1e-6, atol=1e-6)


def test_device_scalars_equal_as_tensor():
    """The fills that replace torch.as_tensor of host numbers give the
    same bits: bounds per ray, the last interval's cap, the box."""
    for v in (2.0, 0.1, 1.0 / 3.0, 6):
        want = torch.as_tensor(v, dtype=torch.float32)
        assert torch.equal(device_scalar(v, torch.float32, "cpu"), want)
        assert torch.equal(sampling._per_ray(v, 4, "cpu"),
                           want.expand(4)[:, None])
    t = torch.tensor([1.5, 2.5])
    assert torch.equal(sampling._per_ray(t, 2, "cpu"), t[:, None])
    box = (-1.5, -1.5, -1.2)
    c = device_constant(box, torch.float32, torch.device("cpu"))
    assert torch.equal(c, torch.as_tensor(box, dtype=torch.float32))
    assert c is device_constant(box, torch.float32, torch.device("cpu"))
    lin = sampling._linspace01(7, "cpu")
    assert float(lin[-1]) == 1.0 and float(lin[1]) == np.float32(1 / 6)


def test_intersect_and_cap_unchanged_by_scalars():
    """intersect_aabb and composite_rays' far cap give the same bits for a
    Python number as for its tensor."""
    rng = np.random.default_rng(4)
    o = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)) * 2
    d = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    box = ((-1.5, -1.5, -1.2), (1.5, 1.5, 1.5))
    a = rays.intersect_aabb(o, d, *box, 2.0, 6.0)
    b = rays.intersect_aabb(o, d, torch.tensor(box[0]), torch.tensor(box[1]),
                            torch.tensor(2.0), torch.tensor(6.0))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    raw = torch.from_numpy(rng.normal(size=(64, 8, 4)).astype(np.float32))
    z = torch.sort(torch.from_numpy(rng.uniform(
        2, 6, size=(64, 8)).astype(np.float32)), dim=-1)[0]
    m1 = integrate.composite_rays(raw, z, d, far_cap=6.0)
    m2 = integrate.composite_rays(raw, z, d, far_cap=torch.tensor(6.0))
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def _state_and_batch(seed=3):
    rc = RenderConfig(depth=2, width=16, N_samples=8, N_importance=8,
                      near=2.0, far=6.0, perturb=True, raw_noise_std=0.5)
    tc = TrainConfig(lr=5e-3, lr_decay_steps=10, grad_clip=0.05)
    state = ts.create_train_state(rc, tc, device="cpu")
    rng = np.random.default_rng(seed)
    n = 64
    o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    batches = np.stack([np.concatenate(
        [o, d, rng.uniform(size=(n, 3)).astype(np.float32)], axis=1)
        for _ in range(5)])
    return rc, tc, state, batches


def test_window_body_equals_eager_steps():
    """Five steps through StepWindows' host windows (2 + 3, the body run
    eagerly on the CPU) equal five eager steps: parameters, Adam, the
    counter, the generator, the loss sums and the last metrics, bit for
    bit, with the clip firing and the learning rate decaying."""
    rc, tc, eager, batches = _state_and_batch()
    step = ts.make_step_fn(rc, tc)
    losses = []
    for b in batches:
        m_eager = step(eager, torch.from_numpy(b))
        losses.append((m_eager["loss"], m_eager["psnr"]))
    _, _, windowed, _ = _state_and_batch()
    sums = torch.zeros(2)
    win = StepWindows(windowed, ts.make_step_body(rc, tc), 3, sums)
    win.run_host(batches[:2])
    m = win.run_host(batches[2:])
    assert windowed.step == eager.step == 5 == int(windowed.counter)
    for p, q in zip(windowed.optimizer.params, eager.optimizer.params):
        assert torch.equal(p, q)
    assert torch.equal(windowed.optimizer.exp_avg_sq[0],
                       eager.optimizer.exp_avg_sq[0])
    assert torch.equal(windowed.generator.get_state(),
                       eager.generator.get_state())
    assert torch.equal(m["loss"], m_eager["loss"])
    want = torch.zeros(2)
    for loss, psnr in losses:
        want += torch.stack((loss, psnr))
    assert torch.equal(sums, want)
    with pytest.raises(ValueError, match="window"):
        win.run_host(np.concatenate([batches, batches]))


def test_positive_cumprod_equals_torch_cumprod():
    """The transmittance product: torch.cumprod's values and gradients,
    bit for bit, for inputs with no zero (composite_rays' factors are at
    least 1e-10)."""
    gen = torch.Generator().manual_seed(0)
    for shape in [(64, 9), (3, 5, 7)]:
        x = (torch.rand(shape, generator=gen) + 1e-10).requires_grad_()
        g = torch.randn(shape, generator=gen)
        a = torch.cumprod(x, -1)
        (ga,) = torch.autograd.grad(a, x, g)
        b = integrate._PositiveCumprod.apply(x)
        (gb,) = torch.autograd.grad(b, x, g)
        assert torch.equal(a, b) and torch.equal(ga, gb)
