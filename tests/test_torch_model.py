"""The port's encoding, model and weight conversion against the JAX package
(nerfmlp_torch/ops/encoding.py, models/mlp.py, models/convert.py,
train/checkpoint.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import ModelConfig as JaxModelConfig
from nerfmlp_tpu.models.import_tf import (
    expected_shapes as jax_expected_shapes,
    params_to_numpy as jax_params_to_numpy,
)
from nerfmlp_tpu.models.import_torch import params_to_torch_state_dict
from nerfmlp_tpu.models.mlp import apply_model, init_model as jax_init_model
from nerfmlp_tpu.ops.encoding import positional_encoding as jax_encoding

from nerfmlp_torch.config import ModelConfig
from nerfmlp_torch.models import convert
from nerfmlp_torch.models.mlp import NeRFMLP, init_model
from nerfmlp_torch.ops.encoding import positional_encoding
from nerfmlp_torch.train.checkpoint import load_params_any

SMALL = dict(depth=6, width=64, bottleneck_ch=64, view_width=32)


def _jax_params(use_viewdirs=True, seed=0):
    mc = JaxModelConfig(use_viewdirs=use_viewdirs, **SMALL)
    return jax.tree.map(np.asarray,
                        jax_init_model(jax.random.PRNGKey(seed), mc))


@pytest.mark.parametrize("log_sampling", [True, False])
@pytest.mark.parametrize("L", [4, 10])
def test_encoding_matches_jax(L, log_sampling):
    x = np.random.default_rng(L).normal(size=(50, 3)).astype(np.float32) * 3
    want = np.asarray(jax_encoding(jnp.asarray(x), L,
                                   log_sampling=log_sampling))
    got = positional_encoding(torch.from_numpy(x), L,
                              log_sampling=log_sampling).numpy()
    assert got.shape == want.shape == (50, 3 + 6 * L)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_model_fp32_matches_jax(use_viewdirs):
    """NeRFMLP fp32 vs apply_model fp32 'highest' on the same weights."""
    params = _jax_params(use_viewdirs)
    mc = ModelConfig(use_viewdirs=use_viewdirs, **SMALL)
    net = convert.model_from_params(params, mc, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(128, 63)).astype(np.float32)
    v = rng.normal(size=(128, 27)).astype(np.float32)
    vd = v if use_viewdirs else None
    want = np.asarray(apply_model(
        params, jnp.asarray(x), None if vd is None else jnp.asarray(vd),
        JaxModelConfig(use_viewdirs=use_viewdirs, **SMALL)))
    with torch.no_grad():
        got = net(torch.from_numpy(x),
                  None if vd is None else torch.from_numpy(vd)).numpy()
    assert got.shape == want.shape == (128, 4)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_model_from_params_defaults_to_cuda(monkeypatch):
    """Like every entry point, the converter runs on ``cuda`` unless told
    otherwise, and raises without a GPU rather than fall back to the
    CPU."""
    params = _jax_params()
    mc = ModelConfig(**SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.model_from_params(params, mc)
    net = convert.model_from_params(params, mc, device="cpu")
    assert net.pts_linears[0].weight.device.type == "cpu"


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_conversion_round_trip_is_exact(use_viewdirs):
    params = _jax_params(use_viewdirs, seed=2)
    mc = ModelConfig(use_viewdirs=use_viewdirs, **SMALL)
    back = convert.params_from_model(
        convert.model_from_params(params, mc, device="cpu"))
    assert set(back) == set(params)
    for name in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf],
                                          params[name][leaf])
    # The JAX package's own torch export lands on the same module weights.
    sd = params_to_torch_state_dict(params, JaxModelConfig(
        use_viewdirs=use_viewdirs, **SMALL))
    ours = convert.state_dict_from_params(params, mc)
    assert sd.keys() == ours.keys()
    for k in sd:
        torch.testing.assert_close(ours[k], sd[k], rtol=0, atol=0)


def test_expected_shapes_match_jax():
    for use_viewdirs in (True, False):
        assert convert.expected_shapes(
            ModelConfig(use_viewdirs=use_viewdirs, **SMALL)
        ) == jax_expected_shapes(
            JaxModelConfig(use_viewdirs=use_viewdirs, **SMALL))


def test_load_npy_and_pth_checkpoints(tmp_path):
    params = _jax_params(seed=3)
    jmc = JaxModelConfig(**SMALL)
    mc = ModelConfig(**SMALL)
    arrays = jax_params_to_numpy(params, jmc)
    npy = tmp_path / "weights.npy"
    obj = np.empty(len(arrays), dtype=object)
    obj[:] = arrays
    np.save(npy, obj)
    bare = tmp_path / "model_best.pth"
    torch.save(params_to_torch_state_dict(params, jmc), bare)
    composite = tmp_path / "metrics_latest.pth"
    torch.save({"model_state_dict": params_to_torch_state_dict(params, jmc),
                "best_val_psnr": 12.5}, composite)
    for path in (npy, bare, composite):
        loaded, step = load_params_any(str(path), mc, device="cpu",
                                       with_step=True)
        assert step == 0 and set(loaded) == {"coarse"}
        got = convert.params_from_model(loaded["coarse"])
        for name in params:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(got[name][leaf],
                                              params[name][leaf])
    with pytest.raises(ValueError, match="architecture"):
        load_params_any(str(bare), ModelConfig(depth=7, width=64,
                                               bottleneck_ch=64,
                                               view_width=32), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_params_any(str(tmp_path / "model_100.ckpt"), mc, device="cpu")


def test_init_is_flax_like_and_seeded():
    """lecun-normal kernels truncated at 2 std, zero biases, and one seed
    gives one net."""
    a = init_model(ModelConfig(), seed=5, device="cpu")
    b = init_model(ModelConfig(), seed=5, device="cpu")
    c = init_model(ModelConfig(), seed=6, device="cpu")
    w = a.pts_linears[1].weight.detach()
    assert torch.equal(w, b.pts_linears[1].weight)
    assert not torch.equal(w, c.pts_linears[1].weight)
    std = (1.0 / 256) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert all(float(m.bias.detach().abs().max()) == 0.0 for m in a.modules()
               if isinstance(m, torch.nn.Linear))
    assert set(dict(a.named_parameters())) >= {
        "pts_linears.0.weight", "sigma_linear.bias", "bottleneck_linear.weight",
        "view_linear.weight", "rgb_linear.bias"}


def test_no_device_and_no_cuda_raises(monkeypatch):
    from nerfmlp_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(ModelConfig(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert isinstance(init_model(ModelConfig(**SMALL), device="cpu"), NeRFMLP)
