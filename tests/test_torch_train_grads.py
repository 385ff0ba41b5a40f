"""The port's coarse-only loss and gradients against the JAX package's,
fp32 module path, same weights and ray batch, op by op on the JAX side
(the bars of tests/test_reference_parity.py:374-415: loss to 1e-6,
gradients at atol 5e-5). Helpers live in tests/test_torch_train_step.py."""

import numpy as np

from nerfmlp_tpu.config import TrainConfig as JaxTrainConfig

from nerfmlp_torch.config import TrainConfig

from test_torch_train_step import (
    _jax_loss_grads, _port_loss_grads, _port_params, _setup,
)


def test_loss_and_grads_match_jax_coarse_only():
    """No importance sampling: the pure wiring check, elementwise."""
    jcfg, rc, params, batch = _setup(n_importance=0)
    loss_j, grads_j = _jax_loss_grads(params, batch, jcfg, JaxTrainConfig())
    loss_t, grads_t = _port_loss_grads(_port_params(params, rc), batch, rc,
                                       TrainConfig())
    assert abs(loss_j - loss_t) < 1e-6
    for name in grads_j:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(grads_t[name][leaf],
                                       np.asarray(grads_j[name][leaf]),
                                       atol=5e-5, err_msg=f"{name}.{leaf}")
