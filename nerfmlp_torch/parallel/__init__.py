"""Training steps, data and tensor parallelism (counterpart of
``nerfmlp_tpu/parallel``). Its exports under the port's names:
``batch_sharding`` is :func:`shard_batch`, ``replicated_sharding`` is
:func:`replicate_`, ``make_train_step`` is :func:`make_step_fn` (with
``mesh=``), and ``make_tp_train_step`` is :func:`make_tp_step` (on a
:func:`make_tp_mesh` mesh, the state from :func:`shard_state`)."""

from nerfmlp_torch.parallel.mesh import (
    init_distributed, make_mesh, replicate_, shard_batch,
)
from nerfmlp_torch.parallel.render_parallel import render_image_sharded
from nerfmlp_torch.parallel.tensor_parallel import (
    make_tp_mesh, make_tp_step, shard_state,
)
from nerfmlp_torch.parallel.train_step import (
    TrainState, create_train_state, make_step_fn,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "replicate_",
    "render_image_sharded",
    "make_tp_mesh",
    "make_tp_step",
    "shard_state",
    "TrainState",
    "make_step_fn",
    "create_train_state",
]
