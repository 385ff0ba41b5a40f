"""Training steps and data parallelism (counterpart of
``nerfmlp_tpu/parallel``). Its exports, but for the tensor-parallel
names (not ported), under the port's names: ``batch_sharding`` is
:func:`shard_batch`, ``replicated_sharding`` is :func:`replicate_`, and
``make_train_step`` is :func:`make_step_fn` (with ``mesh=``)."""

from nerfmlp_torch.parallel.mesh import (
    init_distributed, make_mesh, replicate_, shard_batch,
)
from nerfmlp_torch.parallel.render_parallel import render_image_sharded
from nerfmlp_torch.parallel.train_step import (
    TrainState, create_train_state, make_step_fn,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "replicate_",
    "render_image_sharded",
    "TrainState",
    "make_step_fn",
    "create_train_state",
]
