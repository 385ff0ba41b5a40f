"""Windows of train steps with no Python between them: one captured step,
replayed (``TrainConfig.steps_per_dispatch``).

Counterpart of ``nerfmlp_tpu/parallel/train_step.py::make_train_scan`` and
``::make_pool_scan``, which run K steps in one jitted ``lax.scan``. Here
the step body of ``parallel/train_step.py::make_step_body`` is captured
once in a CUDA graph per batch source and replayed ``w`` times per window:

  * ``"pool"``: the batch is picked on the device from the device pool's
    stack by the step counter (``counter % steps_per_epoch``); the stack
    is written in place at each epoch, between windows;
  * ``"host"``: the host's (w, B, F) window of batches (precrop,
    ``--no_batching``, no pool) is copied once per window from pinned
    memory into a static device buffer, which the step reads by a slot
    counter the graph advances.

The graph's static inputs are the nets, Adam's state, the step counter,
the generator (registered with the graph, so replays draw what eager steps
would), the pool stack or batch buffer and the occupancy grid's density,
which a refresh overwrites in place between windows. Each replay adds the
step's loss and PSNR to ``sums`` on the device; the last step's metrics
stay in the graph's output tensors. Nothing inside a window reads back to
the host.

Capture: a few eager steps on a side stream (lazy builds, cuBLAS
workspaces, autograd's buffers), then the nets, Adam, the counter, the
sums and the generator are restored to their state before them, so the
first replay is the step the eager loop would have taken. A capture that
fails raises, naming the cause; nothing falls back to eager steps.

On the CPU (asked for with ``device="cpu"``) there are no graphs: a window
runs the same function eagerly ``w`` times.

A data-parallel body (``make_step_body(..., mesh=...)``) is captured with
its gradient ``all_reduce``: NCCL collectives can be captured in a CUDA
graph, and every rank warms up, restores and captures the same steps in
the same order. gloo's cannot (they go through the host), so the Trainer
refuses K > 1 under gloo on ``cuda``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerfmlp_torch.parallel.train_step import TrainState

WARMUP_STEPS = 3


class StepWindows:
    """Runs windows of ``w <= max_w`` train steps through ``body``
    (``make_step_body``'s) on ``state``; ``sums`` is a (2,) device tensor
    that each step adds its [loss, psnr] to. ``pool``: the
    :class:`~nerfmlp_torch.data.device_pool.DeviceRayPool` of ``"pool"``
    windows; ``occ_grid``: the grid the step reads."""

    def __init__(self, state: TrainState, body: Callable, max_w: int,
                 sums: torch.Tensor, pool=None, occ_grid=None):
        self.state, self.body, self.max_w = state, body, int(max_w)
        self.sums, self.pool, self.occ_grid = sums, pool, occ_grid
        self.device = state.counter.device
        self.on_cuda = self.device.type == "cuda"
        self.slot = torch.zeros((), dtype=torch.int64, device=self.device)
        self.host_buf: Optional[torch.Tensor] = None
        self._pinned: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None
        self.graphs: Dict[str, tuple] = {}   # source -> (graph, metrics)
        self._mempool = None                 # shared by the sources' graphs
        self.replays = 0

    # ------------------------------------------------------------------ #

    def _step(self, source: str) -> Dict[str, torch.Tensor]:
        """One step: pick the batch on the device, run the body, add to
        the sums. What the graph captures."""
        if source == "pool":
            batch = self.pool.batch_at(self.state.counter)
        else:
            batch = self.host_buf.index_select(0, self.slot.reshape(1))[0]
            self.slot.add_(1)
        occ = () if self.occ_grid is None else (self.occ_grid,)
        metrics = self.body(self.state, batch, *occ)
        self.sums.add_(torch.stack((metrics["loss"], metrics["psnr"])))
        return metrics

    def _snapshot(self):
        st = self.state
        opt = st.optimizer
        tensors = ([p for net in st.params.values() for p in net.parameters()]
                   + opt.exp_avg + opt.exp_avg_sq
                   + [opt.count, st.counter, self.sums, self.slot])
        return tensors, [t.detach().clone() for t in tensors], \
            st.generator.get_state()

    @torch.no_grad()
    def _restore(self, snap) -> None:
        tensors, saved, gen_state = snap
        for t, s in zip(tensors, saved):
            t.copy_(s)
        self.state.generator.set_state(gen_state)

    def _capture(self, source: str) -> tuple:
        """Warm up on a side stream, restore, capture one step."""
        snap = self._snapshot()
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self.slot.zero_()   # the window's first batch, real rays
                    self._step(source)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._restore(snap)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.state.generator)
            self.state.optimizer.zero_grad()
            with torch.cuda.graph(graph, pool=self._mempool):
                metrics = self._step(source)
        except Exception as e:
            raise RuntimeError(
                f"CUDA-graph capture of the train step ({source} batches) "
                f"failed: {type(e).__name__}: {e}") from e
        self._restore(snap)
        if self._mempool is None:
            self._mempool = graph.pool()
        return graph, metrics

    def _check(self, w: int) -> None:
        if not 1 <= w <= self.max_w:
            raise ValueError(f"window of {w} steps (1..{self.max_w})")

    def _run(self, source: str, w: int) -> Dict[str, torch.Tensor]:
        if not self.on_cuda:
            for _ in range(w):
                metrics = self._step(source)
        else:
            if source not in self.graphs:
                self.graphs[source] = self._capture(source)
            graph, metrics = self.graphs[source]
            for _ in range(w):
                graph.replay()
            self.replays += w
        self.state.step += w
        return metrics

    # ------------------------------------------------------------------ #

    def run_pool(self, w: int) -> Dict[str, torch.Tensor]:
        """``w`` steps on the pool's current stack (the caller keeps the
        window inside one epoch). Returns the last step's metrics."""
        self._check(w)
        return self._run("pool", w)

    def run_host(self, batches: np.ndarray) -> Dict[str, torch.Tensor]:
        """One step per (B, F) batch of the (w, B, F) host window, copied
        into the static buffer first. Returns the last step's metrics."""
        w = batches.shape[0]
        self._check(w)
        if self.host_buf is None:
            shape = (self.max_w,) + tuple(batches.shape[1:])
            self.host_buf = torch.zeros(shape, dtype=torch.float32,
                                        device=self.device)
            if self.on_cuda:
                self._pinned = torch.empty(shape, dtype=torch.float32,
                                           pin_memory=True)
                self._copied = torch.cuda.Event()
        src = torch.from_numpy(np.ascontiguousarray(batches, np.float32))
        if self.on_cuda:
            # The previous window's copy must have left the pinned buffer
            # before the host overwrites it.
            self._copied.synchronize()
            self._pinned[:w].copy_(src)
            self.host_buf[:w].copy_(self._pinned[:w], non_blocking=True)
            self._copied.record()
        else:
            self.host_buf[:w].copy_(src)
        self.slot.zero_()
        return self._run("host", w)
