"""Config dataclasses of the PyTorch port.

Same fields, defaults and ``model_config()`` rule as the JAX package's
``nerfmlp_tpu/config.py:16-166``, so a configuration reads the same in
both packages (``TrainConfig``: ``nerfmlp_tpu/config.py:169-260``). One
rename: ``use_pallas`` is ``use_kernel`` here (the fused MLP is a pair of
hand-written CUDA kernels on this side, not Pallas ones).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the NeRF MLP.

    Defaults reproduce the reference: depth 8, width 256, skip-concat of the
    encoded input into layer index 5, view-dependent head with a 256-wide
    bottleneck and a single 128-wide hidden view layer.
    """

    depth: int = 8
    width: int = 256
    input_ch: int = 63          # 3 * (1 + 2 * pos_enc_L) with L=10
    input_ch_views: int = 27    # 3 * (1 + 2 * dir_enc_L) with L=4
    skips: Tuple[int, ...] = (5,)
    use_viewdirs: bool = True
    output_ch: int = 4          # only used when use_viewdirs=False
    bottleneck_ch: int = 256
    view_width: int = 128       # W // 2 in the reference

    @property
    def num_tf_arrays(self) -> int:
        """Length of the official .npy weight list this model maps to."""
        return 2 * self.depth + (8 if self.use_viewdirs else 2)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Volume-rendering configuration.

    ``perturb``/``raw_noise_std`` are train-time stochasticity; inference
    paths use ``dataclasses.replace(cfg, perturb=False, raw_noise_std=0.0)``.
    """

    pos_enc_L: int = 10
    dir_enc_L: int = 4
    # Network architecture; 0 for the fine dims means "same as coarse".
    depth: int = 8
    width: int = 256
    depth_fine: int = 0
    width_fine: int = 0
    N_samples: int = 64
    N_importance: int = 128
    near: float = 2.0
    far: float = 6.0
    white_bkgd: bool = True
    perturb: bool = True
    raw_noise_std: float = 0.0
    coord_scale: float = 1.0
    lindisp: bool = False        # inverse-depth sampling
    ndc: bool = False            # NDC ray reparameterization for LLFF scenes
    use_viewdirs: bool = True
    separate_fine: bool = False  # one shared net for coarse+fine by default
    use_kernel: bool = False     # fused encode+MLP CUDA kernel (ops/fused_mlp.py)
    compute_dtype: str = "float32"  # or "bfloat16"
    fp32_precision: str = "highest"  # "highest" = true fp32 matmuls;
                                 # "high" = three bf16 products per matmul
                                 # (the kernel's hi_lo mode). Ignored in
                                 # bfloat16 mode.
    remat: bool = False          # on the module path, checkpoint the
                                 # net's runs of layers (models/mlp.py::
                                 # remat_runs): the backward recomputes
                                 # their activations. The kernel path
                                 # ignores it (its backward recomputes the
                                 # forward already)
    aabb: Optional[Tuple[float, float, float, float, float, float]] = None
                                 # (xmin,ymin,zmin,xmax,ymax,zmax): tighten
                                 # per-ray near/far to the scene box
    use_occupancy: bool = False  # occupancy-grid sampling (ops/occupancy.py)
    occ_dense_samples: int = 128
    occ_grid_size: int = 64
    occ_update_every: int = 64
    occ_threshold: float = 1e-2
    occ_one_shot: bool = False
    occ_warmup_steps: int = 1024

    @property
    def input_ch(self) -> int:
        return 3 * (1 + 2 * self.pos_enc_L)

    @property
    def input_ch_views(self) -> int:
        return 3 * (1 + 2 * self.dir_enc_L)

    def model_config(self, fine: bool = False) -> ModelConfig:
        """Architecture of the coarse net, or (``fine=True``) the fine net.

        Bottleneck width equals the trunk width and the view layer is
        W // 2. The skip sits before layer 5 for every depth > 5 and is
        absent otherwise: depth 5 warns, because the TF oracle's trailing
        concat at that depth cannot be expressed in this convention.
        """
        depth = (self.depth_fine or self.depth) if fine else self.depth
        width = (self.width_fine or self.width) if fine else self.width
        if depth == 5:
            warnings.warn(
                "netdepth=5 drops the oracle's trailing skip concat: this "
                "model computes a (slightly) different function than the "
                "TF reference at depth 5; checkpoints do not interchange"
            )
        return ModelConfig(
            depth=depth,
            width=width,
            skips=(5,) if depth > 5 else (),
            input_ch=self.input_ch,
            input_ch_views=self.input_ch_views,
            use_viewdirs=self.use_viewdirs,
            bottleneck_ch=width,
            view_width=max(1, width // 2),
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization & loop configuration, the JAX package's
    (``nerfmlp_tpu/config.py:169-260``): same fields and defaults.

    The LR decays continuously, ``lr * rate ** (updates / steps)`` (the
    official schedule, example/run_nerf.py:705-709). ``steps_per_dispatch``
    K > 1 runs the steps in windows of up to K with no Python between them:
    on ``cuda`` one captured CUDA graph of the step, replayed (the JAX
    package's jitted ``lax.scan``; ``train/graph.py``), on the CPU the same
    step body eagerly; windows end at every step where the host has work.
    ``profile_dir``: a ``torch.profiler`` trace of steps 10-29 of each
    ``Trainer.train()`` call is written there (``train/loop.py``): each
    step a ``train step N`` range, beside the ranges of the program's
    spans by their names (``train.window``, ``train.batch``,
    ``train.occ_update``, ...: ``utils/spans.py``).
    """

    batch_size: int = 1024
    iters: int = 200_000
    lr: float = 5e-4
    lr_decay_rate: float = 0.1
    lr_decay_steps: int = 250_000
    coarse_loss: bool = False    # official adds img_loss0; reference trains
                                 # on the fine map only. Default = reference.
    seed: int = 0
    quick_val_interval: int = 1000
    full_val_interval: int = 50_000
    quick_val_subset: int = 10
    log_interval: int = 100
    ckpt_interval: int = 10_000
    grad_clip: float = 0.0       # 0 = off
    precrop_iters: int = 0       # central-crop sampling for the first N iters
    precrop_frac: float = 0.5
    no_batching: bool = False    # sample each batch from ONE random image
    profile_dir: str = ""        # torch.profiler trace of steps 10-29
    i_video: int = 0
    i_testset: int = 0
    i_img: int = 0
    render_factor: int = 0
    i_mesh: int = 0
    mesh_resolution: int = 128
    mesh_threshold: float = 25.0
    chunk: int = 4096            # ray tile for validation renders
    steps_per_dispatch: int = 1
    device_pool: bool = True     # ray pool resident on the device, shuffled
                                 # per epoch there (data/device_pool.py)
