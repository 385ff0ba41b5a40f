"""Convert checkpoints between every format the port reads.

The PyTorch counterpart of ``scripts/convert_checkpoint.py``, with its
flags (``--in --out --net --separate_fine`` and the architecture flags):

  * ``.ckpt`` — the JAX package's flax-msgpack param tree (params-only
    files and whole train states such as ``metrics_latest.ckpt``, whose
    params are taken), read and written by ``train/flax_msgpack.py``; the
    JAX package reads what this writes;
  * ``.npy`` — the official TF release's object-array weight list;
  * ``.pth`` / ``.pt`` — torch state dicts: the reference's, and the
    parameter files the port's Trainer writes.

``.npy`` / ``.pth`` hold one network; ``--net fine`` selects the fine net
of a two-net checkpoint (default: coarse). A ``.ckpt`` destination keeps
every net unless ``--net`` names one. Runs on the CPU: no GPU is needed.

Example:
    python -m nerfmlp_torch.scripts.convert_checkpoint \\
        --in logs/lego/model_final.ckpt --out model_final.pth
"""

from __future__ import annotations

import argparse
import os

_FORMATS = (".ckpt", ".npy", ".pth", ".pt")


def _fmt(path: str) -> str:
    for ext in _FORMATS:
        if path.endswith(ext):
            return ".pth" if ext == ".pt" else ext
    raise SystemExit(f"unrecognized checkpoint extension on {path!r} "
                     f"(expected one of {', '.join(_FORMATS)})")


def build_parser():
    from nerfmlp_torch.utils.cli import add_arch_flags

    p = argparse.ArgumentParser(
        description="Convert between .ckpt / .npy / .pth checkpoints")
    p.add_argument("--in", dest="src", required=True,
                   help="source checkpoint (.ckpt, .npy, .pth/.pt)")
    p.add_argument("--out", dest="dst", required=True,
                   help="destination (format chosen by extension)")
    p.add_argument("--net", choices=["coarse", "fine"], default=None,
                   help="which network to export: for .npy/.pth the default "
                        "is coarse; a .ckpt destination keeps every net "
                        "unless --net names one")
    p.add_argument("--separate_fine", action="store_true",
                   help="the source holds distinct coarse/fine nets")
    add_arch_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.models import convert
    from nerfmlp_torch.train.checkpoint import (
        jax_params_tree, load_params_any, save_ckpt,
    )
    from nerfmlp_torch.utils.cli import arch_fields

    _fmt(args.src)
    dst_fmt = _fmt(args.dst)
    rc = RenderConfig(separate_fine=args.separate_fine, **arch_fields(args))
    params = load_params_any(
        args.src, rc.model_config(), device="cpu",
        fine_cfg=rc.model_config(fine=True) if args.separate_fine else None)
    if args.net == "fine" and "fine" not in params:
        raise SystemExit(f"--net fine: {args.src} holds no separate fine "
                         f"network (nets: {list(params)})")
    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    if dst_fmt == ".ckpt":
        if args.net is not None:
            params = {"coarse": params[args.net]}
        save_ckpt(args.dst, jax_params_tree(params))
        nets = "+".join(params) + (f" (from {args.net})" if args.net else "")
        print(f"wrote {args.dst} ({nets})")
        return args.dst

    net_name = args.net or "coarse"
    net = params[net_name]
    if dst_fmt == ".npy":
        convert.save_npy_weights(args.dst, convert.params_from_model(net),
                                 net.cfg)
    else:
        torch.save(convert.state_dict_from_params(
            convert.params_from_model(net), net.cfg), args.dst)
    print(f"wrote {args.dst} ({net_name} net)")
    return args.dst


if __name__ == "__main__":
    main()
