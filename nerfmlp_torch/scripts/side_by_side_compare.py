"""A rendered image beside its ground truth, ``[ground truth | rendered]``.

The PyTorch counterpart of ``scripts/side_by_side_compare.py``, with its
positional and flag interface, on the port's image code: ``read_image``
(PNG or JPEG, Pillow's pixels), ``resize_lanczos`` (Pillow's LANCZOS, bit
for bit) where the sizes differ, ``save_png``. The ground truth is a path
(``--gt``) or a dataset index (``--datadir`` and ``--index``:
``<datadir>/<split>/r_{index}.png``).

Examples:
    python -m nerfmlp_torch.scripts.side_by_side_compare render.png out.png \\
        --gt gt.png
    python -m nerfmlp_torch.scripts.side_by_side_compare --rendered r.png \\
        --datadir data/lego --index 0 --out sbs.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def get_gt_path(datadir: str, split: str, idx: int) -> str:
    return os.path.join(datadir, split, f"r_{idx}.png")


def main(argv=None):
    p = argparse.ArgumentParser(description="Concat two images side by side")
    p.add_argument("rendered_pos", nargs="?", default=None,
                   metavar="rendered.png")
    p.add_argument("out_pos", nargs="?", default=None, metavar="output.png")
    p.add_argument("--rendered", type=str, default=None)
    p.add_argument("--gt", "--gt_path", type=str, default=None,
                   help="explicit GT path")
    p.add_argument("--datadir", "--gt_dir", type=str, default=None,
                   help="dataset root (reference flag name: --gt_dir)")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--index", "--gt_idx", type=int, default=None,
                   help="GT by dataset index (r_{i}.png; reference flag "
                        "name: --gt_idx)")
    p.add_argument("--out", type=str, default="outputs/side_by_side.png")
    args = p.parse_args(argv)
    if args.rendered is not None and args.rendered_pos is not None \
            and args.out_pos is None:
        # `script out.png --rendered r.png`: the lone positional is the
        # output.
        args.out_pos = args.rendered_pos
        args.rendered_pos = None
    if args.rendered is None:
        args.rendered = args.rendered_pos
    if args.rendered is None:
        p.error("provide the rendered image (positional or --rendered)")
    if args.out_pos is not None:
        args.out = args.out_pos

    from nerfmlp_torch.utils.image import read_rgb, resize_lanczos, save_png

    gt_path = args.gt
    if gt_path is None:
        if args.datadir is None or args.index is None:
            p.error("provide --gt or (--datadir and --index)")
        gt_path = get_gt_path(args.datadir, args.split, args.index)

    a = read_rgb(args.rendered)
    b = read_rgb(gt_path)
    if a.shape[:2] != b.shape[:2]:
        b = resize_lanczos(b, (a.shape[1], a.shape[0]))
    # [ground truth | rendered], the reference's panel order.
    side = np.concatenate([b, a], axis=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_png(args.out, side)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
