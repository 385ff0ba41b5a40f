"""A training run's held-out renders as one time-lapse video.

The PyTorch counterpart of ``scripts/make_timelapse.py``: the Trainer's
``--i_img N`` writes ``val_{step:06d}.png`` of the same held-out view
every N steps; this orders them by step and writes them as an animated
GIF through the port's ``read_png`` and ``write_video``.

Example:
    python -m nerfmlp_torch.scripts.train ... --i_img 1000
    python -m nerfmlp_torch.scripts.make_timelapse --run_dir outputs/run1
"""

from __future__ import annotations

import argparse
import os
import re


def collect_frames(run_dir: str, pattern: str = r"val_(\d+)\.png"):
    """(step, path) of every matching frame, ordered by step."""
    frames = []
    rx = re.compile(pattern)
    for name in os.listdir(run_dir):
        m = rx.fullmatch(name)
        if m:
            frames.append((int(m.group(1)), os.path.join(run_dir, name)))
    return sorted(frames)


def main(argv=None):
    p = argparse.ArgumentParser(description="Compile training time-lapse")
    p.add_argument("--run_dir", type=str, required=True,
                   help="training save_dir holding val_{step}.png dumps")
    p.add_argument("--out", type=str, default=None,
                   help="output base path (default <run_dir>/timelapse)")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--pattern", type=str, default=r"val_(\d+)\.png",
                   help="frame filename regex with a step capture group")
    args = p.parse_args(argv)

    from nerfmlp_torch.utils.image import read_png, write_video

    if not os.path.isdir(args.run_dir):
        print(f"run_dir not found: {args.run_dir}")
        return None
    frames = collect_frames(args.run_dir, args.pattern)
    if not frames:
        print(f"no frames matching {args.pattern!r} in {args.run_dir} — "
              f"train with --i_img N to produce them")
        return None
    imgs = [read_png(path)[..., :3] for _, path in frames]
    base = args.out or os.path.join(args.run_dir, "timelapse")
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    out = write_video(base, imgs, fps=args.fps)
    print(f"{len(imgs)} frames (steps {frames[0][0]:,} -> {frames[-1][0]:,}) "
          f"-> {out}")
    return out


if __name__ == "__main__":
    main()
