"""CLI: synthesize a labeled Moving-MNIST dataset.

    python -m xdiffusion_tpu_torch.create_moving_mnist --num_videos 10000 \\
        [--reference_layout] [--dest <dir>]

Counterpart of tools/create_moving_mnist.py, with both of its flag surfaces:
the reference tool's (--dest/--filetype/--frame_size/--num_frames/
--num_images/--nums_per_image) and this repo's earlier one (--num_videos,
--image_size, --digits_per_video, --split, --output_path). Digits follow
bouncing trajectories with per-video digit labels (datasets/moving_mnist.py
`synthesize_moving_mnist`, the synthetic glyph set). Writes
<dir>/moving_mnist_<split>.npz (`videos` uint8 (N, F, S, S, 1), `labels`),
or with --reference_layout the MovingMNIST256-style pair
<dir>/MovingMNIST256/videos_data.npz (a flat (N*F, S, S) uint8 frame
stream) and labels_data.npz (per-frame labels); <dir> defaults to the
port's {data_root}/moving_mnist. The dataset's `_load_real` reads the
`.npz` under the data root, and the pair at 30 frames of 256x256 under
{data_root}/MovingMNIST256. The videos are synthesized on the host;
`--device` is resolved as every port CLI resolves it (CUDA unless
`--device cpu`, raising without a card).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Create a Moving-MNIST dataset (PyTorch port).")
    # This repo's surface.
    p.add_argument("--num_videos", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--digits_per_video", type=int, default=None)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--output_path", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    # Reference tool surface.
    p.add_argument("--dest", type=str, default="")
    p.add_argument("--filetype", type=str, default="npz", choices=["npz"])
    p.add_argument("--frame_size", type=int, default=None)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_images", type=int, default=None)
    p.add_argument("--nums_per_image", type=int, default=None)
    p.add_argument("--reference_layout", action="store_true",
                   help="write MovingMNIST256-style videos_data.npz/labels_data.npz")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.utils import resolve_device

    resolve_device(args.device)

    num_videos = args.num_videos or args.num_images or 10000
    image_size = args.image_size or args.frame_size or 32
    digits = args.digits_per_video or args.nums_per_image or 1

    from xdiffusion_tpu_torch.datasets.mnist import data_root
    from xdiffusion_tpu_torch.datasets.moving_mnist import synthesize_moving_mnist

    videos, labels = synthesize_moving_mnist(num_videos, num_frames=args.num_frames,
                                             image_size=image_size, digits_per_video=digits,
                                             seed=args.seed)
    out_dir = args.dest or args.output_path or os.path.join(data_root(), "moving_mnist")
    os.makedirs(out_dir, exist_ok=True)
    if args.reference_layout:
        ref_dir = os.path.join(out_dir, "MovingMNIST256")
        os.makedirs(ref_dir, exist_ok=True)
        n, f, s, _, _ = videos.shape
        flat = videos[..., 0].reshape(n * f, s, s)
        per_frame = np.repeat(labels[:, None, :], f, axis=1).reshape(n * f, -1)
        np.savez_compressed(os.path.join(ref_dir, "videos_data.npz"), flat)
        np.savez_compressed(os.path.join(ref_dir, "labels_data.npz"), per_frame)
        print(f"wrote {ref_dir}: videos {flat.shape}, labels {per_frame.shape}", flush=True)
        return ref_dir
    out = os.path.join(out_dir, f"moving_mnist_{args.split}.npz")
    np.savez_compressed(out, videos=videos, labels=labels)
    print(f"wrote {out}: videos {videos.shape}, labels {labels.shape}", flush=True)
    return out


if __name__ == "__main__":
    main()
