"""CLI: train the perceptual-loss feature pyramid and save the filter bank.

    python -m xdiffusion_tpu_torch.train_perceptual_features --steps 800 \\
        [--output <path>.npz]

Counterpart of tools/train_perceptual_features.py, with its flags, its one
JSON line and `--device` (CUDA unless `--device cpu`): the conv geometry
`perceptual_distance` uses, trained as a digit classifier on `--num_images`
images of the dataset (autoencoders/perceptual.py
`train_perceptual_filters`), so its features carry semantic structure.
The default output is the port's shipped bank,
xdiffusion_tpu_torch/autoencoders/assets/perceptual_filters.npz, which the
loss picks up; XDIFFUSION_DATA_DIR/perceptual/filters.npz is searched
before it.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

DEFAULT_OUTPUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "autoencoders",
                              "assets", "perceptual_filters.npz")


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="Train the perceptual filter bank (PyTorch port).")
    p.add_argument("--dataset_name", type=str, default="image/mnist")
    p.add_argument("--num_images", type=int, default=8192)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str, default=DEFAULT_OUTPUT)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from xdiffusion_tpu_torch.autoencoders.perceptual import (
        save_filters,
        train_perceptual_filters,
    )
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    dataset, _ = load_dataset(args.dataset_name, split="train")
    rng = np.random.default_rng(args.seed)
    idx = rng.permutation(len(dataset))[: args.num_images]
    images = dataset.images[idx].astype(np.float32) / 255.0
    if images.ndim == 3:
        images = images[..., None]
    labels = dataset.labels[idx]

    filters, loss = train_perceptual_filters(images, labels, steps=args.steps, seed=args.seed,
                                             device=device)
    save_filters(os.path.abspath(args.output), filters)
    info = {
        "output": os.path.abspath(args.output),
        "final_train_loss": round(loss, 4),
        "num_images": int(len(images)),
        "steps": args.steps,
        "synthetic_data": bool(getattr(dataset, "synthetic", True)),
    }
    print(json.dumps(info), flush=True)
    return info


if __name__ == "__main__":
    main()
