"""CLI: a VAE's reconstructions of held-out data.

    python -m xdiffusion_tpu_torch.reconstruct \
        --config_path configs/audio/urbansound8k/vae.yaml \
        --autoencoder_checkpoint <run dir or .pt>

Counterpart of sampling/video/reconstruct.py, with `--device` (CUDA unless
`--device cpu`). Encodes the first `--num_samples` examples of the
dataset's validation split (the posterior drawn from a generator seeded by
1), decodes them, prints the mean squared error of the reconstructions
clipped to [0, 1], and writes the inputs beside them as
<output_path>/reconstruction-step<step>.png. A video dataset gives clips of
the config's frame count and a strip of inputs over reconstructions a clip:
the JAX CLI reads `dataset.images`, which a video dataset lacks, and fails
there. Returns (inputs, reconstructions, mse).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="VAE reconstruction check (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--autoencoder_checkpoint", type=str, required=True)
    p.add_argument("--dataset_name", type=str, default="image/mnist")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--output_path", type=str, default="output/reconstructions")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.training.common import save_image_grid
    from xdiffusion_tpu_torch.training.image.autoencoder import build_vae
    from xdiffusion_tpu_torch.training.video.autoencoder import clip_frames

    config = load_yaml(args.config_path)
    vae = build_vae(config, args.device)
    payload = checkpoints.read_payload(args.autoencoder_checkpoint, vae.device)
    vae.load_state_dict(payload["params"])
    step = int(payload["step"])
    print(f"restored VAE @ step {step}", flush=True)

    dataset, _ = load_dataset(args.dataset_name, config=config, split="val")
    video = hasattr(dataset, "videos")
    data = dataset.videos[:args.num_samples, :clip_frames(config)] if video else \
        dataset.images[:args.num_samples]
    inputs = torch.from_numpy(data.astype(np.float32) / 255.0).to(vae.device)
    generator = torch.Generator(device=vae.device).manual_seed(1)
    with torch.no_grad():
        recon = vae.decode_from_latents(vae.encode_to_latents(inputs, generator=generator))
    recon = recon[:, :inputs.shape[1]].clamp(0, 1)
    mse = float(torch.mean((inputs - recon) ** 2))
    print(f"reconstruction MSE: {mse:.6f}", flush=True)

    os.makedirs(args.output_path, exist_ok=True)
    x, y = inputs.cpu().numpy(), recon.cpu().numpy()
    if video:
        grid = np.stack([np.concatenate([np.concatenate(list(x[i]), axis=1),
                                         np.concatenate(list(y[i]), axis=1)], axis=0)
                         for i in range(x.shape[0])])
    else:
        grid = np.concatenate([x, y], axis=2)
    out = os.path.join(args.output_path, f"reconstruction-step{step}.png")
    save_image_grid(grid, out, cols=1 if video else None)
    print(f"wrote {out}", flush=True)
    return inputs, recon, mse


if __name__ == "__main__":
    main()
