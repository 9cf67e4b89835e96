"""CLI: sample an image diffusion model with the port and write a PNG grid.

    python -m xdiffusion_tpu_torch.sample \\
        --config_path configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml \\
        --checkpoint model.pt --sampler_config_path \\
        configs/image/mnist/samplers/ddim.yaml --sampling_steps 50

Mirrors the flags of sampling/image/sample.py. `--checkpoint` takes a port
`state_dict` (`.pt`), a training checkpoint (`checkpoints/<step>.pt`; its EMA
parameters when present) or flattened flax parameters (`.npz`, keyed by
`/`-joined flax paths; see weights.py). A class-conditional config samples
classes arange(num_samples) % 10. Writes `<output_path>/sample-step{step}.png`,
the step a training checkpoint records (0 for a state dict or flax params).
`--lora_weights` and `--text_prompts` are accepted as the JAX CLI accepts
them and raise `NotImplementedError`: LoRA and text conditioning are not
ported yet. Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import List, Optional

import numpy as np
import torch


def save_image_grid(samples: np.ndarray, path: str, cols: Optional[int] = None) -> None:
    """Writes an (N, H, W, C) [0, 1] batch as one 8-bit PNG grid (C = 1 or 3)."""
    n, h, w, c = samples.shape
    if c not in (1, 3):
        raise ValueError(f"PNG grid needs 1 or 3 channels, got {c}")
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = samples[i]
    pixels = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    raw = b"".join(b"\x00" + row.tobytes() for row in pixels)  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", pixels.shape[1], pixels.shape[0], 8,
                         0 if c == 1 else 2, 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    p = argparse.ArgumentParser(description="Sample an image diffusion model (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--guidance", type=float, default=None)
    p.add_argument("--sampling_steps", type=int, default=None)
    p.add_argument("--sampler_config_path", type=str, default="")
    p.add_argument("--output_path", type=str, default="output/samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lora_weights", "--lora_path", type=str, default="",
                   help="LoRA weights to merge before sampling (not ported yet)")
    p.add_argument("--text_prompts", type=str, default="",
                   help="comma-separated prompts for text-conditional models "
                        "(not ported yet)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.lora_weights:
        raise NotImplementedError("--lora_weights: LoRA is not ported yet")
    if args.text_prompts:
        raise NotImplementedError("--text_prompts: text conditioning is not ported yet")

    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_checkpoint

    model = GaussianDiffusion_DDPM(load_yaml(args.config_path), device=args.device)
    step = load_checkpoint(model.score_network(), args.checkpoint)
    print(f"restored checkpoint @ step {step}", flush=True)
    sampler = None
    if args.sampler_config_path:
        sampler = instantiate_from_config(
            load_yaml(args.sampler_config_path).sampling.to_dict())
    context = {}
    if model.config().diffusion.score_network.params.get("is_class_conditional", False):
        context["classes"] = torch.arange(args.num_samples, device=model.device) % 10
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    samples = model.sample(
        num_samples=args.num_samples,
        context=context,
        classifier_free_guidance=args.guidance,
        num_sampling_steps=args.sampling_steps,
        sampler=sampler,
        generator=generator,
    )
    out = os.path.join(args.output_path, f"sample-step{step}.png")
    save_image_grid(samples.float().cpu().numpy(), out)
    print(f"wrote {out}", flush=True)
    return samples


if __name__ == "__main__":
    main()
