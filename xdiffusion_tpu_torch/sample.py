"""CLI: sample an image diffusion model with the port and write a PNG grid.

    python -m xdiffusion_tpu_torch.sample \\
        --config_path configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml \\
        --checkpoint model.pt --sampler_config_path \\
        configs/image/mnist/samplers/ddim.yaml --sampling_steps 50

Mirrors the flags of sampling/image/sample.py and, as it does, builds the
process the config names (DDPM, score SDE, EDM, consistency or a cascade;
`build_model`). A cascade samples its stages in a chain, each with its own
sampler (the JAX CLI reads `config.diffusion` and raises on a cascade).
`--checkpoint` takes a port `state_dict` (`.pt`), a training
checkpoint (`checkpoints/<step>.pt` of the trainer or of the
distill_consistency CLI; its EMA parameters when present, which a
consistency process samples with) or flattened flax
parameters (`.npz`, keyed by `/`-joined flax paths; see weights.py). A
class-conditional config samples classes arange(num_samples) % 10;
`--text_prompts "a,b,..."` gives a text-conditional one its prompts,
repeated in turn over the samples. Writes `<output_path>/sample-step{step}.png`,
the step a training checkpoint records (0 for a state dict or flax params).
`--lora_weights` (or `--lora_path`) names a `lora_weights.pkl` of a LoRA
run, the port's or the JAX package's, whose factors are merged into the
restored parameters before sampling (lora.py `merge_lora`). Runs on CUDA
unless `--device cpu`.
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
                   help="path to lora_weights.pkl saved by --use_lora_training; "
                        "merged before sampling")
    p.add_argument("--text_prompts", type=str, default="",
                   help="comma-separated prompts for text-conditional models")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.config import (
        instantiate_from_config,
        is_class_conditional,
        load_yaml,
    )
    from xdiffusion_tpu_torch.training.image.train import build_model
    from xdiffusion_tpu_torch.weights import load_checkpoint

    model = build_model(load_yaml(args.config_path), device=args.device)
    # A consistency process samples its EMA network (else its score network).
    network = getattr(model, "sampling_network", model.score_network)()
    step = load_checkpoint(network, args.checkpoint)
    print(f"restored checkpoint @ step {step}", flush=True)
    if args.lora_weights:
        from xdiffusion_tpu_torch import lora as lora_lib

        lora = lora_lib.load_lora_weights(args.lora_weights, network)
        lora_lib.merge_lora(network, lora)
        print(f"merged LoRA ({lora_lib.lora_param_count(lora) / 1e6:.3f}M params, "
              f"rank {lora.rank})", flush=True)
    sampler = None
    if args.sampler_config_path:
        sampler = instantiate_from_config(
            load_yaml(args.sampler_config_path).sampling.to_dict())
    context = {}
    if args.text_prompts:
        prompts = [s.strip() for s in args.text_prompts.split(",")]
        context["text_prompts"] = (prompts * (args.num_samples // len(prompts) + 1)
                                   )[:args.num_samples]
    config = model.config()
    if is_class_conditional(config if "diffusion" in config else model.models()[0].config()):
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
