"""CLI: sample a video diffusion model with the port and write a frame strip.

    python -m xdiffusion_tpu_torch.sample_video \\
        --config_path configs/video/moving_mnist/ltx_video/ltx_video_pixel_space.yaml \\
        --checkpoint model.pt --num_samples 4

Counterpart of sampling/video/sample.py. `--checkpoint` takes a port
`state_dict` (`.pt`) or flattened flax parameters (`.npz`; see weights.py).
A text-conditional config samples with the digit-name prompts "0", "1", ...
as the JAX video trainer does. Writes `<output_path>/samples.png`: one row
per video, its frames left to right. Long-video sampling schemes
(`--sampling_scheme_path`) and the animated GIF are not ported yet. Runs on
CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from xdiffusion_tpu_torch.sample import save_image_grid


def is_text_conditional(model) -> bool:
    """True when the model's guidance or conditioning signals, or its
    context preprocessors, carry text."""
    diff = model.config().diffusion
    signals = []
    if "classifier_free_guidance" in diff:
        signals += list(diff.classifier_free_guidance.get("signals", []))
    sn = diff.score_network.params if "score_network" in diff else {}
    if "conditioning" in sn:
        signals += list(sn.conditioning.signals)
    for prep in diff.get("context_preprocessing", []) or []:
        target = (prep.get("target", "") or "").lower()
        if "text" in target or "clip" in target:
            return True
    return any("text" in s for s in signals)


def save_video_strip(videos: np.ndarray, path: str) -> None:
    """Writes (B, F, H, W, C) [0, 1] videos as one PNG: a row per video, its
    frames left to right."""
    b, f, h, w, c = videos.shape
    save_image_grid(videos.transpose(0, 2, 1, 3, 4).reshape(b, h, f * w, c), path, cols=1)


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    p = argparse.ArgumentParser(description="Sample a video diffusion model (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--sampling_steps", type=int, default=None)
    p.add_argument("--sampling_scheme_path", type=str, default="")
    p.add_argument("--output_path", type=str, default="output/video_samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_checkpoint

    model = GaussianDiffusion_DDPM(load_yaml(args.config_path), device=args.device)
    if args.sampling_scheme_path:
        raise NotImplementedError("long-video sampling schemes are not ported yet")
    load_checkpoint(model.score_network(), args.checkpoint)
    context = {}
    if is_text_conditional(model):
        context["text_prompts"] = [str(i % 10) for i in range(args.num_samples)]
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    samples = model.sample(num_samples=args.num_samples, context=context,
                           num_sampling_steps=args.sampling_steps, generator=generator)
    out = os.path.join(args.output_path, "samples.png")
    save_video_strip(samples.float().cpu().numpy(), out)
    print(f"wrote {out}", flush=True)
    return samples


if __name__ == "__main__":
    main()
