"""CLI: extend a video autoregressively beyond the model's frames.

    python -m xdiffusion_tpu_torch.extend_video \\
        --config_path configs/video/moving_mnist/flexible_diffusion_modeling.yaml \\
        --checkpoint <run dir's checkpoint .pt> --total_frames 32

Counterpart of sampling/video/extend.py, with `--device` (cuda, the
default, or cpu) in place of `--force_cpu`. A first chunk of the model's
frames is sampled unconditionally; then each new chunk is conditioned on
the last `--num_frame_overlap` frames so far and its other frames are
appended, until `--total_frames`:

- hard conditioning (the default): `video_mask` False on the overlap slots
  and `x0` the tail in model space (tail * 2 - 1) padded with zeros to the
  model's frames, pinned by the sampling splice;
- soft conditioning (`--reconstruction_guidance`): `x_a` = tail * 2 - 1 for
  the ancestral sampler's reconstruction guidance, with
  `num_frame_overlap` and `omega` (`--guidance_omega`). It needs a
  continuous (logSNR) schedule, as in JAX.

`--checkpoint` takes what the sampling CLI takes (weights.py
`load_checkpoint`). A text-conditional config samples with the prompts "0",
"1", .... Writes `<output_path>/extended-{N}f.gif`.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from xdiffusion_tpu_torch.sample_video import save_gif
from xdiffusion_tpu_torch.training.common import is_text_conditional


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    p = argparse.ArgumentParser(description="Extend a video autoregressively (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=2)
    p.add_argument("--total_frames", type=int, default=32)
    p.add_argument("--num_frame_overlap", type=int, default=4)
    p.add_argument("--reconstruction_guidance", action="store_true")
    p.add_argument("--guidance_omega", type=float, default=2.0)
    p.add_argument("--sampling_steps", type=int, default=0)
    p.add_argument("--output_path", type=str, default="output/extended")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler
    from xdiffusion_tpu_torch.weights import load_checkpoint

    config = load_yaml(args.config_path)
    model = GaussianDiffusion_DDPM(config, device=args.device)
    frames_per_chunk = int(config.diffusion.score_network.params.input_number_of_frames)
    overlap = int(args.num_frame_overlap)
    assert 0 < overlap < frames_per_chunk
    step = load_checkpoint(model.score_network(), args.checkpoint)
    print(f"restored checkpoint @ step {step}", flush=True)

    context = {}
    if is_text_conditional(model):
        context["text_prompts"] = [str(i % 10) for i in range(args.num_samples)]
    steps = args.sampling_steps or None
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    video = model.sample(num_samples=args.num_samples, context=dict(context),
                         num_sampling_steps=steps, generator=generator).float().cpu().numpy()

    sampler = None
    if args.reconstruction_guidance:
        sampler = AncestralSampler(reconstruction_guidance=True, omega=args.guidance_omega,
                                   num_frame_overlap=overlap)
    n = args.num_samples
    while video.shape[1] < args.total_frames:
        tail = torch.from_numpy(video[:, -overlap:]).to(model.device)
        chunk_context = dict(context)
        if args.reconstruction_guidance:
            # Soft: guide the first `overlap` frames towards the tail.
            chunk_context["x_a"] = tail * 2.0 - 1.0
        else:
            # Hard: pin the overlap frames through the video mask (True =
            # generate) and the padded tail.
            mask = torch.ones((n, frames_per_chunk), dtype=torch.bool, device=model.device)
            mask[:, :overlap] = False
            x0 = torch.zeros((n, frames_per_chunk) + tuple(tail.shape[2:]), device=model.device)
            x0[:, :overlap] = tail * 2.0 - 1.0
            chunk_context.update(video_mask=mask, x0=x0)
        chunk = model.sample(num_samples=n, context=chunk_context, num_sampling_steps=steps,
                             sampler=sampler, generator=generator).float().cpu().numpy()
        video = np.concatenate([video, chunk[:, overlap:]], axis=1)
        print(f"extended to {video.shape[1]} frames", flush=True)

    video = video[:, :args.total_frames]
    out = os.path.join(args.output_path, f"extended-{video.shape[1]}f.gif")
    save_gif(video, out)
    print(f"wrote {out}", flush=True)
    return torch.from_numpy(video)


if __name__ == "__main__":
    main()
