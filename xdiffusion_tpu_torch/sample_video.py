"""CLI: sample a video diffusion model with the port and write a frame strip.

    python -m xdiffusion_tpu_torch.sample_video \\
        --config_path configs/video/moving_mnist/ltx_video/ltx_video_pixel_space.yaml \\
        --checkpoint model.pt --num_samples 4

Counterpart of sampling/video/sample.py. `--checkpoint` takes a port
`state_dict` (`.pt`), a training checkpoint or flattened flax parameters
(`.npz`; see weights.py). A text-conditional config samples with the
digit-name prompts "0", "1", ... as the JAX video trainer does. Writes
`<output_path>/video-step{step}.gif`, the step a training checkpoint records
(0 for a state dict or flax params): an animated GIF laid out as the JAX
package's `save_gif` lays it out (`save_gif` here). Runs on CUDA unless
`--device cpu`. A latent config (`ltx_video.yaml`) is refused by `sample()`:
the CLI loads no VAE and sets no latent scale, and the JAX CLI fails there
too; the video trainer's strips sample it decoded.

With `--sampling_scheme_path` (a YAML with a `sampling_scheme`, such as
configs/video/sampling_schemes/autoregressive.yaml) it generates a long
video window by window, as sampling/video/sample.py does: each window's
observed frames are the frames generated so far (normalised to [-1, 1],
pinned through `video_mask`/`x0`), the window is padded to the model's
frames, the window's frames are written back, and the whole video goes to
`<output_path>/long-video-step{step}.gif`. No `frame_indices` are passed
per window, as in JAX, so a Flexible-Diffusion-Modeling network sees
arange(frames).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from xdiffusion_tpu_torch.sample import save_image_grid
from xdiffusion_tpu_torch.training.common import is_text_conditional


def save_video_strip(videos: np.ndarray, path: str) -> None:
    """Writes (B, F, H, W, C) [0, 1] videos as one PNG: a row per video, its
    frames left to right."""
    b, f, h, w, c = videos.shape
    save_image_grid(videos.transpose(0, 2, 1, 3, 4).reshape(b, h, f * w, c), path, cols=1)


def _lzw(pixels: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of 8-bit indices: a clear code first, codes
    packed least significant bit first, each as wide as the decoder will
    read it (one table entry behind the encoder), a clear code and a fresh
    table when the table reaches 4096 entries, and the end code."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    next_code = end + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += max(min_code_size + 1, (next_code - 1).bit_length())
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {bytes([i]): i for i in range(clear)}
    emit(clear)
    run = b""
    for value in pixels:
        grown = run + bytes([value])
        if grown in table:
            run = grown
            continue
        emit(table[run])
        table[grown] = next_code
        next_code += 1
        if next_code == 4096:
            emit(clear)
            table = {bytes([i]): i for i in range(clear)}
            next_code = end + 1
        run = bytes([value])
    if run:
        emit(table[run])
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def save_gif(videos: np.ndarray, path: str, fps: int = 4) -> None:
    """Writes (B, F, H, W, C) [0, 1] videos as one animated GIF, as the JAX
    package's `save_gif` (training/video/train.py) lays it out: each frame a
    grid of ceil(sqrt(B)) columns of the videos' channel 0, clip(x, 0, 1) *
    255 truncated to uint8; 1000 / fps ms a frame (a frame equal to the one
    before lengthens it instead, as PIL writes it); looping forever. The
    GIF89a bytes are written here (a grey global palette, one LZW image a
    frame), so PIL is not needed."""
    b, f, h, w, _ = videos.shape
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    width, height = cols * w, rows * h
    le16 = lambda v: int(v).to_bytes(2, "little")  # noqa: E731
    out = bytearray(b"GIF89a" + le16(width) + le16(height) + bytes([0xF7, 0, 0]))
    out += np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()  # grey palette
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + le16(0) + b"\x00"  # loop forever
    # (grid, delay in centiseconds); a frame equal to the one before adds
    # its time to it, as PIL's writer does.
    frames = []
    for fi in range(f):
        grid = np.zeros((height, width), dtype=np.uint8)
        for i in range(b):
            r, col = divmod(i, cols)
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = (
                np.clip(videos[i, fi, :, :, 0], 0, 1) * 255).astype(np.uint8)
        if frames and np.array_equal(frames[-1][0], grid):
            frames[-1][1] += int(1000 / fps) // 10
        else:
            frames.append([grid, int(1000 / fps) // 10])
    for grid, delay in frames:
        out += b"\x21\xf9\x04\x00" + le16(delay) + b"\x00\x00"
        out += b"\x2c" + le16(0) + le16(0) + le16(width) + le16(height) + b"\x00\x08"
        data = _lzw(grid.tobytes())
        for k in range(0, len(data), 255):
            out += bytes([len(data[k:k + 255])]) + data[k:k + 255]
        out += b"\x00"
    out += b"\x3b"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(bytes(out))


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

    config = load_yaml(args.config_path)
    model = GaussianDiffusion_DDPM(config, device=args.device)
    step = load_checkpoint(model.score_network(), args.checkpoint)
    print(f"restored checkpoint @ step {step}", flush=True)
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    if args.sampling_scheme_path:
        return sample_long_video(model, config, args, step, generator)
    context = {}
    if is_text_conditional(model):
        context["text_prompts"] = [str(i % 10) for i in range(args.num_samples)]
    samples = model.sample(num_samples=args.num_samples, context=context,
                           num_sampling_steps=args.sampling_steps, generator=generator)
    out = os.path.join(args.output_path, f"video-step{step}.gif")
    save_gif(samples.float().cpu().numpy(), out)
    print(f"wrote {out}", flush=True)
    return samples


def sample_long_video(model, config, args, step: int, generator) -> torch.Tensor:
    """The windows of the scheme at `args.sampling_scheme_path`, each one
    `sample()` call with the frames so far pinned (its context only
    `video_mask` and `x0`, as JAX's CLI builds it); writes
    long-video-step{step}.gif and returns the (B, L, H, W, C) video in
    [0, 1] on the host."""
    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
    from xdiffusion_tpu_torch.utils import normalize_to_neg_one_to_one

    scheme = instantiate_from_config(
        load_yaml(args.sampling_scheme_path).sampling_scheme.to_dict())
    b = args.num_samples
    scheme.set_videos(list(range(b)))
    sn = config.diffusion.score_network.params
    f, s, c = int(sn.input_number_of_frames), int(sn.input_spatial_size), int(sn.input_channels)
    full = np.zeros((b, scheme.video_length, s, s, c), dtype=np.float32)
    for obs_idx, latent_idx, mask in scheme:
        window_frames = sorted(set(obs_idx[0]) | set(latent_idx[0]))
        x0 = normalize_to_neg_one_to_one(np.stack([full[i, window_frames] for i in range(b)]))
        if x0.shape[1] < f:  # pad the window to the model's frames
            pad = f - x0.shape[1]
            x0 = np.concatenate([x0, np.zeros_like(x0[:, :pad])], axis=1)
            mask = np.concatenate([mask, np.ones((b, pad), dtype=bool)], axis=1)
        window_context = dict(video_mask=torch.from_numpy(mask[:, :f]).to(model.device),
                              x0=torch.from_numpy(x0[:, :f]).to(model.device))
        window = model.sample(num_samples=b, context=window_context,
                              num_sampling_steps=args.sampling_steps, generator=generator)
        window = window.float().cpu().numpy()
        for rel, abs_idx in enumerate(window_frames[:f]):
            full[:, abs_idx] = window[:, rel]
        print(f"window done: obs={len(obs_idx[0])} latent={latent_idx[0][:3]}...", flush=True)
    out = os.path.join(args.output_path, f"long-video-step{step}.gif")
    save_gif(full, out)
    print(f"wrote {out} ({scheme.video_length} frames)", flush=True)
    return torch.from_numpy(full)


if __name__ == "__main__":
    main()
