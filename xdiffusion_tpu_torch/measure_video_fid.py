"""CLI: per-frame FID and sampling throughput of a video checkpoint.

    python -m xdiffusion_tpu_torch.measure_video_fid \\
        --config_path configs/video/moving_mnist/video_diffusion_models.yaml \\
        --checkpoint <run dir, checkpoint dir or .pt> --sampling_steps 50

Counterpart of tools/measure_video_fid.py, with its flags and its one JSON
line ({"frame_fid", "fid_floor_real_vs_real", "vids_per_sec", "num_videos",
"frames_per_video", "checkpoint_step", "synthetic_data"}), and `--device`
(CUDA unless `--device cpu`). Restores the checkpoint as measure_fid does,
refuses the synthetic stand-in dataset without `--allow-synthetic` (exit
2), samples `--num_videos` videos in batches of `--sample_batch` with the
config's sampler (`--sampling_steps` of them when given), batch i drawn from
a torch.Generator seeded `seed + i`, and times each batch until its samples
are on the host. The LeNet-feature extractor (eval/fid.py, 500 steps) trains
on the first half of the real frames, drawn as the JAX tool draws them; the
generated frames are scored against the real ones, and the real ones of the
second half give the floor. Returns the JSON line's dict.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

SYNTHETIC_REFUSAL = (
    "refusing to report video FID against the SYNTHETIC stand-in dataset. Fetch real "
    "archives (python tools/fetch_datasets.py) or pass --allow-synthetic for a tagged number.")


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="Per-frame video FID (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--dataset_name", type=str, default="video/moving_mnist")
    p.add_argument("--num_videos", type=int, default=64)
    p.add_argument("--sample_batch", type=int, default=16)
    p.add_argument("--sampling_steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--allow-synthetic", action="store_true")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.eval.fid import compute_fid, train_feature_extractor
    from xdiffusion_tpu_torch.measure_fid import (
        refuse_synthetic,
        restore_sampling_network,
        sample_batches,
    )

    config, model, step = restore_sampling_network(args.config_path, args.checkpoint,
                                                   args.device)
    dataset, _ = load_dataset(args.dataset_name, config=config, split="train")
    synthetic = refuse_synthetic(dataset, args.allow_synthetic, SYNTHETIC_REFUSAL)

    kwargs = {"num_sampling_steps": args.sampling_steps} if args.sampling_steps else {}
    generated, seconds = sample_batches(model, args.num_videos, args.sample_batch, args.seed,
                                        " videos", **kwargs)  # (N, F, S, S, C)
    gen_frames = generated.reshape((-1,) + generated.shape[2:])

    # Real frames and labels for the feature extractor.
    rng = np.random.default_rng(args.seed)
    idx = rng.permutation(len(dataset))[: 2 * args.num_videos]
    real_vids = dataset.videos[idx].astype(np.float32) / 255.0
    real_labels = np.asarray(dataset.labels[idx])
    if real_labels.ndim > 1:
        real_labels = real_labels[:, 0]
    f = min(real_vids.shape[1], generated.shape[1])
    frame_labels = np.repeat(real_labels, f)
    real_frames = real_vids[:, :f].reshape((-1,) + real_vids.shape[2:])

    half = len(real_frames) // 2
    extractor, _ = train_feature_extractor(real_frames[:half], frame_labels[:half], steps=500,
                                           device=model.device)
    n_eval = min(len(gen_frames), half)
    fid = compute_fid(real_frames[:n_eval], gen_frames[:n_eval], extractor=extractor)
    floor = compute_fid(real_frames[:n_eval], real_frames[half:half + n_eval],
                        extractor=extractor)
    info = {
        "frame_fid": round(fid, 3),
        "fid_floor_real_vs_real": round(floor, 3),
        "vids_per_sec": round(args.num_videos / seconds, 3),
        "num_videos": args.num_videos,
        "frames_per_video": int(f),
        "checkpoint_step": int(step),
        "synthetic_data": synthetic,
    }
    print(json.dumps(info), flush=True)
    return info


if __name__ == "__main__":
    main()
