"""CLI: FID of a trained checkpoint against the training distribution.

    python -m xdiffusion_tpu_torch.measure_fid \\
        --config_path configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml \\
        --checkpoint <run dir, checkpoint dir or .pt> --num_samples 2048

Counterpart of tools/measure_fid.py, with its flags and its one JSON line,
and `--device` (CUDA unless `--device cpu`). Builds the config's process
(`build_model`), restores the checkpoint's EMA parameters when it tracks
them, else its parameters (`weights.load_checkpoint`; `--use_ema` is taken,
as there), samples `--num_samples` images in batches of `--sample_batch`
with DDIM over `--sampling_steps`, batch i drawn from a torch.Generator
seeded `seed + i` (the JAX tool: PRNGKey(seed + i)), and scores them with
the LeNet-feature FID (eval/fid.py) against 2N real images drawn as the JAX
tool draws them: the first N score the samples, the other N give the
real-against-real floor. One extractor (500 steps on the first N) serves
both, as the JAX tool's two identically seeded trainings give one. On the
synthetic stand-in dataset without `--allow-synthetic` it prints the JAX
tool's refusal and exits 2, before it samples. Returns the JSON line's dict.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

SYNTHETIC_REFUSAL = (
    "refusing to report FID against the SYNTHETIC stand-in dataset. Fetch real archives "
    "(python tools/fetch_datasets.py) or pass --allow-synthetic to get a clearly-tagged "
    "synthetic-data number.")


def sample_batches(model, num_samples: int, sample_batch: int, seed: int, announce: str,
                   **kwargs):
    """(samples as float32 numpy, seconds from the first batch's start to the
    last batch's copy to the host): batch i of at most `sample_batch` drawn
    from a generator on the model's device seeded `seed + i`."""
    import time

    import numpy as np
    import torch

    out, n_done, i, seconds = [], 0, 0, 0.0
    while n_done < num_samples:
        b = min(sample_batch, num_samples - n_done)
        t0 = time.perf_counter()
        generator = torch.Generator(device=model.device).manual_seed(seed + i)
        batch = model.sample(num_samples=b, generator=generator, **kwargs)
        out.append(batch.float().cpu().numpy())  # the copy ends the timed span
        seconds += time.perf_counter() - t0
        n_done += b
        i += 1
        print(f"sampled {n_done}/{num_samples}{announce}", flush=True)
    return np.concatenate(out, axis=0), seconds


def restore_sampling_network(config_path: str, checkpoint: str, device):
    """(config, process, step) with the checkpoint restored into the network
    the process samples."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model
    from xdiffusion_tpu_torch.weights import load_checkpoint

    config = load_yaml(config_path)
    model = build_model(config, device=device)
    network = getattr(model, "sampling_network", model.score_network)()
    step = load_checkpoint(network, checkpoint)
    print(f"restored step {step}", flush=True)
    return config, model, step


def refuse_synthetic(dataset, allow: bool, message: str) -> bool:
    """Whether the dataset is the synthetic stand-in; prints `message` as
    the JSON line and exits 2 when it is and `allow` is not given."""
    synthetic = bool(getattr(dataset, "synthetic", False))
    if synthetic and not allow:
        print(json.dumps({"error": message}), flush=True)
        sys.exit(2)
    return synthetic


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="Measure FID for a checkpoint (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--dataset_name", type=str, default="image/mnist")
    p.add_argument("--num_samples", type=int, default=2048)
    p.add_argument("--sampling_steps", type=int, default=50)
    p.add_argument("--sample_batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action="store_true", default=True)
    p.add_argument(
        "--allow-synthetic", action="store_true",
        help="permit FID against the synthetic stand-in dataset (the number is then NOT "
             "comparable to real-data FID; it is tagged synthetic_data=true in the output)")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.eval.fid import compute_fid, train_feature_extractor
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

    config, model, step = restore_sampling_network(args.config_path, args.checkpoint,
                                                   args.device)
    dataset, _ = load_dataset(args.dataset_name, config=config, split="train")
    synthetic = refuse_synthetic(dataset, args.allow_synthetic, SYNTHETIC_REFUSAL)

    generated, _ = sample_batches(model, args.num_samples, args.sample_batch, args.seed, "",
                                  num_sampling_steps=args.sampling_steps,
                                  sampler=DDIMSampler())

    rng = np.random.default_rng(args.seed)
    idx = rng.permutation(len(dataset))[: 2 * args.num_samples]
    real = np.stack([np.asarray(dataset[int(j)][0]) for j in idx])
    if real.ndim == 3:
        real = real[..., None]
    labels = np.asarray([dataset[int(j)][1] for j in idx])
    real_fid, real_holdout = real[: args.num_samples], real[args.num_samples:]

    extractor, _ = train_feature_extractor(real_fid, labels[: args.num_samples], steps=500,
                                           device=model.device)
    fid = compute_fid(real_fid, generated, extractor=extractor)
    floor = compute_fid(real_fid, real_holdout, extractor=extractor)
    info = {
        "fid": round(fid, 3),
        "fid_floor_real_vs_real": round(floor, 3),
        "num_samples": args.num_samples,
        "sampling_steps": args.sampling_steps,
        "checkpoint_step": int(step),
        "synthetic_data": synthetic,
    }
    print(json.dumps(info), flush=True)
    return info


if __name__ == "__main__":
    main()
