"""CLI: a PyTorch-reference checkpoint into a port checkpoint.

    python -m xdiffusion_tpu_torch.import_torch_checkpoint \\
        --config_path configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml \\
        --torch_checkpoint reference.pt --output output/imported/ddpm_32x32

Counterpart of tools/import_torch_checkpoint.py. Reads a torch state dict
(`.pt` / `.pth`: a bare state dict, the reference trainer's
{"model_state_dict": ...} or a nested {"state_dict": ...}, DDP's "module."
prefixes stripped; `.safetensors` through the port's own reader, F32, F16
and BF16), maps it through the importer of the config's
`diffusion.score_network.target` (importers/torch_state_dict.py) and writes
`<output>/<step>.pt`: the parameters, a fresh optimizer state of the
config's optimizer and an EMA equal to the parameters. The sampling CLI,
the trainer's `--resume_from` and `measure_fid` read it. `--component vae`
imports the config's `autoencoder` (or `diffusion.latent_encoder`) instead
(importers/autoencoders.py) and writes the checkpoint the VAE trainers
restore and `--vae_checkpoint` / `--autoencoder_checkpoint` read. Prints one
JSON line; `flax_param_leaves` counts the port's parameters. Runs on CUDA
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import torch


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a `.safetensors` file (the port's reader) or a
    torch checkpoint (`importers.torch_state_dict.load_torch_checkpoint`)."""
    if path.endswith(".safetensors"):
        from xdiffusion_tpu_torch.importers.safetensors_io import load_safetensors

        return load_safetensors(path)
    from xdiffusion_tpu_torch.importers.torch_state_dict import load_torch_checkpoint

    return load_torch_checkpoint(path)


def import_vae(args) -> Dict:
    """The config's autoencoder from the state dict, written as the VAE
    trainers' checkpoint (training/image/autoencoder.py)."""
    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
    from xdiffusion_tpu_torch.importers.autoencoders import (
        import_autoencoder_kl_params,
        import_hunyuan_vae_params,
        import_ltx_vae_params,
    )
    from xdiffusion_tpu_torch.training.image.autoencoder import (
        create_vae_train_state,
        save_vae_checkpoint,
    )

    config = load_yaml(args.config_path)
    vae_cfg = config.autoencoder if "autoencoder" in config else config.diffusion.latent_encoder
    vae = instantiate_from_config(vae_cfg.to_dict(), use_config_struct=True, device=args.device)
    sd = load_torch_state_dict(args.torch_checkpoint)
    target = vae_cfg.target.lower()
    if "ltx" in target or "causalvideo" in target:
        fn = import_ltx_vae_params
    elif "hunyuan" in target:
        fn = import_hunyuan_vae_params
    else:
        fn = import_autoencoder_kl_params
    fn(vae.ae, sd, strict=not args.non_strict)
    if vae.disc is not None:
        save_vae_checkpoint(args.output, create_vae_train_state(vae), args.step)
    else:  # no loss module (a frozen latent encoder's config): the parameters alone
        checkpoints.write_payload(args.output, args.step, {"params": vae.state_dict()})
    return {
        "component": "vae",
        "importer": fn.__name__,
        "imported_torch_tensors": len(sd),
        "output": os.path.abspath(args.output),
        "step": args.step,
    }


def import_score_network(args) -> Dict:
    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.importers.torch_state_dict import import_score_network_params
    from xdiffusion_tpu_torch.train_step import create_train_state
    from xdiffusion_tpu_torch.training.image.train import build_model, build_optimizer

    config = load_yaml(args.config_path)
    model = build_model(config, device=args.device)
    net = model.score_network()
    sd = load_torch_state_dict(args.torch_checkpoint)
    import_score_network_params(config, net, sd, strict=not args.non_strict)
    state = create_train_state(model, build_optimizer(config, net.parameters()), ema=True)
    checkpoints.save_checkpoint(args.output, state, args.step)
    return {
        "imported_torch_tensors": len(sd),
        "flax_param_leaves": len(list(net.parameters())),
        "output": os.path.abspath(args.output),
        "step": args.step,
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="Import a PyTorch-reference checkpoint "
                                            "(PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--torch_checkpoint", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--step", type=int, default=0,
                   help="step number to record in the checkpoint")
    p.add_argument("--non_strict", action="store_true",
                   help="allow unmapped torch keys (e.g. partial/EMA dumps)")
    p.add_argument(
        "--component", choices=["score_network", "vae"], default="score_network",
        help="score_network: the config's diffusion.score_network; vae: the config's "
             "autoencoder (VAE-trainer config) or diffusion.latent_encoder (latent-diffusion "
             "config), written as the VAE trainers' checkpoint")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    info = import_vae(args) if args.component == "vae" else import_score_network(args)
    print(json.dumps(info), flush=True)
    return info


if __name__ == "__main__":
    main()
