"""Latent diffusion in the port against the JAX package on the CPU:
ltx_video.yaml's LTX transformer over the LTX VAE's latents, cut to a tiny
depth (the transformer at 2 layers, 2 heads of 64, 8 T5 tokens of width 32;
the VAE the JAX tests' 9 x 16 x 16 one with 8 latent channels, so a 3x4x4
latent grid), and a tiny image UNet over the tiny KL VAE's latents.

Against JAX with carried weights: the latent scale (1 / std of the
latents) and the rectified-flow loss, with JAX's posterior draw (its key's
fifth of five) rebuilt and injected, within 1e-5; a 10-step decoded
trajectory with the initial and per-step noise injected, within 1e-4 of its
scale (fp32 sums in other orders carried through 10 network calls and the
decoder, as tests/test_torch_port_ltx.py holds the pixel-space one). Then
the trainers: ltx_video's tiny cut through the video training CLI with
--load_vae_weights_from_checkpoint (a VAE run of the video autoencoder CLI)
and a bit-exact resume that recomputes the same scale; the image trainer's
`vae_checkpoint`; the video sampling CLI refusing a latent config, which
loads no VAE (JAX's fails on the unset scale)."""

import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from test_torch_port_causal_vae import LOSS_3D, tiny_ltx
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_ltx import _no_pretrained_t5  # noqa: F401 (autouse)
from test_torch_port_vae import _metrics, built_once, rel, tiny_kl_config  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LTX_LATENT = os.path.join(REPO, "configs/video/moving_mnist/ltx_video/ltx_video.yaml")


def tiny_latent_ltx() -> dict:
    with open(LTX_LATENT) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["score_network"]["params"].update(
        num_layers=2, num_attention_heads=2, input_channels=8, out_channels=8,
        caption_channels=32, cross_attention_dim=32)
    diff["sampling"]["output_channels"] = 8
    diff["context_preprocessing"][0]["params"].update(max_length=8, embedding_dim=32)
    diff["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    diff["latent_encoder"] = tiny_ltx()
    cfg["data"].update(image_size=16, input_number_of_frames=9)
    return cfg


def build_latent_pair(cfg: dict, seed: int = 12):
    """(JAX process, its score-network params, port process), one seeded
    draw of the score network's and of the VAE's weights carried into both;
    the JAX VAE's params set on its process."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxDDPM(JaxDotConfig(copy.deepcopy(cfg)))
    pmodel = GaussianDiffusion_DDPM(DotConfig(copy.deepcopy(cfg)), device="cpu")
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    flat = {"/".join(k): np.zeros(v.shape, np.float32)
            for k, v in traverse_util.flatten_dict(shapes["params"]).items()}
    drawn = random_flax_params(flat, seed)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    load_flax_params(pmodel.score_network(), drawn)
    vae_shapes = jax.eval_shape(jmodel.latent_encoder().init_params, jax.random.PRNGKey(0))
    vae_flat = {"ae/" + "/".join(k): np.zeros(v.shape, np.float32)
                for k, v in traverse_util.flatten_dict(vae_shapes["ae"]["params"]).items()}
    vae_drawn = random_flax_params(vae_flat, seed + 1)
    jmodel.set_latent_encoder_params({"ae": {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(v) for k, v in vae_drawn.items()})}})
    load_flax_params(pmodel.latent_encoder(), vae_drawn)
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def ltx_latent():
    return build_latent_pair(tiny_latent_ltx())


def _clips(b: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(b, 9, 16, 16, 1)).astype(np.float32)


def test_latent_scale_and_loss_against_jax(ltx_latent):
    """compute_latent_scale with JAX's draw, then loss_on_batch at given
    times and noise with the posterior draw of JAX's rng_enc injected (the
    VAE frozen: no gradient reaches it, the transformer's do)."""
    jmodel, params, pmodel = ltx_latent
    x = _clips()
    key = jax.random.PRNGKey(8)
    noise = np.asarray(jax.random.normal(key, (2, 3, 4, 4, 8)))
    scale = pmodel.compute_latent_scale(torch.from_numpy(x), noise=torch.from_numpy(noise))
    # JAX's scale of the same latents, without compiling its encoder again:
    # the port's encoding is held against JAX's in test_torch_port_causal_vae.py
    # and, through the loss below, here.
    latents = jnp.asarray(pmodel.latent_encoder().encode_to_latents(
        torch.from_numpy(x), noise=torch.from_numpy(noise)).numpy())
    jmodel.latent_encoder().encode_to_latents = lambda params, images, rng: latents
    try:
        want_scale = jmodel.compute_latent_scale(jnp.asarray(x), key)
    finally:
        del jmodel.latent_encoder().encode_to_latents
    assert rel(scale, want_scale) <= 1e-5
    pmodel.set_latent_scale(want_scale)
    rng = np.random.default_rng(3)
    ctx = {"text_embeddings": rng.standard_normal((2, 8, 32)).astype(np.float32)}
    times = np.array([0.2, 0.7], dtype=np.float32)
    eps = rng.standard_normal((2, 3, 4, 4, 8)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    enc = np.asarray(jax.random.normal(jax.random.split(key, 5)[4], (2, 3, 4, 4, 8)))
    # The arrays are arguments: closed over, XLA folds the VAE over them.
    want, wm = jax.jit(lambda p, k, xx, c, tt, e: jmodel.loss_on_batch(
        p, k, xx, c, timesteps=tt, noise=e, deterministic=True))(
        params, key, jnp.asarray(x), {k: jnp.asarray(v) for k, v in ctx.items()},
        jnp.asarray(times), jnp.asarray(eps))
    got, metrics = pmodel.loss_on_batch(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in ctx.items()},
        timesteps=torch.from_numpy(times), noise=torch.from_numpy(eps), deterministic=True,
        latent_noise=torch.from_numpy(enc))
    assert rel(got.item(), want) <= 1e-5
    assert rel(metrics["loss_per_example"].numpy(), wm["loss_per_example"]) <= 1e-5
    got.backward()
    assert all(p.grad is None for p in pmodel.latent_encoder().parameters())
    assert any(p.grad is not None and p.grad.abs().max() > 0
               for p in pmodel.score_network().parameters())


def test_decoded_trajectory_against_jax(ltx_latent):
    """10 rectified-flow steps with prompts, injected initial and per-step
    noise, divided by the scale and decoded to (2, 9, 16, 16, 1) in [0, 1]
    space (x * 0.5 + 0.5 of the decoder's output, as JAX maps it)."""
    jmodel, params, pmodel = ltx_latent
    jmodel.set_latent_scale(0.8)
    pmodel.set_latent_scale(0.8)
    rng = np.random.default_rng(9)
    init = rng.standard_normal((2, 3, 4, 4, 8)).astype(np.float32)
    noise = rng.standard_normal((10, 2, 3, 4, 4, 8)).astype(np.float32)
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=2, num_sampling_steps=10,
        initial_noise=jnp.asarray(init),
        context={"text_prompts": ["0", "1"], "sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=2, num_sampling_steps=10, initial_noise=torch.from_numpy(init),
                        context={"text_prompts": ["0", "1"],
                                 "sampling_noise": torch.from_numpy(noise)})
    assert got.shape == (2, 9, 16, 16, 1) and want.shape == got.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * max(1.0, np.abs(want).max()),
                               rtol=0)


def _write(tmp_path, name: str, cfg: dict) -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _scales(text: str):
    return re.findall(r"latent scale factor: (\S+)", text)


def test_latent_ltx_trains_from_a_vae_run_and_resumes(tmp_path, monkeypatch, capsys, built_once):
    """The tiny latent LTX through the video training CLI from a one-step
    run of the video autoencoder CLI (its VAE block the latent encoder's):
    the VAE's weights load, the scale comes from the stream's first batch,
    3 steps at batch 2 on 9-frame 16x16 clips (the data block's, the
    VAE's input: a 3x4x4 latent grid), decoded strips; a resume from step 2
    recomputes the same scale and repeats step 2's loss bit for bit; the
    sampling CLI, which loads no VAE, refuses the config as JAX's fails."""
    from xdiffusion_tpu_torch import sample_video, train_video, train_video_autoencoder

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    vae_cfg = tiny_ltx(loss_config=LOSS_3D)
    vae_file = _write(tmp_path, "vae.yaml", {"autoencoder": vae_cfg, "data": {
        "image_size": 16, "num_channels": 1, "input_number_of_frames": 9}})
    vae_run = train_video_autoencoder.main([
        "--config_path", vae_file, "--batch_size", "2", "--num_training_steps", "1",
        "--device", "cpu", "--output_path", str(tmp_path / "vae")])
    config = _write(tmp_path, "ltx_latent.yaml", tiny_latent_ltx())
    common = ["--config_path", config, "--batch_size", "2", "--device", "cpu",
              "--save_and_sample_every_n", "2", "--sampling_steps", "2", "--num_samples", "2",
              "--load_vae_weights_from_checkpoint", vae_run]
    capsys.readouterr()
    run = train_video.main(common + ["--num_training_steps", "3",
                                     "--output_path", str(tmp_path / "run")])
    first = capsys.readouterr().out
    assert f"loaded frozen VAE from {vae_run}" in first and len(_scales(first)) == 1
    metrics = _metrics(run)
    assert sorted(metrics) == [0, 2] and all(np.isfinite(m["loss"]) for m in metrics.values())
    from PIL import Image

    strip = np.asarray(Image.open(os.path.join(run, "sample-3.png")))
    assert strip.shape == (2 * 16, 9 * 16)  # a row per video of its 9 decoded frames
    resumed = train_video.main(common + [
        "--num_training_steps", "3", "--output_path", str(tmp_path / "resumed"),
        "--resume_from", os.path.join(run, "checkpoints", "2.pt")])
    assert _scales(capsys.readouterr().out) == _scales(first)
    assert _metrics(resumed)[2]["loss"] == metrics[2]["loss"]
    with pytest.raises(ValueError, match="latent scale"):
        sample_video.main(["--config_path", config, "--checkpoint",
                           os.path.join(run, "checkpoints", "3.pt"), "--num_samples", "1",
                           "--sampling_steps", "1", "--device", "cpu",
                           "--output_path", str(tmp_path / "samples")])


def test_image_trainer_vae_checkpoint(tmp_path, monkeypatch, capsys, built_once):
    """The image trainer's `vae_checkpoint` (an argument of `train()`, as in
    JAX, whose CLI has no flag for it): the JAX tests' tiny UNet over the
    tiny KL VAE's 8x8x4 latents, the VAE from a one-step run of the image
    autoencoder CLI; 2 steps, a decoded 16x16 grid."""
    from test_diffusion import tiny_config

    from xdiffusion_tpu_torch import train_autoencoder
    from xdiffusion_tpu_torch.training.image.train import train

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    vae_file = _write(tmp_path, "kl.yaml", {"autoencoder": tiny_kl_config(),
                                            "data": {"image_size": 16, "num_channels": 1}})
    vae_run = train_autoencoder.main(["--config_path", vae_file, "--batch_size", "2",
                                      "--num_training_steps", "1", "--device", "cpu",
                                      "--output_path", str(tmp_path / "vae")])
    cfg = copy.deepcopy(tiny_config().to_dict())
    sn = cfg["diffusion"]["score_network"]["params"]
    sn.update(input_channels=4, output_channels=4)
    cfg["diffusion"]["sampling"].update(output_channels=4, output_spatial_size=8)
    cfg["diffusion"]["latent_encoder"] = tiny_kl_config()
    cfg["data"] = {"image_size": 16, "num_channels": 1}
    capsys.readouterr()
    run = train(_write(tmp_path, "latent.yaml", cfg), num_training_steps=2, batch_size=2,
                device="cpu", num_samples=4, vae_checkpoint=vae_run,
                output_path=str(tmp_path / "run"))
    out = capsys.readouterr().out
    assert f"loaded frozen VAE from {vae_run}" in out and len(_scales(out)) == 1
    assert all(np.isfinite(m["loss"]) for m in _metrics(run).values())
    from PIL import Image

    assert np.asarray(Image.open(os.path.join(run, "sample-2.png"))).shape == (32, 32)


def test_hunyuan_video_fails_only_at_its_score_network():
    """hunyuan_video.yaml's latent encoder (the Hunyuan VAE) builds in the
    port, and since its score network is ported (score_networks/
    hunyuan_video.py, tests/test_torch_port_hunyuan.py) the process builds
    whole: nothing of the config fails any more. A latent process over the
    VAE's 4 channels of the 17-frame 32x32 clips, 9 x 8 x 8 (time ratio 2,
    space 4): the network's input."""
    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    cfg = load_yaml(os.path.join(REPO, "configs/video/moving_mnist/hunyuan_video/hunyuan_video.yaml"))
    vae = instantiate_from_config(cfg.diffusion.latent_encoder.to_dict(), use_config_struct=True,
                                  device="cpu")
    assert type(vae).__name__ == "HunyuanCausal3DVAE"
    model = GaussianDiffusion_DDPM(cfg, device="cpu")
    assert type(model.score_network()).__name__ == "HYVideoDiffusionTransformer"
    assert type(model.latent_encoder()).__name__ == "HunyuanCausal3DVAE"
    assert tuple(model.sampling_shape(2)) == (2, 9, 8, 8, 4)
