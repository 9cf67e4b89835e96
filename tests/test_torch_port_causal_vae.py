"""The causal video VAEs of the port against the JAX package on the CPU:
LTX-Video's (ltx_vae.py), HunyuanVideo's with and without tiling
(hunyuan.py), the shared plan-driven ones (causal_video.py), OpenSora's
scale and shift, the video autoencoder CLI with a resume and the
reconstruct CLI on a video dataset.

Tiny configs (the JAX tests' 9 x 16 x 16 clips) carry one seeded set of
weights into both packages (test_torch_port_vae.build_pair); the
posterior's draws are JAX's, rebuilt from its keys and injected. Stated
tolerances: fp32 outputs and moments within 1e-5 of the reference's largest
magnitude, losses and logs within 1e-5, gradient leaves within 1e-4
(`check_grads`). The Hunyuan GroupNorms (one to four channels a group over
all frames) run K3's plain version on the whole (B, F*H*W, C) map."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_vae import _metrics, build_pair, built_once, check_objective, rel, t  # noqa: F401

LOSS_3D = {"target": "xdiffusion.autoencoders.losses.LPIPSWithDiscriminator",
           "params": {"rec_loss": "l2", "kl_weight": 1e-6, "disc_start": 0, "disc_weight": 0.05,
                      "disc_in_channels": 1, "disc_num_layers": 2, "use_3d": True}}


def tiny_ltx(**overrides) -> dict:
    """The JAX tests' tiny LTX VAE (9 frames of 16x16, pixel norm, uniform
    log-variance, no quant convs)."""
    params = {"dims": 3, "in_channels": 1, "out_channels": 1, "input_number_of_frames": 9,
              "latent_channels": 8,
              "encoder_blocks": [["res_x", 1], ["compress_all", 1], ["res_x", 1],
                                 ["compress_all", 1]],
              "decoder_blocks": [["res_x", 1], ["compress_all", 1], ["res_x", 1],
                                 ["compress_all", 1]],
              "scaling_factor": 1.0, "norm_layer": "pixel_norm", "latent_log_var": "uniform",
              "use_quant_conv": False}
    params.update(overrides)
    return {"target": "xdiffusion.autoencoders.ltx_vae.CausalVideoAutoencoder",
            "params": params}


def tiny_hunyuan(target: str = "xdiffusion.autoencoders.hunyuan.HunyuanCausal3DVAE",
                 **overrides) -> dict:
    params = {"in_channels": 1, "out_channels": 1, "block_out_channels": [16, 32, 32],
              "latent_channels": 4, "layers_per_block": 1, "sample_size": 16,
              "sample_tsize": 9, "time_compression_ratio": 2, "spatial_compression_ratio": 4,
              "latent_logvar": "per_channel"}
    params.update(overrides)
    return {"target": target, "params": params}


def clip(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def check_forward(cfg: dict, shape, seed: int = 3) -> None:
    """Moments; latents with JAX's posterior draw (its posterior of the JAX
    moments, or for OpenSora its whole encode_to_latents with the scale and
    shift); decode_from_latents."""
    from xdiffusion_tpu.autoencoders.causal_video import _moments_to_distribution

    jvae, params, vae, _ = build_pair(cfg, seed)
    x = clip(shape, 1)
    method = type(jvae.module).encode_moments
    want = jax.jit(lambda p, xx: jvae.module.apply(p, xx, method=method))(
        params["ae"], jnp.asarray(getattr(jvae, "_fit_frames", lambda v: v)(jnp.asarray(x))))
    got = vae.encode_moments(vae.fit_inputs(t(x))).detach()
    assert rel(got, want) <= 1e-5
    key = jax.random.PRNGKey(4)
    if hasattr(jvae, "scale_factor"):
        z_want = jax.jit(jvae.encode_to_latents)(params, jnp.asarray(x), key)
    else:
        z_want = _moments_to_distribution(want, vae.latent_channels).sample(key)
    z = vae.encode_to_latents(t(x), noise=t(jax.random.normal(key, z_want.shape)))
    assert rel(z, z_want) <= 1e-5
    assert rel(vae.decode_from_latents(z).detach(),
               jax.jit(jvae.decode_from_latents)(params, z_want)) <= 1e-5


def test_ltx_vae_objective_and_gradients_against_jax():
    """The tiny LTX VAE (frames tiled from 7 to its 9) under the 3-D PatchGAN
    loss with the wavelet term and the adaptive weight, both phases, every
    gradient of the phase's group (the perceptual term on video:
    test_torch_port_vae.py)."""
    loss = copy.deepcopy(LOSS_3D)
    loss["params"].update(wavelet_loss_weight=0.1)
    jvae, params, vae, drawn = build_pair(tiny_ltx(loss_config=loss), seed=8)
    x = clip((1, 7, 16, 16, 1), 2)
    rng = jax.random.PRNGKey(6)
    noise = jax.random.normal(jax.random.split(rng, 4)[0], (1, 3, 4, 4, 8))
    check_objective(jvae, params, vae, drawn, x, noise, rng)


@pytest.mark.parametrize("variant", ["group_norm_blocks", "dual_conv_layer_norm"])
def test_ltx_vae_options_against_jax(variant):
    """The options no shipped config sets, forward only: GroupNorm (K3) with
    res_x_y (the LayerNorm shortcut), compress_space / compress_time /
    compress_all_x_y, the mid block's attention (K5), per-channel moments
    with quant convs, a causal decoder, 2x2 patches; and dims (2, 1)
    (DualConv3d, its unpadded compress and upsample convs) with LayerNorm."""
    if variant == "group_norm_blocks":
        cfg = tiny_ltx(
            norm_layer="group_norm", latent_log_var="per_channel", use_quant_conv=True,
            patch_size=2, causal_decoder=True, latent_channels=4,
            encoder_blocks=[["res_x_y", {"multiplier": 2}], ["compress_space", 1],
                            ["compress_time", 1], ["compress_all_x_y", {"multiplier": 2}]],
            decoder_blocks=[["attn_res_x", {"num_layers": 1, "attention_head_dim": 32}],
                            ["res_x_y", {"multiplier": 2}], ["compress_time", 1],
                            ["compress_space", 1],
                            ["compress_all", {"multiplier": 2, "residual": True}]])
        shape = (1, 9, 16, 16, 1)
    else:
        cfg = tiny_ltx(dims=[2, 1], norm_layer="layer_norm", latent_log_var="none",
                       use_quant_conv=True,
                       encoder_blocks=[["res_x", 1], ["compress_all", 1]],
                       decoder_blocks=[["res_x", 1]])
        shape = (1, 9, 16, 16, 1)
    check_forward(cfg, shape)


def test_ltx_vae_refuses_what_is_not_ported():
    from xdiffusion_tpu_torch.config import instantiate_from_config

    for cfg in (tiny_ltx(timestep_conditioning=True),
                tiny_ltx(decoder_blocks=[["res_x", {"num_layers": 1, "inject_noise": True}]])):
        with pytest.raises(NotImplementedError):
            instantiate_from_config(cfg, use_config_struct=True, device="cpu")


def test_hunyuan_vae_objective_and_gradients_against_jax():
    """A two-level Hunyuan VAE as the shipped configs train it (3-D
    PatchGAN, L2, no adaptive weight), both phases; its GroupNorms at 32
    channels in 32 groups (one channel a group, over all frames) and its
    frame-causal mid attention."""
    loss = copy.deepcopy(LOSS_3D)
    loss["params"]["use_adaptive_adversarial_weight"] = False
    cfg = tiny_hunyuan(loss_config=loss, block_out_channels=[32, 32],
                       spatial_compression_ratio=2)
    jvae, params, vae, drawn = build_pair(cfg, seed=9)
    x = clip((1, 9, 16, 16, 1), 3)
    rng = jax.random.PRNGKey(7)
    noise = jax.random.normal(rng, (1, 5, 8, 8, 4))
    check_objective(jvae, params, vae, drawn, x, noise, rng)


def test_hunyuan_vae_tiled_encode_decode_against_jax():
    """Spatial and temporal tiling (a two-level VAE of 8 channels; 10x10
    clips against 8x8 tiles, 7 frames against 5-frame windows: three windows
    of 2x2 tiles to encode, 2x2 to decode, blended), with the uniform
    log-variance: the port's tiled
    encode_to_latents and decode_from_latents against JAX's tiling code run
    on the port's own per-tile outputs (each tile's network is held against
    JAX by the other tests here), so what is compared is the windows, the
    blends, the cuts and the posterior draw; 1e-6."""
    import types

    cfg = tiny_hunyuan(latent_logvar="uniform", block_out_channels=[8, 8],
                       spatial_compression_ratio=2, sample_size=8, sample_tsize=5)
    jvae, params, vae, _ = build_pair(cfg, seed=4)
    jvae.enable_tiling(spatial=True, temporal=True)
    vae.enable_tiling(spatial=True, temporal=True)
    tiles = []

    def port_tile(ae_params, tile, method):
        fn = vae.ae.encode_moments if method.__name__ == "encode_moments" else vae.ae.decode
        tiles.append(method.__name__)
        with torch.no_grad():
            return jnp.asarray(fn(t(tile)).numpy())

    jvae.module = types.SimpleNamespace(apply=port_tile)
    x = clip((1, 7, 10, 10, 1), 5)
    key = jax.random.PRNGKey(1)
    z_want = jvae.encode_to_latents(params, jnp.asarray(x), key)
    z = vae.encode_to_latents(t(x), noise=t(jax.random.normal(key, z_want.shape)))
    # (T - 1) // 4 + 1 latent frames whatever the time ratio (2 here), as
    # JAX cuts them (hunyuan.py:558): ROADMAP queue 3.
    assert z.shape == z_want.shape == (1, 2, 5, 5, 4) and rel(z, z_want) <= 1e-6
    assert rel(vae.decode_from_latents(z).detach(), jvae.decode_from_latents(params, z_want)) <= 1e-6
    assert tiles.count("encode_moments") == 12 and tiles.count("decode") == 4


@pytest.mark.parametrize("variant", ["ltx_vocabulary", "hunyuan_surface", "opensora"])
def test_shared_causal_vaes_and_opensora_against_jax(variant):
    """causal_video.py's two surfaces (GroupNorm and pixel norm, ceil-padded
    strided time) and OpenSora's AutoencoderKLCausal3D with its scale and
    shift in encode and decode."""
    if variant == "ltx_vocabulary":
        cfg = {"target": "xdiffusion.autoencoders.causal_video.CausalVideoAutoencoder",
               "params": {"in_channels": 1, "out_channels": 1, "latent_channels": 4,
                          "input_number_of_frames": 5, "norm_layer": "pixel_norm",
                          "encoder_blocks": [["res_x_y", 1], ["compress_all", 1]],
                          "decoder_blocks": [["res_x", 1], ["compress_all", 1]]}}
        shape = (1, 6, 8, 8, 1)
    elif variant == "hunyuan_surface":
        cfg = tiny_hunyuan("xdiffusion.autoencoders.causal_video.HunyuanCausal3DVAE",
                           block_out_channels=[64, 64])
        shape = (1, 5, 8, 8, 1)
    else:
        cfg = tiny_hunyuan(
            "xdiffusion.autoencoders.opensora.hunyuan.autoencoder_kl_causal_3d."
            "AutoencoderKLCausal3D", scale_factor=0.7, shift_factor=0.2,
            block_out_channels=[16, 16], spatial_compression_ratio=2)
        del cfg["params"]["latent_logvar"]
        shape = (1, 9, 16, 16, 1)
    check_forward(cfg, shape)


def _tiny_vae_file(tmp_path, cfg: dict, frames: int) -> str:
    path = tmp_path / "vae_tiny.yaml"
    path.write_text(yaml.safe_dump({"autoencoder": cfg, "data": {
        "image_size": 16, "num_channels": 1, "input_number_of_frames": frames}}))
    return str(path)


def test_video_autoencoder_cli_resume_and_reconstruct(tmp_path, monkeypatch, built_once):
    """The video VAE CLI on the synthetic Moving-MNIST (16 frames of 16x16;
    the tiny LTX VAE takes 9), batch 2: 3 steps, checkpoints at 2 and 3, a
    resume from 2 repeating step 2's losses bit for bit; the reconstruct CLI
    on the run's checkpoint over video clips."""
    from xdiffusion_tpu_torch import reconstruct, train_video_autoencoder

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = _tiny_vae_file(tmp_path, tiny_ltx(loss_config=LOSS_3D), 9)
    common = ["--config_path", config, "--batch_size", "2", "--device", "cpu",
              "--save_and_sample_every_n", "2", "--learning_rate", "1e-3"]
    run = train_video_autoencoder.main(common + ["--num_training_steps", "3",
                                                 "--output_path", str(tmp_path / "run")])
    metrics = _metrics(run)
    assert sorted(metrics) == [0, 2] and set(metrics[2]) == {"step", "time", "total_loss",
                                                             "kl_loss"}
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2.pt", "3.pt"]
    assert os.path.exists(os.path.join(run, "recon-3.png"))
    resumed = train_video_autoencoder.main(common + [
        "--num_training_steps", "3", "--output_path", str(tmp_path / "resumed"),
        "--resume_from", os.path.join(run, "checkpoints", "2.pt")])
    assert _metrics(resumed)[2]["total_loss"] == metrics[2]["total_loss"]
    inputs, recon, mse = reconstruct.main([
        "--config_path", config, "--autoencoder_checkpoint", run, "--num_samples", "2",
        "--dataset_name", "video/moving_mnist", "--device", "cpu",
        "--output_path", str(tmp_path / "recon")])
    assert inputs.shape == recon.shape == (2, 9, 16, 16, 1) and np.isfinite(mse)
    assert torch.isfinite(recon).all()


# K3's sites in the Hunyuan and OpenSora VAEs' forward at the video CLI's
# batch 4 (17 frames of 32x32; read by hooks on the card, chip_smoke.py
# phase 62): (B, F*H*W, C), 32 groups, so 1, 2 and 4 channels a group.
HUNYUAN_K3_SITES = [(4, 17 * 32 * 32, 32), (4, 17 * 16 * 16, 32), (4, 17 * 16 * 16, 64),
                    (4, 9 * 16 * 16, 64), (4, 9 * 8 * 8, 128), (4, 5 * 4 * 4, 128),
                    (4, 17 * 32 * 32, 64)]


@pytest.mark.parametrize("b,hw,c", HUNYUAN_K3_SITES, ids=[f"{b}x{hw}x{c}"
                                                          for b, hw, c in HUNYUAN_K3_SITES])
def test_gn_plan_takes_the_5d_video_vae_sites(b, hw, c):
    """gn_plan plans each 5-D site as one (B, F*H*W, C) problem: every row
    covered once per cluster, shared memory within the H100's (the largest
    slab, 2.2 MB, streams)."""
    from test_torch_port_gn_plan import _check_plan

    from xdiffusion_tpu_torch.ops import group_norm as gn

    for dtype in (torch.float32, torch.bfloat16):
        _check_plan(gn.gn_plan(b, hw, c, 32, dtype), b, hw, c, 32, dtype)


def test_k3_emulation_at_one_channel_a_group_on_a_5d_map():
    """The kernel's reduction order (tests/test_torch_port_gn_plan.py's
    emulation, on the plan of a 4-block cluster) at 32 channels in 32 groups
    over all 5 frames of a (2, 5, 8, 8, 32) map, against the plain version
    (K3's CPU path) and the JAX package's group norm, 2e-5; the 5-D plain
    version equals the (B, F*H*W, C) view's bit for bit."""
    from test_torch_port_gn_plan import ATOL, _emulate
    from xdiffusion_tpu.ops.group_norm import _xla_group_norm_silu

    from xdiffusion_tpu_torch.ops import group_norm as gn

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 8, 8, 32)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    plan = gn.gn_plan(2, 320, 32, 32, torch.float32, sms=4)
    assert plan.k == 2 or plan.k == 4
    plain = gn.group_norm_silu_plain(t(x), t(scale), t(bias), 32, 1e-6, True)
    flat = gn.group_norm_silu_plain(t(x).reshape(2, 320, 32), t(scale), t(bias), 32, 1e-6, True)
    assert torch.equal(plain.reshape(2, 320, 32), flat)
    emulated = _emulate(t(x), t(scale), t(bias), 32, 1e-6, True, plan)
    want = np.asarray(_xla_group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                           32, 1e-6, True))
    np.testing.assert_allclose(emulated.numpy(), want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=ATOL)
