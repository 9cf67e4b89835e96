"""HunyuanVideo in the port against the JAX package on the CPU.

The token refiner with and without a text mask (the masked einsums with
the first column forced open, or K5's plain version); the `RopeFrequencies`
head and the hash text encoders bit for bit; hunyuan_video.yaml cut to one
double and two single blocks at hidden 128 (2 heads of 64, the shipped
rope_dim_list), 8 hash-T5 tokens of width 32 and a pooled hash CLIP of
width 16, over a two-level Hunyuan VAE's latents (9 frames of 16x16 ->
5 x 8 x 8 x 4, a 5x4x4 token grid): the forward with and without a text
mask, with the reference's context keys and with precomputed rotary tables;
the latent loss with JAX's posterior draw injected and every gradient
against jitted `jax.value_and_grad`; a 10-step decoded trajectory with
injected noise; the config at full width with JAX's parameter count; the
tiny config through the video training CLI from a run of the video
autoencoder CLI (its frozen VAE), and the sampling CLI's refusal of a
latent config. Weights are drawn from a numpy seed and cross through the
bridge (weights.py)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_causal_vae import LOSS_3D, tiny_hunyuan
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import GRAD_TOL, _flat, _grad_errors, _tree
from test_torch_port_latent import build_latent_pair
from test_torch_port_mmdit import offline
from test_torch_port_sora import PROMPTS, check_full_width, contexts, to_jax, to_torch
from test_torch_port_vae import built_once, rel  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUNYUAN = os.path.join(REPO, "configs/video/moving_mnist/hunyuan_video/hunyuan_video.yaml")


def tiny_hunyuan_video() -> dict:
    """hunyuan_video.yaml at one double and two single blocks, hidden 128 (2
    heads of 64), 8 T5 tokens of width 32, a pooled CLIP of width 16, over a
    two-level Hunyuan VAE of 8 channels (9 frames of 16x16 -> a 5x8x8x4
    latent grid); no guidance drop."""
    with open(HUNYUAN) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["score_network"]["params"].update(
        hidden_size=128, heads_num=2, mm_double_blocks_depth=1, mm_single_blocks_depth=2,
        text_states_dim=32, clip_states_dim=16, input_spatial_size=8, input_number_of_frames=5)
    diff["sampling"].update(output_spatial_size=8, output_frames=5)
    diff["context_preprocessing"][0]["params"].update(max_length=8, embedding_dim=32)
    diff["context_preprocessing"][1]["params"].update(embedding_dim=16)
    diff["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    diff["latent_encoder"] = tiny_hunyuan(block_out_channels=[8, 8],
                                          spatial_compression_ratio=2)
    cfg["data"].update(image_size=16, input_number_of_frames=9)
    return cfg


@pytest.fixture(scope="module")
def hy_pair():
    from xdiffusion_tpu.config import instantiate_from_config

    cfg = tiny_hunyuan_video()
    # JAX's T5 and CLIP embedders on their hash fallbacks without their
    # first look for weights.
    offline([instantiate_from_config(c) for c in cfg["diffusion"]["context_preprocessing"]])
    return build_latent_pair(cfg)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _draw_into(jmod, port, init, seed=0):
    """Flax params of `jmod` (shapes from eval_shape of `init`) drawn and
    loaded into `port`; returns the flax variables."""
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    variables = jax.eval_shape(init, jax.random.PRNGKey(0))
    drawn = random_flax_params(_flat(variables["params"]), seed)
    load_flax_params(port, drawn)
    return {"params": _tree(drawn)}


# ---- layers -------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["k5", "text_mask"])
def test_token_refiner_matches_jax(masked):
    """SingleTokenRefiner on 12 text states of width 32 to hidden 128 (2
    heads of 64): without a mask (the plain mean, K5's plain version);
    with a mask (the masked mean; -inf logits outside the valid block,
    its first column forced open, so a fully padded row stays finite).
    fp32 2e-5 of the output's scale."""
    from xdiffusion_tpu.score_networks.hunyuan_video import SingleTokenRefiner as JaxRefiner

    from xdiffusion_tpu_torch.score_networks.hunyuan_video import SingleTokenRefiner

    rng = np.random.default_rng(0)
    states, t = _normal(rng, 2, 12, 32), np.float32([0.2, 0.9])
    mask = np.int32([[1] * 7 + [0] * 5, [0] * 12]) if masked else None
    jmod, port = JaxRefiner(hidden_size=128, num_heads=2), SingleTokenRefiner(32, 128, 2)
    jargs = (jnp.asarray(states), jnp.asarray(t)) + ((jnp.asarray(mask),) if masked else ())
    params = _draw_into(jmod, port, lambda k: jmod.init(k, *jargs))
    want = np.asarray(jax.jit(jmod.apply)(params, *jargs))
    with torch.no_grad():
        got = port(torch.from_numpy(states), torch.from_numpy(t),
                   None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


def test_rope_frequencies_head_matches_jax_and_the_network_ignores_its_key(hy_pair):
    """The head's stacked (cos, sin) tables of a 3x4x4 grid equal JAX's to
    fp32 rounding (1e-6); a context that holds the key is left alone; the
    network reads other keys, so tables at another theta under the head's
    key leave its output bit for bit (as in JAX: ROADMAP queue 3)."""
    from xdiffusion_tpu.layers.hunyuan_video.embedding import RopeFrequencies as JaxRope

    from xdiffusion_tpu_torch.layers.hunyuan_video.embedding import RopeFrequencies

    kw = dict(video_length=3, height=8, width=8, patch_size=[1, 2, 2])
    want = np.asarray(JaxRope(**kw)({})["rope_frequencies"])
    got = RopeFrequencies(**kw)({})["rope_frequencies"]
    assert got.shape == want.shape == (2, 1, 48, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    ctx = {"rope_frequencies": 1}
    assert RopeFrequencies(**kw)(ctx) is ctx
    pmodel = hy_pair[2]
    x = torch.from_numpy(_normal(np.random.default_rng(2), 2, 5, 8, 8, 4))
    _, pctx = contexts(hy_pair[0], pmodel)
    pctx["timestep"] = torch.tensor([0.3, 0.8])
    head = RopeFrequencies(video_length=5, height=16, width=16, rope_theta=3.0)
    with torch.inference_mode():
        plain = pmodel.predict_score(x, pctx)
        headed = pmodel.predict_score(x, head(pctx))
    assert "rope_frequencies" in head(pctx)
    assert torch.equal(plain, headed)


@pytest.mark.parametrize("kind", ["llava_llm", "clipL"])
def test_hash_text_encoders_are_bit_equal_to_jax(kind):
    """The hash path of both encoder types, at their default widths (4096
    sequence states, a 768 pooled state): bit for bit."""
    from xdiffusion_tpu.layers.hunyuan_video.text_encoder import TextEncoder as JaxEncoder

    from xdiffusion_tpu_torch.layers.hunyuan_video.text_encoder import TextEncoder

    prompts = ["a digit", "7", ""]
    want = JaxEncoder(text_encoder_type=kind, max_length=4)({"text_prompts": prompts})
    got = TextEncoder(text_encoder_type=kind, max_length=4)({"text_prompts": prompts})
    key = "clip_text_embeddings" if kind == "clipL" else "text_embeddings"
    assert tuple(got[key].shape) == ((3, 768) if kind == "clipL" else (3, 4, 4096))
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ---- the network and the latent process ------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "text_mask", "reference_keys", "rope_tables"])
def test_forward_matches_jax(hy_pair, kind):
    """The tiny network's prediction on a 5x8x8x4 latent grid at times
    (0.3, 0.8): plain; with a text mask (the refiner's einsum path); with
    the reference's context keys (`hv_*`); with precomputed rotary tables
    (`rope_frequencies_cos`/`_sin`, interleave-doubled, the text tokens
    unrotated). fp32 2e-5 of the output's scale."""
    jmodel, params, pmodel = hy_pair
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 5, 8, 8, 4)
    jctx, pctx = contexts(jmodel, pmodel)
    extra = {"timestep": np.float32([0.3, 0.8])}
    if kind == "text_mask":
        extra["text_attention_mask"] = np.int32([[1] * 6 + [0] * 2, [1] * 8])
    if kind == "reference_keys":
        renames = {"text_embeddings": "hv_llm_embeddings",
                   "clip_text_embeddings": "hv_clip_embeddings"}
        jctx = {renames[k]: v for k, v in jctx.items()}
        pctx = {renames[k]: v for k, v in pctx.items()}
        extra["hv_llm_embeddings_attention_mask"] = np.int32([[1] * 5 + [0] * 3, [1] * 8])
    if kind == "rope_tables":
        from xdiffusion_tpu_torch.layers.flux import rope_frequencies

        f, h, w = np.meshgrid(np.arange(5), np.arange(4), np.arange(4), indexing="ij")
        ids = torch.from_numpy(np.stack([f, h, w], -1).reshape(1, 80, 3).astype(np.float32))
        cos, sin = rope_frequencies(ids, (16, 24, 24), 100.0)  # another theta than 256
        extra["rope_frequencies_cos"] = cos[0].repeat_interleave(2, dim=-1).numpy()
        extra["rope_frequencies_sin"] = sin[0].repeat_interleave(2, dim=-1).numpy()
    jctx.update(to_jax(extra))
    pctx.update(to_torch(extra))
    want = np.asarray(jax.jit(jmodel.predict_score)(params, jnp.asarray(x), jctx))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), pctx).numpy()
    assert got.shape == (2, 5, 8, 8, 4) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-5 * max(1.0, np.abs(want).max()), rtol=0)


def test_latent_loss_and_every_gradient_match_jax(hy_pair):
    """loss_on_batch on 9-frame 16x16 clips at injected times and noise,
    the VAE's posterior draw JAX's own (the fifth of its key's five-way
    split): the loss to 1e-5 relative, every score-network gradient to
    GRAD_TOL; the frozen VAE takes none."""
    jmodel, params, pmodel = hy_pair
    jmodel.set_latent_scale(0.7)
    pmodel.set_latent_scale(0.7)
    rng = np.random.default_rng(3)
    clips = rng.uniform(size=(2, 9, 16, 16, 1)).astype(np.float32)
    eps = _normal(rng, 2, 5, 8, 8, 4)
    times = np.float32([0.25, 0.6])
    key = jax.random.PRNGKey(4)
    enc = np.asarray(jax.random.normal(jax.random.split(key, 5)[4], (2, 5, 8, 8, 4)))
    jctx, pctx = contexts(jmodel, pmodel)

    def jax_loss(p, k, xx, c, tt, e):
        return jmodel.loss_on_batch(p, k, xx, c, timesteps=tt, noise=e, deterministic=True)

    (want, wm), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params, key, jnp.asarray(clips), jctx, jnp.asarray(times), jnp.asarray(eps))
    net = pmodel.score_network()
    net.zero_grad(set_to_none=True)
    got, metrics = pmodel.loss_on_batch(
        torch.from_numpy(clips), pctx, timesteps=torch.from_numpy(times),
        noise=torch.from_numpy(eps), deterministic=True, latent_noise=torch.from_numpy(enc))
    got.backward()
    assert rel(got.item(), want) <= 1e-5
    assert rel(metrics["loss_per_example"].numpy(), wm["loss_per_example"]) <= 1e-5
    errors = _grad_errors(grads, net)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_TOL, f"{worst}: {errors[worst]:.2e}"
    assert all(p.grad is None for p in pmodel.latent_encoder().parameters())
    net.zero_grad(set_to_none=True)


def test_decoded_trajectory_matches_jax(hy_pair):
    """10 rectified-flow steps with the prompts, the config's guidance and
    injected initial and per-step noise, divided by the scale and decoded
    to (2, 9, 16, 16, 1): 1e-4 of the scale (fp32 sums in other orders
    through 10 guided network calls and the decoder)."""
    jmodel, params, pmodel = hy_pair
    jmodel.set_latent_scale(0.8)
    pmodel.set_latent_scale(0.8)
    rng = np.random.default_rng(9)
    init = _normal(rng, 2, 5, 8, 8, 4)
    noise = _normal(rng, 10, 2, 5, 8, 8, 4)
    guidance = pmodel.classifier_free_guidance() or None
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=2, num_sampling_steps=10,
        initial_noise=jnp.asarray(init), classifier_free_guidance=guidance,
        context={"text_prompts": PROMPTS, "sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=2, num_sampling_steps=10, initial_noise=torch.from_numpy(init),
                        classifier_free_guidance=guidance,
                        context={"text_prompts": PROMPTS, "sampling_noise": torch.from_numpy(noise)})
    assert got.shape == (2, 9, 16, 16, 1) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0)


def test_config_builds_at_full_width_with_jax_parameter_count():
    check_full_width(HUNYUAN)


# ---- the CLIs -------------------------------------------------------------------


def test_hunyuan_video_trains_from_a_vae_run_and_the_sampling_cli_refuses_it(
        tmp_path, monkeypatch, built_once):
    """The tiny config through the video training CLI (2 steps at batch 2 on
    9-frame 16x16 clips, the VAE's input) from a one-step run of the video
    autoencoder CLI on its VAE block; the video sampling CLI, which loads no
    VAE, refuses the latent config as JAX's fails."""
    from xdiffusion_tpu_torch import sample_video, train_video, train_video_autoencoder

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    cfg = tiny_hunyuan_video()
    vae_cfg = copy.deepcopy(cfg["diffusion"]["latent_encoder"])
    vae_cfg["params"]["loss_config"] = LOSS_3D
    vae_file = tmp_path / "vae.yaml"
    vae_file.write_text(yaml.safe_dump({"autoencoder": vae_cfg, "data": cfg["data"]}))
    # The synthetic Moving-MNIST's 16 frames: the VAE takes the data block's 9.
    vae_run = train_video_autoencoder.main([
        "--config_path", str(vae_file), "--batch_size", "2", "--num_training_steps", "1",
        "--device", "cpu", "--output_path", str(tmp_path / "vae")])
    config = tmp_path / "hunyuan_tiny.yaml"
    config.write_text(yaml.safe_dump(cfg))
    run = train_video.main(["--config_path", str(config), "--batch_size", "2",
                            "--device", "cpu", "--num_training_steps", "2",
                            "--sampling_steps", "2", "--num_samples", "2",
                            "--load_vae_weights_from_checkpoint", vae_run,
                            "--output_path", str(tmp_path / "run")])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    from PIL import Image

    strip = np.asarray(Image.open(os.path.join(run, "sample-2.png")))
    assert strip.shape == (2 * 16, 9 * 16)  # a row per video of its 9 decoded frames
    with pytest.raises(ValueError, match="latent scale"):
        sample_video.main(["--config_path", str(config), "--checkpoint",
                           os.path.join(run, "checkpoints", "2.pt"), "--num_samples", "1",
                           "--sampling_steps", "1", "--device", "cpu",
                           "--output_path", str(tmp_path / "samples")])
