"""The shipped video-UNet configs in the port against the JAX package on
the CPU: all six build at full width with the JAX package's parameter
counts (its shapes from `jax.eval_shape` of init, no full-width compute
here); Imagen-Video's spatial super-resolution stage
(`imagen_video_ssr_16x32.yaml`, cut to two levels, one residual block a
level and 4 frames, widths as shipped) holds its forward against JAX's with
the prompts through both packages' offline T5 tokenizer, 16x16 conditioning
videos resized to 32x32 and augmented at a given time with JAX's own noise
draw injected (2e-5 of the output's scale, fp32); trained alone it fails as
JAX's does, for want of low-resolution videos."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import _flat, _tree

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO = os.path.join(REPO, "configs", "video", "moving_mnist")
SHIPPED = ["video_diffusion_models", "imagen_video_8x16x16", "imagen_video_ssr_16x32",
           "make_a_video", "video_ldm", "animate_diff"]
PROMPTS = ["3", "seven"]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_video_config_builds_with_jax_parameter_count(name):
    """The config as shipped builds with the port on the CPU, every
    parameter fp32, with as many parameters as the JAX package's network
    (its shapes from jax.eval_shape of init, no real init)."""
    from test_torch_port_mmdit import offline
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    path = os.path.join(VIDEO, name + ".yaml")
    net = build_model(load_yaml(path), device="cpu").score_network()
    jmodel = JaxDDPM(jax_load_yaml(path))
    offline(jmodel._context_preprocessors)
    x, ctx = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in net.parameters()) == want
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in net.parameters())



def _ssr_config(directory) -> str:
    """imagen_video_ssr_16x32.yaml cut to channel_multipliers [1, 2], one
    residual block a level, attention at 16 (the 16x16 level) and 4 frames,
    dropout and the guidance drop off; widths as shipped."""
    with open(os.path.join(VIDEO, "imagen_video_ssr_16x32.yaml")) as f:
        cfg = yaml.safe_load(f)
    p = cfg["diffusion"]["score_network"]["params"]
    p.update(channel_multipliers=[1, 2], num_resnet_blocks=1, attention_resolutions=[16],
             input_number_of_frames=4, dropout=0.0)
    cond = p["conditioning"]
    cond["spatial_context_transformer_layer"]["params"]["dropout"] = 0.0
    cond["temporal_context_transformer_layer"]["params"].update(dropout=0.0,
                                                                temporal_sequence_length=4)
    cfg["diffusion"]["sampling"]["output_frames"] = 4
    cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    cfg["data"]["input_number_of_frames"] = 4
    path = os.path.join(str(directory), "imagen_video_ssr_small.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def ssr_pair(tmp_path_factory):
    """(JAX process, flax params, port process) of the cut SSR stage on
    shared seeded weights."""
    from test_torch_port_cascade import no_transformers
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    path = _ssr_config(tmp_path_factory.mktemp("ssr"))
    with no_transformers():
        jmodel = JaxDDPM(jax_load_yaml(path))
    x, ctx = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    drawn = random_flax_params(_flat(shapes["params"]), seed=7)
    pmodel = GaussianDiffusion_DDPM(load_yaml(path), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, {"params": _tree(drawn)}, pmodel, path


def test_ssr_stage_forward_matches_jax(ssr_pair):
    """The stage's input preprocessor and network on 2 videos of 4 frames:
    the prompts' T5 tokens equal JAX's, the 16x16 conditioning is resized
    per frame to 32x32 and augmented at the given times 0.1 and 0.6 with
    JAX's normal draw of fold_in(preprocessor_rng, 1), concatenated to x,
    and the forward at injected logSNR times: 2e-5 of the scale."""
    jmodel, params, pmodel, _ = ssr_pair
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 4, 32, 32, 1)).astype(np.float32)
    low = rng.random((2, 4, 16, 16, 1)).astype(np.float32)
    t = np.float32([0.3, 0.8])
    aug = np.float32([0.1, 0.6])
    jctx = {k: v for k, v in jmodel.preprocess_context({"text_prompts": PROMPTS}).items()
            if hasattr(v, "shape")}
    pctx = {k: v for k, v in pmodel.preprocess_context({"text_prompts": PROMPTS}).items()
            if isinstance(v, torch.Tensor)}
    np.testing.assert_array_equal(pctx["text_tokens"].numpy(), np.asarray(jctx["text_tokens"]))
    key = jax.random.PRNGKey(4)
    jctx.update(low_resolution_images=jnp.asarray(low), augmentation_timestep=jnp.asarray(aug),
                preprocessor_rng=key, timestep=jnp.asarray(t),
                logsnr_t=jmodel.noise_scheduler().logsnr(jnp.asarray(t)))
    pctx.update(low_resolution_images=torch.from_numpy(low),
                augmentation_timestep=torch.from_numpy(aug),
                augmentation_noise=torch.from_numpy(np.asarray(
                    jax.random.normal(jax.random.fold_in(key, 1), (2, 4, 32, 32, 1)))),
                timestep=torch.from_numpy(t))
    pctx["logsnr_t"] = pmodel.noise_scheduler().logsnr(pctx["timestep"])
    want_in = jmodel.process_input(jnp.asarray(x), jctx)
    want = np.asarray(jax.jit(jmodel.predict_score)(params, want_in, jctx))
    with torch.no_grad():
        got_in = pmodel.process_input(torch.from_numpy(x), pctx)
        got = pmodel.predict_score(got_in, pctx)
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in), atol=1e-6, rtol=0)
    assert tuple(got.shape) == (2, 4, 32, 32, 1) and np.abs(want).max() > 1e-1
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * max(1.0, np.abs(want).max()),
                               rtol=0)


def test_ssr_stage_trained_alone_fails_as_in_jax(ssr_pair, tmp_path, monkeypatch):
    """The video trainer gives the SR stage no low-resolution videos: the
    port's first step raises KeyError: 'low_resolution_images', as the JAX
    package's loss does on the same batch."""
    from xdiffusion_tpu_torch import train_video

    jmodel, params, _, path = ssr_pair
    images = jnp.zeros((2, 4, 32, 32, 1))
    with pytest.raises(KeyError, match="low_resolution_images"):
        jmodel.loss_on_batch(params, jax.random.PRNGKey(0), images, {},
                             timesteps=jnp.float32([0.2, 0.4]), deterministic=True)
    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    with pytest.raises(KeyError, match="low_resolution_images"):
        train_video.main(["--config_path", path, "--batch_size", "2", "--num_training_steps",
                          "1", "--output_path", str(tmp_path / "run"), "--device", "cpu"])
