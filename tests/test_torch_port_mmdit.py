"""The MM-DiT family in the port against the JAX package on the CPU: SD3's
offline text preprocessor (bit for bit), SD3's `MMDiTBlock` (with the last
block's text modulation, SD3.5's dual attention and the RMS qk-norm),
AuraFlow's blocks, and the `sd3`, `sd3.5` and `auraflow` configs at depth 2
and hidden 128 (2 heads of 64): forward, loss, every parameter's gradient
against `jax.value_and_grad`, a 10-step guided Euler trajectory; each
config built at full width with JAX's parameter count. Weights are drawn
from a numpy seed (every parameter, the zero-initialised modulations and
output projections too) and cross through the bridge (weights.py); times
and noise are injected.

The helpers serve tests/test_torch_port_flux.py and
tests/test_torch_port_diffussm.py too."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import GRAD_TOL, _flat, _grad_errors, _tree
from test_torch_port_text import _shared as shared_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["3", "seven"]

# The configs cut to depth 2 at hidden 128 (2 heads of 64); every other
# width as shipped.
TINY = {
    "sd3": dict(num_layers=2, num_attention_heads=2),
    "sd3.5": dict(num_layers=2, num_attention_heads=2, dual_attention_layers=1),
    "auraflow": dict(num_mmdit_layers=1, num_single_dit_layers=1, num_attention_heads=2,
                     attention_head_dim=64),
    "flux": dict(hidden_size=128, num_heads=2, depth=1, depth_single_blocks=1),
    "flux_dyt": dict(hidden_size=128, num_heads=2, depth=1, depth_single_blocks=1),
    "chewie": dict(hidden_size=128, num_heads=2, depth=1, depth_single_blocks=1),
    # 16x16 pixels (256 tokens), d_model 32.
    "diffussm": dict(n_layers=2, d_model=32, input_spatial_size=16),
}
MMDIT = ["sd3", "sd3.5", "auraflow"]


def config_path(name: str) -> str:
    return os.path.join(REPO, "configs/image/mnist", name + ".yaml")


def offline(jax_preprocessors) -> None:
    """Leaves the JAX package's text preprocessors where a run that found no
    cached encoder weights leaves them, on their hash fallbacks, without
    their first look for the weights (an import of `transformers` that costs
    some 10 s): SD3's preprocessor marked as having tried its stack, the
    CLIP and T5 embedders' shared cache holding None for their versions."""
    from xdiffusion_tpu.layers.embedding import _FrozenEncoderCache

    for pre in jax_preprocessors:
        name = type(pre).__name__
        if name == "SD3TextPromptsPreprocessor":
            pre._load_attempted = True
        elif name in ("CLIPTextEmbedder", "T5TextEmbedder"):
            kind = "clip" if name.startswith("CLIP") else "t5"
            _FrozenEncoderCache._loaded.setdefault((kind, pre.version), None)


def tiny(config, name: str):
    """`config` (either package's DotConfig) cut to TINY[name], in place."""
    config.diffusion.score_network.params.to_dict().update(TINY[name])
    if "input_spatial_size" in TINY[name]:
        config.diffusion.sampling.to_dict()["output_spatial_size"] = TINY[name][
            "input_spatial_size"]
    return config


_BUILT = {}


def build(name: str):
    """(JAX process, flax params, port process on the CPU, drawn flat
    weights) of the tiny config, built once."""
    if name not in _BUILT:
        from xdiffusion_tpu.config import load_yaml as jax_load_yaml
        from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

        from xdiffusion_tpu_torch.config import load_yaml
        from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
        from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

        jmodel = JaxDDPM(tiny(jax_load_yaml(config_path(name)), name))
        offline(jmodel._context_preprocessors)
        x, ctx = jmodel.example_batch(2)
        shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
        drawn = random_flax_params(_flat(shapes["params"]), seed=7)
        pmodel = GaussianDiffusion_DDPM(tiny(load_yaml(config_path(name)), name), device="cpu")
        load_flax_params(pmodel.score_network(), drawn)
        _BUILT[name] = jmodel, {"params": _tree(drawn)}, pmodel, drawn
    return _BUILT[name]


def image_shape(pmodel, n: int = 2):
    return tuple(pmodel.sampling_shape(n))


def is_flow(pmodel) -> bool:
    return pmodel.config().diffusion.parameterization == "rectified_flow"


def times(pmodel, seed: int = 0) -> np.ndarray:
    """Two times: fp32 in (0, 1) for rectified flow, else int32 steps."""
    rng = np.random.default_rng(seed)
    if is_flow(pmodel):
        return rng.uniform(0.02, 0.98, size=2).astype(np.float32)
    return rng.integers(0, 1000, size=2).astype(np.int32)


def torch_times(t: np.ndarray) -> torch.Tensor:
    tt = torch.from_numpy(t)
    return tt if tt.is_floating_point() else tt.long()


def arrays(ctx):
    return {k: v for k, v in ctx.items() if not isinstance(v, (list, tuple, str))}


def contexts(jmodel, pmodel):
    """The prompts through each side's preprocessors (none for a config
    whose only preprocessor is the ignore adapter: classes 3 and 7)."""
    if not any(type(p).__name__ != "IgnoreContextAdapter"
               for p in pmodel._context_preprocessors):
        classes = np.int32([3, 7])
        return {"classes": jnp.asarray(classes)}, {"classes": torch.from_numpy(classes)}
    jctx = arrays(jmodel.preprocess_context({"text_prompts": PROMPTS}))
    pctx = arrays(pmodel.preprocess_context({"text_prompts": PROMPTS}))
    assert sorted(jctx) == sorted(pctx)
    return jctx, pctx


def check_forward(name: str) -> None:
    """The forward with prompts at injected times: fp32, 2e-5 of the
    output's scale (sums in other orders through two blocks)."""
    jmodel, params, pmodel, _ = build(name)
    x = np.random.default_rng(0).standard_normal(image_shape(pmodel)).astype(np.float32)
    jctx, pctx = contexts(jmodel, pmodel)
    t = times(pmodel)
    jctx["timestep"], pctx["timestep"] = jnp.asarray(t), torch_times(t)
    want = np.asarray(jax.jit(jmodel.predict_score)(params, jnp.asarray(x), jctx))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), pctx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(want).max() > 1e-2  # no zero-initialised layer left
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * max(1.0, np.abs(want).max()),
                               rtol=0)


def check_loss_and_gradients(name: str) -> None:
    """loss_on_batch with prompts, injected times and noise, dropout and the
    guidance drop off, against jitted jax.value_and_grad of the JAX
    package's: the loss and per-example losses to 1e-5 relative, every
    gradient to GRAD_TOL (1e-4 of its own largest magnitude, floored at 1e-3
    of the network's largest: fp32 sums in other orders)."""
    jmodel, params, pmodel, _ = build(name)
    net = pmodel.score_network()
    net.zero_grad(set_to_none=True)
    rng = np.random.default_rng(3)
    images = rng.random(image_shape(pmodel)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    t = times(pmodel, seed=4)
    jctx, pctx = contexts(jmodel, pmodel)
    saved = jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability
    jmodel._unconditional_guidance_probability = pmodel._unconditional_guidance_probability = 0.0
    try:
        def jax_loss(p):
            return jmodel.loss_on_batch(p, jax.random.PRNGKey(1), jnp.asarray(images), jctx,
                                        timesteps=jnp.asarray(t), noise=jnp.asarray(noise),
                                        deterministic=True)

        (want, want_m), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
        got, got_m = pmodel.loss_on_batch(torch.from_numpy(images), pctx,
                                          timesteps=torch_times(t),
                                          noise=torch.from_numpy(noise), deterministic=True)
        got.backward()
    finally:
        jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability = saved
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["loss_per_example"].numpy(),
                               np.asarray(want_m["loss_per_example"]), rtol=1e-5)
    errors = _grad_errors(grads, net)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_TOL, f"{worst}: {errors[worst]:.2e}"
    net.zero_grad(set_to_none=True)


def check_trajectory(name: str, steps: int = 10) -> None:
    """`steps` steps of the config's sampler with prompts (or classes), the
    config's guidance (one forward on the doubled batch) and injected
    initial and per-step noise: 1e-3 on samples in [0, 1]."""
    jmodel, params, pmodel, _ = build(name)
    n = len(PROMPTS)
    shape = image_shape(pmodel, n)
    rng = np.random.default_rng(1)
    init = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((steps,) + shape).astype(np.float32)
    jctx, pctx = {"sampling_noise": jnp.asarray(noise)}, {"sampling_noise": torch.from_numpy(noise)}
    jlabels, plabels = contexts(jmodel, pmodel)
    if "classes" in plabels:
        jctx["classes"], pctx["classes"] = jlabels["classes"], plabels["classes"]
    else:
        jctx["text_prompts"] = pctx["text_prompts"] = PROMPTS
    guidance = pmodel.classifier_free_guidance() or None
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        initial_noise=jnp.asarray(init), classifier_free_guidance=guidance, context=jctx))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps,
                        initial_noise=torch.from_numpy(init), classifier_free_guidance=guidance,
                        context=pctx)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def check_full_width(name: str) -> None:
    """The config as shipped builds with the port on the CPU, every
    parameter fp32, with as many parameters as the JAX package's network
    (its shapes from jax.eval_shape of init, no real init)."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    net = build_model(load_yaml(config_path(name)), device="cpu").score_network()
    jmodel = JaxDDPM(jax_load_yaml(config_path(name)))
    offline(jmodel._context_preprocessors)
    x, ctx = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in net.parameters()) == want
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in net.parameters())


# ---- the SD3 preprocessor -----------------------------------------------------


def test_sd3_prompt_preprocessor_is_bit_equal_to_jax():
    """The offline hash embeddings: text (B, 77, 2048) and pooled (B, 2048)
    bit for bit (after checking JAX took its fallback); the prompts leave
    the context; embeddings already there are left alone; the port's loaders
    find none of the three towers here, so the stack is None and the hash
    path runs, as in JAX."""
    from xdiffusion_tpu.context import SD3TextPromptsPreprocessor as JaxSD3

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.context import SD3EncoderStack, SD3TextPromptsPreprocessor

    params = load_yaml(config_path("sd3")).diffusion.context_preprocessing[0]["params"]
    prompts = ["0", "one", "", "a handwritten digit three", "zéro"]
    jax_pre = JaxSD3(**params)
    offline([jax_pre])
    want = jax_pre({"text_prompts": prompts})
    assert jax_pre._encoders is None  # JAX took its hash fallback
    got = SD3TextPromptsPreprocessor(**params)({"text_prompts": prompts, "classes": 1})
    assert sorted(got) == ["classes", "pooled_text_embeddings", "text_embeddings"]
    assert got["text_embeddings"].dtype == torch.float32
    assert tuple(got["text_embeddings"].shape) == (5, 77, 2048)
    assert tuple(got["pooled_text_embeddings"].shape) == (5, 2048)
    for key in ("text_embeddings", "pooled_text_embeddings"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    ctx = {"text_prompts": ["1"], "text_embeddings": torch.ones(1)}
    assert SD3TextPromptsPreprocessor(**params)(ctx) is ctx
    pre = SD3TextPromptsPreprocessor(**params)
    assert SD3EncoderStack.for_pretrained(
        pre.first_clip_model_name, pre.second_clip_model_name, pre.t5_model_name, 77, 77, 77,
        device="cpu") is None
    assert pre._encoder_stack() is None and pre._load_attempted
    np.testing.assert_array_equal(pre({"text_prompts": prompts})["text_embeddings"].numpy(),
                                  np.asarray(want["text_embeddings"]))


# ---- blocks -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["joint", "last", "dual_qk_norm", "last_qk_norm"])
def test_mmdit_block_matches_jax(kind):
    """One MMDiT block on 16 image and 77 text tokens, 2 heads of 64: a
    joint block, the last (`context_pre_only`: (scale, shift) text
    modulation, no text out), SD3.5's dual attention with the RMS qk-norm,
    and the last block with the qk-norm: fp32 2e-5 of the output's scale."""
    from xdiffusion_tpu.score_networks.sd3 import MMDiTBlock as JaxBlock

    from xdiffusion_tpu_torch.score_networks.sd3 import MMDiTBlock

    kw = dict(context_pre_only=kind.startswith("last"), dual_attention=kind.startswith("dual"),
              qk_norm=kind.endswith("qk_norm"))
    rng = np.random.default_rng(11)
    x, c = (rng.standard_normal((2, n, 128)).astype(np.float32) for n in (16, 77))
    temb = rng.standard_normal((2, 128)).astype(np.float32)
    jmod = JaxBlock(dim=128, num_heads=2, **kw)
    port = MMDiTBlock(128, 2, **kw)
    args = tuple(jnp.asarray(a) for a in (x, c, temb))
    params = shared_weights(jmod, port, *args)
    want_x, want_c = jax.jit(jmod.apply)(params, *args)
    with torch.no_grad():
        got_x, got_c = port(*(torch.from_numpy(a) for a in (x, c, temb)))
    for got, want in ((got_x, want_x), (got_c, want_c)):
        if want is None:
            assert got is None
            continue
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("block", ["joint", "single"])
def test_auraflow_blocks_match_jax(block):
    """AuraFlow's joint block (24 text, 16 image tokens) and single block
    (40 tokens), 2 heads of 64, with the fp32 per-head qk LayerNorm, the
    sandwich residuals and the SwiGLU feed-forward (hidden 512 at d 128):
    fp32 2e-5 of the output's scale."""
    from xdiffusion_tpu.score_networks import auraflow as jax_aura

    from xdiffusion_tpu_torch.score_networks import auraflow

    rng = np.random.default_rng(12)
    temb = rng.standard_normal((2, 128)).astype(np.float32)
    if block == "joint":
        x, c = (rng.standard_normal((2, n, 128)).astype(np.float32) for n in (16, 24))
        jmod, port, inputs = (jax_aura.AuraFlowJointBlock(dim=128, num_heads=2),
                              auraflow.AuraFlowJointBlock(128, 2), (x, c, temb))
    else:
        x = rng.standard_normal((2, 40, 128)).astype(np.float32)
        jmod, port, inputs = (jax_aura.AuraFlowSingleBlock(dim=128, num_heads=2),
                              auraflow.AuraFlowSingleBlock(128, 2), (x, temb))
    assert (port.ff if block == "single" else port.ff_x).linear_1.out_features == 512
    args = tuple(jnp.asarray(a) for a in inputs)
    params = shared_weights(jmod, port, *args)
    want = jax.jit(jmod.apply)(params, *args)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in inputs))
    for g, w in zip(got if block == "joint" else (got,), want if block == "joint" else (want,)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * np.abs(w).max(), rtol=0)


# ---- the configs --------------------------------------------------------------


@pytest.mark.parametrize("name", MMDIT)
def test_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", MMDIT)
def test_loss_and_every_gradient_match_jax(name):
    check_loss_and_gradients(name)


@pytest.mark.parametrize("name", MMDIT)
def test_guided_trajectory_matches_jax(name):
    check_trajectory(name)


@pytest.mark.parametrize("name", MMDIT)
def test_config_builds_at_full_width_with_jax_parameter_count(name):
    check_full_width(name)


def test_learned_sigma_sd3_forward_matches_jax():
    """SD3 with `is_learned_sigma`: the (prediction, log-variance) pair of
    the doubled output head, each against JAX's at fp32 2e-5 of its scale."""
    from xdiffusion_tpu.score_networks.sd3 import SD3Transformer2DModel as JaxSD3
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig

    from xdiffusion_tpu_torch.config import DotConfig, load_yaml
    from xdiffusion_tpu_torch.score_networks.sd3 import SD3Transformer2DModel

    params = load_yaml(config_path("sd3")).diffusion.score_network.params.to_dict()
    params.update(TINY["sd3"], is_learned_sigma=True)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    ctx = {"timestep": np.float32([0.25, 0.8]),
           "text_embeddings": rng.standard_normal((2, 5, 2048)).astype(np.float32),
           "pooled_text_embeddings": rng.standard_normal((2, 2048)).astype(np.float32)}
    jmod, port = JaxSD3(JaxDotConfig(params)), SD3Transformer2DModel(DotConfig(params))
    jctx = {k: jnp.asarray(v) for k, v in ctx.items()}
    variables = shared_weights(jmod, port, jnp.asarray(x), jctx)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x), jctx)
    with torch.no_grad():
        got = port(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in ctx.items()})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (2, 32, 32, 1)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * np.abs(w).max(), rtol=0)
