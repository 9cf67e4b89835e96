"""Sora (OpenSora's STDiT3) and PixArt-Sigma's KV compression in the port
against the JAX package on the CPU.

The rotary embedding (even and odd head dims), `STAttention` spatially and
temporally with the rotation, `CaptionCrossAttention` with and without a
text mask (plain einsums, or K5's plain version), an `STDiTBlock` with and
without a frame mask; sora.yaml cut to 2 block pairs at hidden 128 (2 heads
of 64) on 4 frames of 16x16 (patch 1x4x4: 16 tokens a frame) with 8 hash-T5
tokens of width 32: the forward (with a frame mask, which reaches the
final layer's quirk, and with a text mask), the rectified-flow loss with an
OpenSora frame mask injected on both sides and every gradient against
jitted `jax.value_and_grad`, a 10-step guided trajectory with injected
noise; `KVCompressAttention`'s samplings; the config at full width with
JAX's parameter count; the tiny config through the video training CLI
(its `mask_ratios` reach OpenSoraMaskGenerator) and the sampling CLI.
Weights are drawn from a numpy seed (every parameter, the zero-initialised
output projection too) and cross through the bridge (weights.py). The JAX
side is jitted with the parameters and arrays as arguments.

The helpers `video_pair`, `forward_pair` and `loss_pair` serve
tests/test_torch_port_hunyuan.py too."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import GRAD_TOL, _flat, _grad_errors, _tree
from test_torch_port_mmdit import offline
from test_torch_port_text import _shared as shared_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SORA = os.path.join(REPO, "configs/video/moving_mnist/sora.yaml")
PROMPTS = ["3", "seven"]


def tiny_sora() -> dict:
    """sora.yaml at 2 block pairs, hidden 128 (2 heads of 64), 4 frames of
    16x16, 8 hash-T5 tokens of width 32; input_sq_size 32 as shipped, so the
    position table's scale is 0.5."""
    with open(SORA) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["score_network"]["params"].update(
        hidden_size=128, depth=2, num_heads=2, caption_channels=32, model_max_length=8,
        input_size=[4, 16, 16], input_spatial_size=16, input_number_of_frames=4)
    diff["sampling"].update(output_spatial_size=16, output_frames=4)
    diff["context_preprocessing"][0]["params"].update(max_length=8, embedding_dim=32)
    cfg["data"].update(image_size=16, input_number_of_frames=4)
    return cfg


def video_pair(cfg: dict, seed: int = 7):
    """(JAX process, flax params, port process on the CPU), one seeded draw
    of the score network's weights carried into both."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxDDPM(JaxDotConfig(copy.deepcopy(cfg)))
    offline(jmodel._context_preprocessors)
    x, ctx = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    drawn = random_flax_params(_flat(shapes["params"]), seed)
    pmodel = GaussianDiffusion_DDPM(DotConfig(copy.deepcopy(cfg)), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, {"params": _tree(drawn)}, pmodel


def contexts(jmodel, pmodel, prompts=PROMPTS):
    """The prompts through each side's preprocessors, arrays only."""
    def arrays(ctx):
        return {k: v for k, v in ctx.items() if hasattr(v, "shape")}

    return (arrays(jmodel.preprocess_context({"text_prompts": list(prompts)})),
            arrays(pmodel.preprocess_context({"text_prompts": list(prompts)})))


def to_jax(ctx):
    return {k: jnp.asarray(v) for k, v in ctx.items()}


def to_torch(ctx):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in ctx.items()}


def forward_pair(pair, x: np.ndarray, extra: dict):
    """(port, JAX) predictions at times (0.3, 0.8) with the prompts'
    context plus `extra` (numpy arrays)."""
    jmodel, params, pmodel = pair
    jctx, pctx = contexts(jmodel, pmodel)
    t = np.float32([0.3, 0.8])
    jctx.update(to_jax({"timestep": t, **extra}))
    pctx.update(to_torch({"timestep": t, **extra}))
    want = np.asarray(jax.jit(jmodel.predict_score)(params, jnp.asarray(x), jctx))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), pctx).numpy()
    return got, want


def loss_pair(pair, images: np.ndarray, extra: dict, seed: int = 4):
    """The port's loss_on_batch (backward run) and JAX's jitted
    value_and_grad, at injected times and noise, no guidance drop:
    ((loss, per-example), (JAX loss, per-example, grads))."""
    jmodel, params, pmodel = pair
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    t = rng.uniform(0.02, 0.98, size=images.shape[0]).astype(np.float32)
    jctx, pctx = contexts(jmodel, pmodel)
    jctx.update(to_jax(extra))
    pctx.update(to_torch(extra))
    saved = jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability
    jmodel._unconditional_guidance_probability = pmodel._unconditional_guidance_probability = 0.0
    try:
        def jax_loss(p, xx, c, tt, e):
            return jmodel.loss_on_batch(p, jax.random.PRNGKey(1), xx, c, timesteps=tt, noise=e,
                                        deterministic=True)

        (want, want_m), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params, jnp.asarray(images), jctx, jnp.asarray(t), jnp.asarray(noise))
        net = pmodel.score_network()
        net.zero_grad(set_to_none=True)
        got, got_m = pmodel.loss_on_batch(torch.from_numpy(images), pctx,
                                          timesteps=torch.from_numpy(t),
                                          noise=torch.from_numpy(noise), deterministic=True)
        got.backward()
    finally:
        jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability = saved
    return ((got.item(), got_m["loss_per_example"].numpy()),
            (float(want), np.asarray(want_m["loss_per_example"]), grads))


def check_loss_and_gradients(pair, images, extra):
    """The loss and per-example losses to 1e-5 relative, every gradient to
    GRAD_TOL (1e-4 of its own largest magnitude, floored at 1e-3 of the
    network's largest: fp32 sums in other orders)."""
    (got, got_pe), (want, want_pe, grads) = loss_pair(pair, images, extra)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_pe, want_pe, rtol=1e-5)
    net = pair[2].score_network()
    errors = _grad_errors(grads, net)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_TOL, f"{worst}: {errors[worst]:.2e}"
    net.zero_grad(set_to_none=True)


def check_trajectory(pair, steps: int = 10):
    """`steps` steps of the config's sampler with the prompts, the config's
    guidance and injected initial and per-step noise: 1e-3 on samples in
    [0, 1]."""
    jmodel, params, pmodel = pair
    shape = tuple(pmodel.sampling_shape(len(PROMPTS)))
    rng = np.random.default_rng(1)
    init = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((steps,) + shape).astype(np.float32)
    guidance = pmodel.classifier_free_guidance() or None
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=len(PROMPTS), num_sampling_steps=steps,
        initial_noise=jnp.asarray(init), classifier_free_guidance=guidance,
        context={"text_prompts": PROMPTS, "sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=len(PROMPTS), num_sampling_steps=steps,
                        initial_noise=torch.from_numpy(init), classifier_free_guidance=guidance,
                        context={"text_prompts": PROMPTS,
                                 "sampling_noise": torch.from_numpy(noise)})
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def check_full_width(path: str) -> None:
    """The config as shipped builds with the port on the CPU, every
    parameter fp32, with JAX's parameter count and tree (its shapes from
    jax.eval_shape of init, no real init; the bridge places every leaf)."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    net = build_model(load_yaml(path), device="cpu").score_network()
    jmodel = JaxDDPM(jax_load_yaml(path))
    offline(jmodel._context_preprocessors)
    x, ctx = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    flat = _flat(shapes["params"])
    want = sum(int(np.prod(leaf.shape)) for leaf in flat.values())
    assert sum(p.numel() for p in net.parameters()) == want
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in net.parameters())
    zeros = {k: np.zeros(v.shape, np.float32) for k, v in flat.items()}
    assert len(flax_to_state_dict(zeros, net)) == len(dict(net.named_parameters()))


@pytest.fixture(scope="module")
def sora_pair():
    return video_pair(tiny_sora())


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---- layers -------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 7])
def test_rotary_matches_jax(d):
    """The interleaved-pair rotation over 16 positions; an odd head dim
    passes its last channel through. fp32 1e-6 of the scale."""
    from xdiffusion_tpu.score_networks.sora import _rotary as jax_rotary

    from xdiffusion_tpu_torch.score_networks.sora import rotary

    t = _normal(np.random.default_rng(0), 2, 3, 16, d)
    want = np.asarray(jax.jit(jax_rotary)(jnp.asarray(t)))
    got = rotary(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    if d % 2:
        np.testing.assert_array_equal(got[..., -1], t[..., -1])


@pytest.mark.parametrize("kind", ["spatial", "temporal_rope", "no_qk_norm"])
def test_st_attention_matches_jax(kind):
    """STAttention on 16 tokens of width 128, 2 heads of 64: with the RMS
    qk-norm, with the norm and the rotary embedding (a temporal block's),
    and without either. fp32 2e-5 of the output's scale."""
    from xdiffusion_tpu.score_networks.sora import STAttention as JaxAttn

    from xdiffusion_tpu_torch.score_networks.sora import STAttention

    kw = dict(qk_norm=kind != "no_qk_norm", rope=kind == "temporal_rope")
    x = _normal(np.random.default_rng(1), 3, 16, 128)
    jmod = JaxAttn(num_heads=2, **kw)
    port = STAttention(128, 2, **kw)
    params = shared_weights(jmod, port, jnp.asarray(x))
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["k5", "text_mask"])
def test_caption_cross_attention_matches_jax(masked):
    """64 tokens against 8 caption tokens: K5's plain version without a
    mask; the einsums with the finfo.min bias when a (B, L) mask pads the
    last tokens away (a row with one real token too). fp32 2e-5."""
    from xdiffusion_tpu.score_networks.sora import CaptionCrossAttention as JaxCross

    from xdiffusion_tpu_torch.score_networks.sora import CaptionCrossAttention

    rng = np.random.default_rng(2)
    x, y = _normal(rng, 2, 64, 128), _normal(rng, 2, 8, 128)
    mask = np.int32([[1, 1, 1, 1, 1, 0, 0, 0], [1, 0, 0, 0, 0, 0, 0, 0]]) if masked else None
    jmod, port = JaxCross(num_heads=2), CaptionCrossAttention(128, 2)
    jargs = (jnp.asarray(x), jnp.asarray(y)) + ((jnp.asarray(mask),) if masked else ())
    params = shared_weights(jmod, port, *jargs)
    want = np.asarray(jax.jit(jmod.apply)(params, *jargs))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y),
                   None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)
    if masked:  # the padded tokens do not reach the output
        y2 = y.copy()
        y2[0, 5:] += 3.0
        with torch.no_grad():
            again = port(torch.from_numpy(x), torch.from_numpy(y2), torch.from_numpy(mask))
        np.testing.assert_allclose(again[0].numpy(), got[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("temporal,masked", [(False, False), (True, True), (False, True)],
                         ids=["spatial", "temporal_frame_mask", "spatial_frame_mask"])
def test_stdit_block_matches_jax(temporal, masked):
    """One block on 4 frames of 16 tokens, width 128: the shared signals
    plus its table, the frame select between t and t0 where a (B, F) frame
    mask conditions frames, caption cross-attention. fp32 2e-5."""
    from xdiffusion_tpu.score_networks.sora import STDiTBlock as JaxBlock

    from xdiffusion_tpu_torch.score_networks.sora import STDiTBlock

    rng = np.random.default_rng(3)
    x, y = _normal(rng, 2, 64, 128), _normal(rng, 2, 8, 128)
    t6, t6z = _normal(rng, 2, 768), _normal(rng, 2, 768)
    fm = np.array([[True, False, True, True], [False, False, True, True]])
    jmod = JaxBlock(hidden_size=128, num_heads=2, temporal=temporal, rope=temporal)
    port = STDiTBlock(128, 2, temporal=temporal, rope=temporal)
    extra = dict(t6_zero=t6z, frame_mask=fm) if masked else {}
    jx = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(t6))
    jkw = {k: jnp.asarray(v) for k, v in extra.items()}
    variables = jax.eval_shape(lambda k: jmod.init(k, *jx, 4, **jkw), jax.random.PRNGKey(0))
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    drawn = random_flax_params(_flat(variables["params"]), 5)
    load_flax_params(port, drawn)
    want = np.asarray(jax.jit(lambda p, a, b, c, kw: jmod.apply(p, a, b, c, 4, **kw))(
        {"params": _tree(drawn)}, *jx, jkw))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t6), 4,
                   **{k: torch.from_numpy(v) for k, v in extra.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("sampling,sr,qk_norm,masked", [
    ("conv", 2, False, False), ("conv", 2, True, True), ("uniform", 2, False, False),
    ("ave", 2, False, False), ("uniform_every", 4, False, False), ("conv", 1, False, False)])
def test_kv_compress_attention_matches_jax(sampling, sr, qk_norm, masked):
    """KVCompressAttention on an 8x8 grid (64 tokens, width 64, 2 heads):
    the shared depthwise conv (its `sr_kernel` carried as it is) with its
    LayerNorm, the strided picks, every sr-th token, no compression; with
    the RMS qk-norm and an additive mask. fp32 2e-5."""
    from xdiffusion_tpu.layers.sora import KVCompressAttention as JaxKV

    from xdiffusion_tpu_torch.layers.sora import KVCompressAttention

    rng = np.random.default_rng(6)
    x = _normal(rng, 2, 64, 64)
    kw = dict(num_heads=2, qkv_bias=True, qk_norm=qk_norm, sampling=sampling, sr_ratio=sr)
    jmod, port = JaxKV(dim=64, **kw), KVCompressAttention(64, **kw)
    m = 64 if sr == 1 else (64 // sr if sampling == "uniform_every" else 64 // sr ** 2)
    mask = (rng.random((2, 1, 1, m)) > 0.3).astype(np.float32) if masked else None
    if masked:
        mask[..., 0] = 1.0
    jargs = (jnp.asarray(x),) + ((jnp.asarray(mask),) if masked else ())
    variables = jax.eval_shape(lambda k, a, *r: jmod.init(k, a, (8, 8), *r),
                               jax.random.PRNGKey(0), *jargs)
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    drawn = random_flax_params(_flat(variables["params"]), 0)
    load_flax_params(port, drawn)
    if sampling == "conv" and sr > 1:
        assert port.sr_kernel.shape == (sr, sr, 1, 64)
    want = np.asarray(jax.jit(lambda p, a, *r: jmod.apply(p, a, (8, 8), *r))(
        {"params": _tree(drawn)}, *jargs))
    with torch.no_grad():
        got = port(torch.from_numpy(x), (8, 8),
                   None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


# ---- the network and the process -----------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "frame_mask", "text_mask"])
def test_forward_matches_jax(sora_pair, kind):
    """The tiny Sora's prediction at injected times with the prompts'
    embeddings: plain (every attention on K5's plain version); with a
    `video_mask` conditioning frames (t0 modulation in every block and the
    final layer's quirk); with a `text_attention_mask` (the einsum caption
    path). fp32 2e-5 of the output's scale."""
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 4, 16, 16, 1)
    extra = {}
    if kind == "frame_mask":
        extra["video_mask"] = np.array([[True, False, True, True], [False, True, True, False]])
    if kind == "text_mask":
        extra["text_attention_mask"] = np.int32([[1] * 5 + [0] * 3, [1] * 8])
    got, want = forward_pair(sora_pair, x, extra)
    assert got.shape == (2, 4, 16, 16, 1) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-5 * max(1.0, np.abs(want).max()), rtol=0)
    if kind == "frame_mask":  # the mask moves the output
        plain, _ = forward_pair(sora_pair, x, {})
        assert np.abs(plain - got).max() > 1e-3


def test_loss_and_every_gradient_match_jax(sora_pair):
    """The rectified-flow loss with an OpenSora frame mask (the port's
    generator, the config's ratios, seeded) on both sides: the conditioned
    frames keep their clean latents and take the t0 modulation."""
    from xdiffusion_tpu_torch.masking import OpenSoraMaskGenerator

    rng = np.random.default_rng(3)
    images = rng.random((2, 4, 16, 16, 1)).astype(np.float32)
    gen = OpenSoraMaskGenerator(mask_ratios=tiny_sora()["training"]["mask_ratios"])
    mask = gen.get_masks((2, 4), rng=np.random.default_rng(11))
    mask[0, 1] = False  # at least one conditioned frame
    check_loss_and_gradients(sora_pair, images, {"video_mask": mask})


def test_guided_trajectory_matches_jax(sora_pair):
    check_trajectory(sora_pair)


def test_config_builds_at_full_width_with_jax_parameter_count():
    check_full_width(SORA)


def test_sora_mask_ratios_take_opensoras_spelling_where_jax_asserts():
    """sora.yaml's ratios name OpenSora's "intepolate": the port takes it as
    "interpolate" in its place, and its masks then equal the JAX package's
    for the ratios so renamed, draw for draw; the JAX generator asserts on
    the shipped spelling."""
    from xdiffusion_tpu.masking import OpenSoraMaskGenerator as JaxGen

    from xdiffusion_tpu_torch.masking import OpenSoraMaskGenerator

    ratios = tiny_sora()["training"]["mask_ratios"]
    assert "intepolate" in ratios
    with pytest.raises(AssertionError):
        JaxGen(mask_ratios=ratios)
    renamed = {("interpolate" if k == "intepolate" else k): v for k, v in ratios.items()}
    assert list(renamed) == list(OpenSoraMaskGenerator(mask_ratios=ratios).mask_ratios)
    got = OpenSoraMaskGenerator(mask_ratios=ratios).get_masks(
        (64, 16), rng=np.random.default_rng(5))
    want = JaxGen(mask_ratios=renamed).get_masks((64, 16), rng=np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)
    assert not got.all()


# ---- the CLIs -------------------------------------------------------------------


def test_sora_through_the_video_clis(tmp_path, monkeypatch):
    """The tiny Sora, with the shipped mask_ratios, through the video
    training CLI (2 steps at batch 2 on the synthetic Moving-MNIST, a strip
    of 2-step samples) and its checkpoint through the sampling CLI."""
    from xdiffusion_tpu_torch import sample_video, train_video

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    path = tmp_path / "sora_tiny.yaml"
    path.write_text(yaml.safe_dump(tiny_sora()))
    run = train_video.main(["--config_path", str(path), "--batch_size", "2", "--device", "cpu",
                            "--num_training_steps", "2", "--sampling_steps", "2",
                            "--num_samples", "2", "--output_path", str(tmp_path / "run")])
    import json

    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    samples = sample_video.main(["--config_path", str(path), "--checkpoint",
                                 os.path.join(run, "checkpoints", "2.pt"), "--num_samples", "2",
                                 "--sampling_steps", "2", "--device", "cpu",
                                 "--output_path", str(tmp_path / "samples")])
    assert tuple(samples.shape) == (2, 4, 16, 16, 1) and torch.isfinite(samples).all()
    assert os.path.exists(os.path.join(str(tmp_path / "samples"), "video-step2.gif"))
