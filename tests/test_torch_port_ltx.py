"""The LTX-Video pixel-space sampling path: port against the JAX package on
the CPU.

K5's plain version against the Pallas kernel in interpret mode (as
tests/test_ops.py runs it), the attention dispatch, the LTX layers, the
offline text embedder, the rectified-flow scheduler, the transformer through
the weight bridge and a 10-step rectified-flow trajectory, at small widths,
fp32, with inputs and weights from numpy seeds. Then the video sampling CLI.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LTX = os.path.join(REPO, "configs/video/moving_mnist/ltx_video/ltx_video_pixel_space.yaml")

# fp32 on both sides: the ops differ by summation order only; the network
# and the trajectory carry that through several blocks.
OPS_TOL = 1e-5
NET_TOL = 1e-4


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _small_config(d):
    """The shipped LTX config cut to 2 layers, 2 heads x 64, a 4x4x4 grid
    and 8 text tokens of width 32."""
    sn = d["diffusion"]["score_network"]["params"]
    sn.update(num_layers=2, num_attention_heads=2, input_spatial_size=4,
              input_number_of_frames=4, caption_channels=32, cross_attention_dim=32)
    d["diffusion"]["sampling"].update(output_spatial_size=4, output_frames=4)
    d["diffusion"]["context_preprocessing"][0]["params"].update(max_length=8,
                                                                 embedding_dim=32)
    return d


def _load_small():
    with open(LTX) as f:
        return _small_config(yaml.safe_load(f))


@pytest.fixture(scope="module", autouse=True)
def _no_pretrained_t5():
    """The JAX T5 embedder looks for pretrained weights before it falls back
    to the hash embedding; no weights are in the repository, so report them
    missing without the look (which imports transformers)."""
    from xdiffusion_tpu.layers.embedding import _FrozenEncoderCache

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_FrozenEncoderCache, "get", classmethod(lambda cls, kind, version: None))
        yield


# ---- K5 and the attention dispatch -------------------------------------------


@pytest.mark.parametrize("sq,sk", [(512, 512), (256, 128)], ids=["self", "cross"])
def test_flash_attention_plain_matches_pallas(sq, sk):
    from xdiffusion_tpu.ops.flash_attention import _flash_forward

    from xdiffusion_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(0)
    q, k, v = _normal(rng, 1, 2, sq, 64), _normal(rng, 1, 2, sk, 64), _normal(rng, 1, 2, sk, 64)
    scale = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    o, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             scale)
    assert o.shape == (1, 2, sq, 64) and lse.shape == (1, 2, sq, 1)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=OPS_TOL, rtol=OPS_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=OPS_TOL, rtol=OPS_TOL)


@pytest.mark.parametrize("is_causal", [False, True])
def test_dot_product_attention_matches_jax(is_causal):
    from xdiffusion_tpu.ops.attention import dot_product_attention as jax_dpa

    from xdiffusion_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, 2, 3, 40, 32), _normal(rng, 2, 3, 40, 32), _normal(rng, 2, 3, 40, 32)
    want = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              is_causal=is_causal))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                is_causal=is_causal)
    np.testing.assert_allclose(got.numpy(), want, atol=OPS_TOL, rtol=OPS_TOL)


# ---- layers ------------------------------------------------------------------


def test_rms_norm_matches_jax():
    from xdiffusion_tpu.layers.norm import RMSNorm as JaxRMSNorm

    from xdiffusion_tpu_torch.layers.norm import RMSNorm

    rng = np.random.default_rng(2)
    x, scale = _normal(rng, 2, 5, 48, scale=3.0), 1.0 + _normal(rng, 48, scale=0.1)
    want = JaxRMSNorm(dim=48, eps=1e-5).apply({"params": {"scale": jnp.asarray(scale)}},
                                              jnp.asarray(x))
    norm = RMSNorm(48, eps=1e-5)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OPS_TOL, rtol=OPS_TOL)


@pytest.mark.parametrize("dim", [256, 33])
def test_glide_timestep_embedding_matches_jax(dim):
    from xdiffusion_tpu.layers.embedding import glide_timestep_embedding as jax_glide

    from xdiffusion_tpu_torch.layers.embedding import glide_timestep_embedding

    t = np.array([0.0, 1.0, 250.5, 999.0], dtype=np.float32)
    want = np.asarray(jax_glide(jnp.asarray(t), dim))
    got = glide_timestep_embedding(torch.from_numpy(t), dim)
    assert got.shape == (4, dim)
    # XLA's and PyTorch's fp32 exp differ by an ulp on some frequencies
    # (<= 1), and t multiplies that before sin/cos: 2 ulps of t.
    tol = 2 * t.max() * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dim", [384, 128], ids=["dim%6==0", "dim%6==2"])
def test_ltx_rope_frequencies_match_jax(dim):
    from xdiffusion_tpu.score_networks.ltx_video import ltx_rope_frequencies as jax_rope

    from xdiffusion_tpu_torch.score_networks.ltx_video import ltx_rope_frequencies

    f, h, w = 8, 8, 8
    ids = np.stack(np.meshgrid(np.arange(f), np.arange(h), np.arange(w), indexing="ij"),
                   axis=-1).reshape(-1, 3).astype(np.int32)
    want_cos, want_sin = jax_rope(jnp.asarray(ids), dim, (20, 2048, 2048))
    cos, sin = ltx_rope_frequencies(torch.from_numpy(ids).long(), dim, (20, 2048, 2048))
    assert cos.shape == (f * h * w, dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(want_cos), atol=OPS_TOL, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(want_sin), atol=OPS_TOL, rtol=0)


def test_apply_ltx_rope_matches_jax():
    from xdiffusion_tpu.score_networks.ltx_video import _apply_ltx_rope as jax_apply

    from xdiffusion_tpu_torch.score_networks.ltx_video import _apply_ltx_rope

    rng = np.random.default_rng(3)
    t, cos, sin = _normal(rng, 2, 10, 16), _normal(rng, 10, 16), _normal(rng, 10, 16)
    want = np.asarray(jax_apply(jnp.asarray(t), jnp.asarray(cos), jnp.asarray(sin)))
    got = _apply_ltx_rope(torch.from_numpy(t), torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(got.numpy(), want, atol=OPS_TOL, rtol=OPS_TOL)


# ---- text conditioning -------------------------------------------------------


def test_hash_text_embedder_is_bit_equal_to_jax():
    from xdiffusion_tpu.layers.embedding import T5TextEmbedder as JaxT5
    from xdiffusion_tpu.layers.embedding import _HashEmbedFallback as JaxHash

    from xdiffusion_tpu_torch.layers.embedding import T5TextEmbedder, _HashEmbedFallback

    prompts = ["0", "7", "", "a moving digit"]
    for p in prompts:
        np.testing.assert_array_equal(_HashEmbedFallback(8, 32)(p), JaxHash(8, 32)(p))
    kw = dict(max_length=8, context_key="text_embeddings", embedding_dim=32)
    want = JaxT5(**kw)({"text_prompts": prompts})
    got = T5TextEmbedder(**kw)({"text_prompts": prompts})
    assert "text_attention_mask" not in want and "text_attention_mask" not in got
    assert got["text_embeddings"].dtype == torch.float32
    np.testing.assert_array_equal(got["text_embeddings"].numpy(),
                                  np.asarray(want["text_embeddings"]))


def test_text_embedder_refuses_the_real_encoder_and_blanks_prompts():
    from xdiffusion_tpu_torch.context import UnconditionalTextPromptsAdapter
    from xdiffusion_tpu_torch.layers.embedding import T5TextEmbedder

    with pytest.raises(NotImplementedError, match="t5-v1_1-base"):
        T5TextEmbedder(encoder="pretrained")
    ctx = {"text_prompts": ["1", "2"], "text_embeddings": torch.ones(2, 3, 4)}
    out = UnconditionalTextPromptsAdapter()(ctx)
    assert out["text_prompts"] == ["", ""]
    assert torch.equal(out["text_embeddings"], torch.zeros(2, 3, 4))
    assert ctx["text_prompts"] == ["1", "2"]  # the input is left as it was


# ---- rectified flow ----------------------------------------------------------


@pytest.mark.parametrize("distribution", ["logit-normal", "uniform", "uniform-clipped"])
def test_rectified_flow_scheduler_matches_jax(distribution):
    from xdiffusion_tpu.scheduler import rectified_flow_noise_scheduler as jax_factory

    from xdiffusion_tpu_torch.config import get_obj_from_str

    factory = get_obj_from_str("xdiffusion_tpu.scheduler.DiscreteRectifiedFlowNoiseScheduler")
    sched = factory(steps=1000, max_time=1.0, distribution=distribution)
    jsched = jax_factory(steps=1000, max_time=1.0, distribution=distribution)
    assert (sched.steps(), sched.epsilon, sched.continuous()) == (
        jsched.steps(), jsched.epsilon, jsched.continuous())
    rng = np.random.default_rng(4)
    x0, noise = _normal(rng, 3, 2, 4, 4, 1), _normal(rng, 3, 2, 4, 4, 1)
    t = np.array([0.001, 0.5, 0.97], dtype=np.float32)
    want = np.asarray(jsched.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    got = sched.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=OPS_TOL, rtol=OPS_TOL)
    times, weights = sched.sample_random_times(4096, torch.Generator().manual_seed(0))
    assert times.dtype == torch.float32 and torch.equal(weights, torch.ones(4096))
    assert sched.epsilon <= times.min() and times.max() <= sched.max_time


# ---- the transformer and the trajectory ----------------------------------------


@pytest.fixture(scope="module")
def ltx_pair():
    """(jax model, flax params, port model) of the small config, sharing
    seeded weights through the bridge."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxDDPM(JaxDotConfig(_load_small()))
    init = jmodel.init_params(jax.random.PRNGKey(0))
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}
    drawn = random_flax_params(flat, seed=11)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    pmodel = GaussianDiffusion_DDPM(DotConfig(_load_small()), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, params, pmodel


@pytest.mark.parametrize("variant", ["no mask", "text_attention_mask", "skip_layer_mask"])
def test_ltx_transformer_matches_jax(ltx_pair, variant):
    jmodel, params, pmodel = ltx_pair
    rng = np.random.default_rng(5)
    b = 2
    x = _normal(rng, b, 4, 4, 4, 1)
    ctx = {"timestep": np.array([0.1, 0.8], dtype=np.float32),
           "text_embeddings": _normal(rng, b, 8, 32)}
    if variant == "text_attention_mask":
        ctx["text_attention_mask"] = np.array([[1] * 5 + [0] * 3, [1] * 8], dtype=np.int32)
    elif variant == "skip_layer_mask":
        ctx["skip_layer_mask"] = np.array([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    # One jitted program compiles faster than the ops one by one.
    want = np.asarray(jax.jit(jmodel.predict_score)(
        params, jnp.asarray(x), {k: jnp.asarray(v) for k, v in ctx.items()}))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x),
                                   {k: torch.from_numpy(v) for k, v in ctx.items()})
    assert got.dtype == torch.float32 and got.shape == (b, 4, 4, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=NET_TOL * max(1.0, np.abs(want).max()),
                               rtol=0)


def test_rectified_flow_trajectory_matches_jax(ltx_pair):
    """10 Euler steps (the last 10 of the SDE's 1000, the reference quirk)
    with digit prompts, injected initial noise and per-step noise."""
    from xdiffusion_tpu.samplers.rectified_flow import AncestralSampler as JaxRF

    from xdiffusion_tpu_torch.samplers.rectified_flow import AncestralSampler

    jmodel, params, pmodel = ltx_pair
    steps, n = 10, 2
    rng = np.random.default_rng(6)
    init = _normal(rng, n, 4, 4, 4, 1)
    noise = _normal(rng, steps, n, 4, 4, 4, 1)
    assert type(pmodel._reverse_process_sampler) is AncestralSampler
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        sampler=JaxRF(), initial_noise=jnp.asarray(init),
        context={"text_prompts": ["0", "1"], "sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps,
                        initial_noise=torch.from_numpy(init),
                        context={"text_prompts": ["0", "1"],
                                 "sampling_noise": torch.from_numpy(noise)})
    assert got.shape == (n, 4, 4, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=NET_TOL, rtol=0)


def test_rectified_flow_guided_trajectory_matches_jax(ltx_pair):
    """4 Euler steps with classifier-free guidance: the empty-prompt
    unconditional context, both halves in one 2x-batch forward, velocities
    mixed as uncond + w * (cond - uncond)."""
    from xdiffusion_tpu.samplers.rectified_flow import AncestralSampler as JaxRF

    jmodel, params, pmodel = ltx_pair
    steps, n, w = 4, 2, 3.0
    init = _normal(np.random.default_rng(7), n, 4, 4, 4, 1)
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        sampler=JaxRF(), initial_noise=jnp.asarray(init), classifier_free_guidance=w,
        context={"text_prompts": ["0", "1"]}))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps, classifier_free_guidance=w,
                        initial_noise=torch.from_numpy(init),
                        context={"text_prompts": ["0", "1"]})
    unguided = pmodel.sample(num_samples=n, num_sampling_steps=steps,
                             initial_noise=torch.from_numpy(init),
                             context={"text_prompts": ["0", "1"]})
    assert np.abs(got.numpy() - unguided.numpy()).max() > 10 * NET_TOL
    np.testing.assert_allclose(got.numpy(), want, atol=NET_TOL, rtol=0)


def test_video_mask_splice_is_not_ported(ltx_pair):
    _, _, pmodel = ltx_pair
    with pytest.raises(NotImplementedError, match="video_mask"):
        pmodel.sample(num_samples=1, num_sampling_steps=1,
                      context={"video_mask": torch.ones(1, 4, dtype=torch.bool),
                               "x0": torch.zeros(1, 4, 4, 4, 1)})


# ---- the video sampling CLI ------------------------------------------------------


def test_ltx_targets_resolve_into_the_port():
    from xdiffusion_tpu_torch.config import get_obj_from_str

    targets = []

    def walk(node):
        if isinstance(node, dict):
            if "target" in node:
                targets.append(node["target"])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(_load_small())
    assert len(targets) == 7
    for t in targets:
        assert get_obj_from_str(t).__module__.startswith("xdiffusion_tpu_torch."), t


def _small_config_file(tmp_path):
    path = tmp_path / "ltx_small.yaml"
    path.write_text(yaml.safe_dump(_load_small()))
    return str(path)


def test_sample_video_cli_on_cpu_writes_a_frame_strip(tmp_path):
    from PIL import Image

    from xdiffusion_tpu_torch import sample_video as cli
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import randomize_

    config = _small_config_file(tmp_path)
    model = GaussianDiffusion_DDPM(load_yaml(config), device="cpu")
    randomize_(model.score_network(), 3)
    ckpt = tmp_path / "weights.pt"
    torch.save(model.score_network().state_dict(), ckpt)
    out_dir = tmp_path / "out"
    samples = cli.main(["--config_path", config, "--checkpoint", str(ckpt),
                        "--num_samples", "3", "--sampling_steps", "2",
                        "--output_path", str(out_dir), "--seed", "5", "--device", "cpu"])
    assert samples.shape == (3, 4, 4, 4, 1)
    img = np.asarray(Image.open(out_dir / "samples.png"))
    assert img.shape == (3 * 4, 4 * 4)  # one row per video, its 4 frames side by side
    want = (np.clip(samples.numpy()[1, 2, ..., 0], 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(img[4:8, 8:12], want)  # video 1, frame 2
    # The config is text-conditional, so the CLI samples with digit prompts.
    def sample(prompts):
        return model.sample(num_samples=3, num_sampling_steps=2,
                            context={"text_prompts": prompts},
                            generator=torch.Generator().manual_seed(5))

    torch.testing.assert_close(samples, sample(["0", "1", "2"]), atol=0.0, rtol=0.0)
    assert not torch.equal(samples, sample(["3", "4", "5"]))


def test_sample_video_cli_needs_a_card_or_cpu_and_has_no_schemes(monkeypatch, tmp_path):
    from xdiffusion_tpu_torch import sample_video as cli

    config = _small_config_file(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config_path", config, "--checkpoint", str(tmp_path / "none.pt")])
    with pytest.raises(NotImplementedError, match="sampling schemes"):
        cli.main(["--config_path", config, "--checkpoint", str(tmp_path / "none.pt"),
                  "--sampling_scheme_path", "scheme.yaml", "--device", "cpu"])
