"""Text conditioning in the port against the JAX package on the CPU: the
BPE tokenizer and its assets, the hash CLIP embedder, the prompt
preprocessors and guidance adapters, cross-attention with encoder keys, the
GLIDE transformer, Imagen's pooled-text head, the guidance drop in the loss,
and the text-conditioned UNet configs (forward, 10-step guided trajectory,
loss) at num_features 32 with the same seeded weights (flax tree -> port
through the bridge) and the same injected noise. The helpers serve
tests/test_torch_port_continuous.py too."""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import no_transformers, one_torch_thread  # noqa: F401 (autouse)
from flax import traverse_util

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_CONFIGS = ["mnist/ddpm_epsilon_clip", "mnist/ddpm_8x8_epsilon_clip",
                "cifar10/ddpm_32x32_epsilon_discrete_clip", "mnist/glide", "mnist/imagen_base"]
CONTINUOUS_CONFIGS = ["mnist/ddpm_32x32_epsilon_continuous", "mnist/ddpm_32x32_v_continuous",
                      "mnist/ddpm_32x32_v_continuous_clip"]
PROMPTS = ["3", "seven"]
TEN_PROMPTS = ["0", "one", "a handwritten digit three", "Four!", "five and six", "",
               "Seven  eight", "the number 9's shape", "zéro", "12345678901234567890"]


def config_path(name: str) -> str:
    return os.path.join(REPO, "configs/image", name + ".yaml")


def small(config, dtype: str = "float32", depth: int = 2, hidden: int = 128):
    """The config at num_features 32 (the timestep embedding 128 wide, and
    the heads that add onto it with it) in `dtype`; every other width as
    shipped. A PixArt transformer (one with a `hidden_size`) at depth 2,
    hidden 128 and 2 heads of 64 (or at `depth` and `hidden` over 2 heads),
    its timestep, class and caption projections as wide (the T5 table as
    shipped)."""
    sn = config.diffusion.score_network.params.to_dict()
    if "hidden_size" in sn:
        sn.update(depth=depth, hidden_size=hidden, num_heads=2)
        projections = sn["conditioning"]["projections"]
        for name in ("timestep", "classes"):
            if name in projections:
                projections[name]["params"]["hidden_size"] = hidden
        for head in sn["conditioning"]["context_transformer_head"]:
            if head["target"].endswith("ContextProjection"):
                head["params"].update(hidden_features=hidden, out_features=hidden)
        return config
    sn["num_features"] = 32
    sn["dtype"] = dtype
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    for head in sn["conditioning"]["context_transformer_head"]:
        params = head.get("params") or {}
        for key in ("output_projection_dimension", "time_embedding_dim"):
            if key in params:
                params[key] = 128
    return config


_BUILT = {}


def build(name: str, dtype: str = "float32", **widths):
    """(jax model, flax params, port model) sharing seeded weights, built
    once per (config, dtype, `small`'s widths)."""
    key = (name, dtype, tuple(sorted(widths.items())))
    if key not in _BUILT:
        from xdiffusion_tpu.config import load_yaml as jax_load_yaml
        from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

        from xdiffusion_tpu_torch.config import load_yaml
        from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

        jmodel = JaxDDPM(small(jax_load_yaml(config_path(name)), dtype, **widths))
        # Only the tree's shapes are needed: trace the init, compile nothing.
        x, ctx = jmodel.example_batch(2)
        init = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
        flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}
        drawn = random_flax_params(flat, seed=7)
        params = {"params": traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
        pmodel = GaussianDiffusion_DDPM(small(load_yaml(config_path(name)), dtype, **widths),
                                        device="cpu")
        load_flax_params(pmodel.score_network(), drawn)
        _BUILT[key] = jmodel, params, pmodel
    return _BUILT[key]


def spatial(pmodel):
    sn = pmodel.config().diffusion.score_network.params
    return sn.input_spatial_size, sn.input_channels


def arrays(ctx):
    """The context's array signals (the prompt lists left out)."""
    return {k: v for k, v in ctx.items() if not isinstance(v, (list, tuple, str))}


def forward_contexts(jmodel, pmodel, t):
    """The same prompts through each side's preprocessors, with timesteps t
    (and, for a continuous schedule, logsnr_t)."""
    jctx = arrays(jmodel.preprocess_context({"text_prompts": PROMPTS}))
    pctx = arrays(pmodel.preprocess_context({"text_prompts": PROMPTS}))
    assert sorted(jctx) == sorted(pctx)
    jctx["timestep"], pctx["timestep"] = jnp.asarray(t), torch.from_numpy(t)
    if pmodel.noise_scheduler().continuous():
        jctx["logsnr_t"] = jmodel.noise_scheduler().logsnr(jnp.asarray(t))
        pctx["logsnr_t"] = pmodel.noise_scheduler().logsnr(torch.from_numpy(t))
    elif t.dtype == np.int32:
        pctx["timestep"] = pctx["timestep"].long()
    return jctx, pctx


def times(pmodel, n: int = 2, seed: int = 0) -> np.ndarray:
    """n times: uniform in (0, 1) on a continuous schedule, else steps."""
    rng = np.random.default_rng(seed)
    if pmodel.noise_scheduler().continuous():
        return rng.uniform(0.02, 0.98, size=n).astype(np.float32)
    return rng.integers(0, 1000, size=n).astype(np.int32)


def check_forward(name: str, dtype: str = "float32", **widths):
    """The UNet forward with prompts: fp32 2e-5 of the output's scale
    (summation orders); bf16 3e-2 of it (roundings at different points)."""
    jmodel, params, pmodel = build(name, dtype, **widths)
    size, ch = spatial(pmodel)
    x = np.random.default_rng(0).standard_normal((2, size, size, ch)).astype(np.float32)
    jctx, pctx = forward_contexts(jmodel, pmodel, times(pmodel))
    want = np.asarray(jax.jit(jmodel.predict_score)(params, jnp.asarray(x), jctx))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), pctx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    tol = 2e-5 * max(1.0, scale) if dtype == "float32" else 3e-2 * scale
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def check_trajectory(name: str, dtype: str = "float32", sampler: str = "config", **widths):
    """10 steps of the config's sampler (or DDIM) with prompts, the config's
    guidance (one forward on the doubled batch) and injected initial and
    per-step noise: 1e-3 (fp32) or 5e-2 (bf16) on samples in [0, 1]."""
    jmodel, params, pmodel = build(name, dtype, **widths)
    size, ch = spatial(pmodel)
    steps, n = 10, len(PROMPTS)
    rng = np.random.default_rng(1)
    init = rng.standard_normal((n, size, size, ch)).astype(np.float32)
    noise = rng.standard_normal((steps, n, size, size, ch)).astype(np.float32)
    samplers = {"config": (None, None)}
    if sampler == "ddim":
        from xdiffusion_tpu.samplers.ddim import DDIMSampler as JaxDDIM

        from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

        samplers["ddim"] = (JaxDDIM(), DDIMSampler())
    jsampler, psampler = samplers[sampler]
    guidance = pmodel.classifier_free_guidance() or None
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        sampler=jsampler, initial_noise=jnp.asarray(init), classifier_free_guidance=guidance,
        context={"text_prompts": PROMPTS, "sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps, sampler=psampler,
                        initial_noise=torch.from_numpy(init), classifier_free_guidance=guidance,
                        context={"text_prompts": PROMPTS,
                                 "sampling_noise": torch.from_numpy(noise)})
    assert tuple(got.shape) == (n, size, size, ch)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3 if dtype == "float32" else 5e-2,
                               rtol=0)


def check_loss(name: str, drop: float = 0.0):
    """loss_on_batch with prompts, injected times and noise and dropout
    off, the guidance drop at probability `drop` (0: none, 1: every
    example, which both sides take without drawing): loss and per-example
    losses to 1e-5 relative."""
    jmodel, params, pmodel = build(name)
    size, ch = spatial(pmodel)
    rng = np.random.default_rng(3)
    images = rng.random((2, size, size, ch)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    t = times(pmodel, seed=4)
    jctx = arrays(jmodel.preprocess_context({"text_prompts": PROMPTS}))
    pctx = arrays(pmodel.preprocess_context({"text_prompts": PROMPTS}))
    saved = jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability
    jmodel._unconditional_guidance_probability = pmodel._unconditional_guidance_probability = drop
    try:
        jax_loss = jax.jit(jmodel.loss_on_batch, static_argnames=("deterministic",))
        want, want_m = jax_loss(
            params, jax.random.PRNGKey(1), jnp.asarray(images), jctx, timesteps=jnp.asarray(t),
            noise=jnp.asarray(noise), deterministic=True)
        tt = torch.from_numpy(t)
        got, got_m = pmodel.loss_on_batch(
            torch.from_numpy(images), pctx, timesteps=tt if tt.is_floating_point() else tt.long(),
            noise=torch.from_numpy(noise), deterministic=True)
    finally:
        jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability = saved
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["loss_per_example"].numpy(),
                               np.asarray(want_m["loss_per_example"]), rtol=1e-5)
    return got.item()


# ---- tokenizer, embedder, preprocessors -------------------------------------


def test_tokenizer_assets_are_byte_identical_to_jax():
    for asset in ("encoder.json.gz", "vocab.bpe.gz"):
        digests = []
        for package in ("xdiffusion_tpu", "xdiffusion_tpu_torch"):
            with open(os.path.join(REPO, package, "tokenizer", asset), "rb") as f:
                digests.append(hashlib.sha256(f.read()).hexdigest())
        assert digests[0] == digests[1], asset


@pytest.mark.parametrize("length", [8, 128])
def test_bpe_tokenizer_matches_jax_on_ten_prompts(length):
    from xdiffusion_tpu.tokenizer import get_encoder as jax_encoder

    from xdiffusion_tpu_torch.tokenizer import get_encoder

    want = jax_encoder().tokenize(TEN_PROMPTS, length)
    got = get_encoder().tokenize(TEN_PROMPTS, length)
    assert got.dtype == np.int32 and got.shape == (10, length)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] != 0 and got[5].max() == 0  # "0" has an id; "" pads


def test_prompt_preprocessors_match_jax():
    """GPT-2 tokens (GLIDE, 128), T5 tokens (% 32128, 77), CLIP tokens
    (% 49408), the host-side T5 projection: the same int32 ids, the
    prompts popped where JAX pops them."""
    from xdiffusion_tpu import context as jctx_mod
    from xdiffusion_tpu.layers import clip as jclip
    from xdiffusion_tpu.layers.embedding import T5TextPromptsToTokens as JaxT5Tokens

    from xdiffusion_tpu_torch import context
    from xdiffusion_tpu_torch.layers import clip
    from xdiffusion_tpu_torch.layers.embedding import T5TextPromptsToTokens

    pairs = [
        (jctx_mod.TextPromptsPreprocessor(text_context_size=128),
         context.TextPromptsPreprocessor(text_context_size=128)),
        (jctx_mod.T5TextPromptsPreprocessor(max_length=77),
         context.T5TextPromptsPreprocessor(max_length=77)),
        (jctx_mod.CLIPTextPromptsPreprocessor(text_sequence_length=77),
         context.CLIPTextPromptsPreprocessor(text_sequence_length=77)),
        (jclip.FrozenCLIPTextTokenizer(max_length=77), clip.FrozenCLIPTextTokenizer(max_length=77)),
    ]
    for jax_pre, port_pre in pairs:
        want = jax_pre({"text_prompts": TEN_PROMPTS})
        got = port_pre({"text_prompts": TEN_PROMPTS})
        assert sorted(got) == sorted(want), type(port_pre).__name__
        assert got["text_tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["text_tokens"].numpy(), np.asarray(want["text_tokens"]))
    np.testing.assert_array_equal(T5TextPromptsToTokens(max_length=20)(TEN_PROMPTS).numpy(),
                                  np.asarray(JaxT5Tokens(max_length=20)(TEN_PROMPTS)))


def test_clip_hash_embedder_is_bit_equal_to_jax_fallback():
    from xdiffusion_tpu.layers.clip import FrozenCLIPEmbedder as JaxCLIP

    from xdiffusion_tpu_torch.layers.clip import FrozenCLIPEmbedder

    jax_embedder = JaxCLIP(max_length=77, embedding_dim=768)
    assert jax_embedder._model is None  # JAX took its hash fallback
    port = FrozenCLIPEmbedder(max_length=77, embedding_dim=768)
    prompts = TEN_PROMPTS + TEN_PROMPTS[:3]  # repeats come from the memo
    want = np.asarray(jax_embedder({"text_prompts": prompts})["text_embeddings"])
    for _ in range(2):
        got = port({"text_prompts": prompts})["text_embeddings"]
        assert got.dtype == torch.float32 and got.shape == (13, 77, 768)
        np.testing.assert_array_equal(got.numpy(), want)
    ctx = {"text_prompts": ["1"], "text_embeddings": torch.ones(1)}
    assert port(ctx) is ctx  # embeddings already there: left alone


def test_unconditional_adapters_zero_tensors_and_arrays_in_their_dtype():
    from xdiffusion_tpu import context as jctx_mod

    from xdiffusion_tpu_torch import context

    tokens = np.arange(6, dtype=np.int32).reshape(2, 3) + 1
    emb = np.ones((2, 3, 4), dtype=np.float32)
    want = jctx_mod.UnconditionalTextPromptsAdapter()(
        {"text_prompts": ["1", "2"], "text_tokens": tokens, "text_embeddings": emb})
    for tok, e in ((torch.from_numpy(tokens), torch.from_numpy(emb)), (tokens, emb)):
        ctx = {"text_prompts": ["1", "2"], "text_tokens": tok, "text_embeddings": e}
        out = context.UnconditionalTextPromptsAdapter()(ctx)
        assert out["text_prompts"] == want["text_prompts"] == ["", ""]
        assert sorted(out) == sorted(want)
        assert type(out["text_tokens"]) is type(tok)
        assert out["text_tokens"].dtype == tok.dtype and out["text_embeddings"].dtype == e.dtype
        assert not np.asarray(out["text_tokens"]).any() and not np.asarray(out["text_embeddings"]).any()
        assert np.asarray(ctx["text_tokens"]).all()  # the input is left as it was
        out = context.UnconditionalEmbeddingAdapter()(ctx)
        assert not np.asarray(out["text_embeddings"]).any() and np.asarray(out["text_tokens"]).all()


def test_signal_selectors_and_token_projection_adapter():
    from xdiffusion_tpu_torch import context

    ctx = {"text_tokens": torch.ones(2, 3, dtype=torch.int32), "text_embeddings": torch.ones(2, 3, 4),
           "context_embedding": torch.zeros(2, 3, 4)}
    assert context.TextTokenAdapter()(ctx) is ctx["text_tokens"]
    assert context.ContextEmbeddingAdapter()(ctx) is ctx["context_embedding"]
    assert context.TextEmbeddingsAdapter(swap_context_channels=True)(ctx) is ctx["text_embeddings"]
    out = context.TextTokenProjectionAdapter()(ctx, {"text_tokens": lambda t, c: t.float() * 2})
    assert torch.equal(out["text_embeddings"], torch.full((2, 3), 2.0))


def test_labels_to_prompts_are_seeded_by_the_rng():
    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts

    labels = np.arange(20) % 10
    first = convert_labels_to_prompts(labels, rng=np.random.default_rng((0, 5)))
    assert first == convert_labels_to_prompts(labels, rng=np.random.default_rng((0, 5)))
    assert all(p in (str(l), ["zero", "one", "two", "three", "four", "five", "six", "seven",
                              "eight", "nine"][l]) for p, l in zip(first, labels))


# ---- layers -----------------------------------------------------------------


def _shared(jax_module, port_module, *args, seed=0):
    """Draws the flax module's parameters (their shapes from jax.eval_shape
    of init: no real init), loads them into the port module, returns the
    flax variables."""
    variables = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *args)
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(variables["params"]).items()}
    drawn = random_flax_params(flat, seed)
    load_flax_params(port_module, drawn)
    return {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}


@pytest.mark.parametrize("size,norm,dtype", [(16, False, "float32"), (4, False, "float32"),
                                             (16, True, "float32"), (4, True, "bfloat16")])
def test_cross_attention_with_encoder_keys_matches_jax(size, norm, dtype):
    """SpatialCrossAttention with a 77-token context at 16x16 (333 keys) and
    4x4 (93 keys), with and without the gain-only context LayerNorm; the
    JAX side takes its XLA attention at these key counts. fp32 3e-5; bf16
    3e-2 of the output's scale."""
    from xdiffusion_tpu.layers.attention import SpatialCrossAttention as JaxAttn

    from xdiffusion_tpu_torch.layers.attention import SpatialCrossAttention

    jdt, pdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    c, ctx_dim = 128, 96
    adapter = {"target": "xdiffusion_tpu.context.ContextEmbeddingAdapter", "params": {}}
    jmod = JaxAttn(in_channels=c, context_dim=ctx_dim, heads=2, dim_head=64,
                   context_adapter=adapter, context_layer_norm=norm, dtype=jdt)
    port = SpatialCrossAttention(c, context_dim=ctx_dim, heads=2, dim_head=64,
                                 context_adapter=adapter, context_layer_norm=norm, dtype=pdt)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, size, size, c)).astype(np.float32)
    enc = rng.standard_normal((2, 77, ctx_dim)).astype(np.float32)
    params = _shared(jmod, port, jnp.asarray(x), {"context_embedding": jnp.asarray(enc)})
    assert (port.context_norm is not None) == norm
    assert not norm or port.context_norm.bias is None  # gain only
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x),
                                          {"context_embedding": jnp.asarray(enc)}),
                      dtype=np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x), {"context_embedding": torch.from_numpy(enc)})
    assert got.shape == (2, size, size, c)
    scale = np.abs(want - x).max()
    tol = 3e-5 if dtype == "float32" else 3e-2 * scale
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_glide_transformer_head_matches_jax():
    """GLIDETransformerWrapper (2 layers, one head of 128, as GLIDE's) on
    16 tokens: context_embedding and the timestep embedding it adds to."""
    from xdiffusion_tpu.layers.embedding import TextTokenProjection as JaxTok
    from xdiffusion_tpu.layers.transformer import GLIDETransformerWrapper as JaxGlide

    from xdiffusion_tpu_torch.layers.embedding import TextTokenProjection
    from xdiffusion_tpu_torch.layers.transformer import GLIDETransformerWrapper

    import flax.linen as fnn

    class JaxHead(fnn.Module):
        @fnn.compact
        def __call__(self, ctx):
            proj = {"text_tokens": JaxTok(token_vocabulary_size=300, width=128, name="tok")}
            return JaxGlide(context_dim=128, width=128, layers=2, heads=1,
                            output_projection_dimension=64, name="glide")(ctx, proj)

    class PortHead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.tok = TextTokenProjection(300, 128)
            self.glide = GLIDETransformerWrapper(context_dim=128, width=128, layers=2, heads=1,
                                                 output_projection_dimension=64)

        def forward(self, ctx):
            return self.glide(ctx, {"text_tokens": self.tok})

    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 300, size=(2, 16)).astype(np.int32)
    temb = rng.standard_normal((2, 64)).astype(np.float32)
    jctx = {"text_tokens": jnp.asarray(tokens), "timestep_embedding": jnp.asarray(temb)}
    port = PortHead()
    params = _shared(JaxHead(), port, jctx)
    want = jax.jit(JaxHead().apply)(params, jctx)
    with torch.no_grad():
        got = port({"text_tokens": torch.from_numpy(tokens),
                    "timestep_embedding": torch.from_numpy(temb)})
    for key in ("context_embedding", "timestep_embedding"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=3e-5, rtol=3e-5,
                                   err_msg=key)


def test_pooled_text_head_and_context_projection_match_jax():
    from xdiffusion_tpu.layers.embedding import ContextProjection as JaxCP
    from xdiffusion_tpu.layers.embedding import PooledTextEmbeddingsToTimestep as JaxPool

    from xdiffusion_tpu_torch.layers.embedding import (
        ContextProjection,
        PooledTextEmbeddingsToTimestep,
    )

    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2, 77, 256)).astype(np.float32)
    temb = rng.standard_normal((2, 96)).astype(np.float32)
    jctx = {"text_embeddings": jnp.asarray(emb), "timestep_embedding": jnp.asarray(temb)}
    pctx = {"text_embeddings": torch.from_numpy(emb), "timestep_embedding": torch.from_numpy(temb)}
    cases = [
        (JaxPool(text_embedding_dim=256, time_embedding_dim=96, attention_pooling_heads=64),
         PooledTextEmbeddingsToTimestep(256, 96, attention_pooling_heads=64),
         "timestep_embedding"),
        (JaxCP(input_context_key="text_embeddings", output_context_key="context_embedding",
               in_features=256, hidden_features=64, out_features=32),
         ContextProjection("text_embeddings", "context_embedding", 256, 64, 32),
         "context_embedding"),
    ]
    for jmod, port, key in cases:
        params = _shared(jmod, port, jctx)
        want = jax.jit(jmod.apply)(params, jctx)
        with torch.no_grad():
            got = port(pctx)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=3e-5,
                                   rtol=3e-5, err_msg=type(port).__name__)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    import flax.linen as fnn

    from xdiffusion_tpu_torch.layers.norm import LayerNorm

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = (np.random.default_rng(8).standard_normal((3, 5, 64)) * 2 + 0.5).astype(np.float32)
    for use_bias, eps in ((True, 1e-6), (False, 1e-5)):
        jmod = fnn.LayerNorm(use_bias=use_bias, epsilon=eps, dtype=jdt)
        port = LayerNorm(64, eps=eps, use_bias=use_bias, dtype=getattr(torch, dtype))
        params = _shared(jmod, port, jnp.asarray(x))
        want = np.asarray(jmod.apply(params, jnp.asarray(x)), dtype=np.float32)
        got = port(torch.from_numpy(x)).detach()
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=1e-5 if dtype == "float32" else 2e-2, rtol=0)


# ---- the configs --------------------------------------------------------------


@pytest.mark.parametrize("name", TEXT_CONFIGS + CONTINUOUS_CONFIGS)
def test_config_builds_at_full_width_on_the_cpu(name):
    """Each of the eight configs as shipped: the port builds it and
    registers every head with parameters as `_context_heads_<i>`, its flax
    name, so .to(), the optimizer, EMA, checkpoints and the bridge see it
    (the bridge's mapping itself is checked leaf by leaf by every
    num_features-32 build here)."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    model = GaussianDiffusion_DDPM(load_yaml(config_path(name)), device="cpu")
    net = model.score_network()
    names = {n.split(".")[0] for n, _ in net.named_parameters()}
    for i, head in enumerate(net._context_heads):
        has_params = isinstance(head, torch.nn.Module) and any(True for _ in head.parameters())
        assert (f"_context_heads_{i}" in names) == has_params, (name, i)
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in net.parameters())


@pytest.mark.parametrize("name", TEXT_CONFIGS)
def test_text_config_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", TEXT_CONFIGS)
def test_text_config_guided_trajectory_matches_jax(name):
    check_trajectory(name)


@pytest.mark.parametrize("name", TEXT_CONFIGS)
def test_text_config_loss_matches_jax(name):
    check_loss(name)


@pytest.mark.parametrize("name", ["mnist/ddpm_epsilon_clip", "mnist/glide"])
def test_guidance_drop_of_embeddings_and_tokens_matches_jax(name):
    """With the drop at probability 1 every example trains unconditionally:
    the CLIP config's fp32 embeddings and GLIDE's int32 tokens are zeroed
    (the tokens stay integers), as in the JAX loss, and the loss moves."""
    assert check_loss(name, drop=1.0) != check_loss(name, drop=0.0)
