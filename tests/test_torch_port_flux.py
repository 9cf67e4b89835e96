"""Flux, Flux-DyT and Chewie in the port against the JAX package on the CPU:
the 3-axis RoPE tables and the interleaved-pair rotation, RoPE attention
(K5's plain version on the port's side), the offline CLIP embedder (bit for
bit), the double- and single-stream blocks with LayerNorm/RMS qk-norm and
with DyT, Chewie's pooling mixer and block, Flux's guidance embedding, and
the `flux`, `flux_dyt` and `chewie` configs at depth 2 (one double-, one
single-stream block) and hidden 128 (2 heads of 64): forward, loss, every
parameter's gradient against `jax.value_and_grad`, a 10-step guided Euler
trajectory; each config built at full width with JAX's parameter count.
The helpers are tests/test_torch_port_mmdit.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_mmdit import (
    TINY,
    check_forward,
    check_full_width,
    check_loss_and_gradients,
    check_trajectory,
    config_path,
    offline,
    shared_weights,
)

FLUX = ["flux", "flux_dyt", "chewie"]
AXES = (16, 24, 24)


def _ids(rng, b: int, n_txt: int, gh: int, gw: int) -> np.ndarray:
    """Flux's ids: text all zero, image (0, row, col)."""
    rows, cols = np.repeat(np.arange(gh), gw), np.tile(np.arange(gw), gh)
    img = np.stack([np.zeros_like(rows), rows, cols], -1)
    ids = np.concatenate([np.zeros((n_txt, 3)), img])[None].repeat(b, 0)
    return ids.astype(np.float32)


def test_rope_tables_and_rotation_match_jax():
    """cos and sin (B, L, 32) from the 3-axis ids, and the rotation of
    interleaved pairs on (B, H, L, 64): fp32, 1e-6 (the tables) and 1e-5 of
    the input's scale (the rotation); the port's ids are JAX's."""
    from xdiffusion_tpu.layers import flux as jf

    from xdiffusion_tpu_torch.layers import flux
    from xdiffusion_tpu_torch.score_networks.flux import image_ids

    rng = np.random.default_rng(0)
    ids = _ids(rng, 2, 5, 4, 4)
    np.testing.assert_array_equal(image_ids(2, 4, 4, "cpu").numpy(), ids[:, 5:])
    want = jf.rope_frequencies(jnp.asarray(ids), AXES, 10000.0)
    got = flux.rope_frequencies(torch.from_numpy(ids), AXES, 10000.0)
    for g, w in zip(got, want):
        assert g.shape == (2, 21, 32) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    x = rng.standard_normal((2, 3, 21, 64)).astype(np.float32)
    want_x = np.asarray(jf.apply_rope(jnp.asarray(x), *want))
    got_x = flux.apply_rope(torch.from_numpy(x), *got)
    assert got_x.is_contiguous()
    np.testing.assert_allclose(got_x.numpy(), want_x, atol=1e-5 * np.abs(x).max(), rtol=0)
    # Pairs, not halves: channel 1 rotates with channel 0.
    unit = np.zeros((1, 1, 21, 64), np.float32)
    unit[..., 0] = 1.0
    turned = flux.apply_rope(torch.from_numpy(unit), *(t[:1] for t in got))
    assert torch.equal(turned[0, 0, :, 1], got[1][0, :, 0]) and not turned[..., 32].any()


@pytest.mark.parametrize("n_txt,grid", [(128, 4), (5, 3)])
def test_rope_attention_matches_jax(n_txt, grid):
    """Joint RoPE attention at Flux's site (128 text and 16 image tokens,
    144 in all) and a ragged one (5 + 9), 2 heads of 64: fp32, 1e-5 of the
    output's scale."""
    from xdiffusion_tpu.layers import flux as jf

    from xdiffusion_tpu_torch.layers import flux

    rng = np.random.default_rng(n_txt)
    n = n_txt + grid * grid
    cos, sin = jf.rope_frequencies(jnp.asarray(_ids(rng, 2, n_txt, grid, grid)), AXES, 1e4)
    q, k, v = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jf.rope_attention(*(jnp.asarray(a) for a in (q, k, v)), cos, sin))
    got = flux.rope_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(np.asarray(cos)), torch.from_numpy(np.asarray(sin)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_clip_text_embedder_is_bit_equal_to_jax():
    """The pooled hash embedding (B, 768), bit for bit after checking JAX
    took its fallback; the prompts stay in the context, as in JAX;
    embeddings already there are left alone; the port's loader finds no
    CLIP checkpoint here, so the real path returns nothing and the hash path
    runs, as in JAX."""
    from xdiffusion_tpu.layers.embedding import CLIPTextEmbedder as JaxCLIP

    from xdiffusion_tpu_torch.layers.embedding import CLIPTextEmbedder

    prompts = ["0", "one", "", "a handwritten digit three", "zéro", "0"]
    jax_embedder = JaxCLIP(max_length=77, embedding_dim=768)
    offline([jax_embedder])
    assert jax_embedder._encode_real(prompts) is None  # JAX takes its hash fallback
    want = np.asarray(jax_embedder({"text_prompts": prompts})["clip_text_embeddings"])
    got = CLIPTextEmbedder(max_length=77, embedding_dim=768)({"text_prompts": prompts})
    assert sorted(got) == ["clip_text_embeddings", "text_prompts"]
    assert got["clip_text_embeddings"].dtype == torch.float32
    assert got["clip_text_embeddings"].shape == (6, 768)
    np.testing.assert_array_equal(got["clip_text_embeddings"].numpy(), want)
    ctx = {"text_prompts": ["1"], "clip_text_embeddings": torch.ones(1)}
    assert CLIPTextEmbedder()(ctx) is ctx
    embedder = CLIPTextEmbedder(max_length=77, embedding_dim=768)
    assert embedder._encode_real(prompts) is None
    np.testing.assert_array_equal(embedder({"text_prompts": prompts})[
        "clip_text_embeddings"].numpy(), want)


def _block_inputs(rng, n_txt: int = 12, grid: int = 4):
    from xdiffusion_tpu.layers import flux as jf

    img = rng.standard_normal((2, grid * grid, 128)).astype(np.float32)
    txt = rng.standard_normal((2, n_txt, 128)).astype(np.float32)
    vec = rng.standard_normal((2, 128)).astype(np.float32)
    cos, sin = (np.asarray(t) for t in jf.rope_frequencies(
        jnp.asarray(_ids(rng, 2, n_txt, grid, grid)), AXES, 1e4))
    return img, txt, vec, cos, sin


def _check_block(jmod, port, inputs) -> None:
    args = tuple(jnp.asarray(a) for a in inputs)
    params = shared_weights(jmod, port, *args)
    want = jax.jit(jmod.apply)(params, *args)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in inputs))
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("norm_cls", ["layernorm", "dyt"])
@pytest.mark.parametrize("block", ["double", "single"])
def test_stream_blocks_match_jax(block, norm_cls):
    """A double-stream block (12 text, 16 image tokens) and a single-stream
    block (the 28 merged), 2 heads of 64, with LayerNorm and RMS qk-norm or
    with DyT for both: fp32, 2e-5 of each output's scale."""
    from xdiffusion_tpu.layers import flux as jf

    from xdiffusion_tpu_torch.layers import flux

    img, txt, vec, cos, sin = _block_inputs(np.random.default_rng(21))
    if block == "double":
        _check_block(jf.DoubleStreamBlock(hidden_size=128, num_heads=2, norm_cls=norm_cls),
                     flux.DoubleStreamBlock(128, 2, norm_cls=norm_cls),
                     (img, txt, vec, cos, sin))
    else:
        merged = np.concatenate([txt, img], axis=1)
        _check_block(jf.SingleStreamBlock(hidden_size=128, num_heads=2, norm_cls=norm_cls),
                     flux.SingleStreamBlock(128, 2, norm_cls=norm_cls), (merged, vec, cos, sin))


@pytest.mark.parametrize("shape", [(2, 2, 144, 64), (1, 3, 5, 7), (1, 1, 1, 1)])
def test_pooling_token_mixer_matches_jax(shape):
    """avg_pool - x over the (L, D) plane, 3x3, padded taps left out of the
    count: against JAX's reduce_window sum over counts at Chewie's site (144
    tokens, head dim 64) and ragged planes, fp32 1e-6; a corner's mean is
    over its 4 in-bounds taps."""
    from xdiffusion_tpu.layers.chewie import pooling_token_mixer as jax_mixer

    from xdiffusion_tpu_torch.layers.chewie import pooling_token_mixer

    x = np.random.default_rng(22).standard_normal(shape).astype(np.float32)
    got = pooling_token_mixer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mixer(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    if shape[2] > 1 and shape[3] > 1:
        corner = x[0, 0, :2, :2].mean() - x[0, 0, 0, 0]
        np.testing.assert_allclose(got[0, 0, 0, 0].item(), corner, atol=1e-6)


def test_chewie_block_matches_jax():
    """Chewie's pooling double-stream block (12 text, 16 image tokens, 2
    heads of 64; no q, k, v): fp32, 2e-5 of each output's scale."""
    from xdiffusion_tpu.layers.chewie import ChewieDoubleStreamBlock as JaxBlock

    from xdiffusion_tpu_torch.layers.chewie import ChewieDoubleStreamBlock

    port = ChewieDoubleStreamBlock(128, 2, qkv_bias=True)
    assert not any("qkv" in n for n, _ in port.named_parameters())
    _check_block(JaxBlock(hidden_size=128, num_heads=2, qkv_bias=True), port,
                 _block_inputs(np.random.default_rng(23)))


def test_flux_guidance_embedding_matches_jax():
    """Flux with `guidance_embed` (the distilled variant): the guidance
    scale's GLIDE features of 1000 * g through `guidance_in` join the
    conditioning vector: the forward at fp32 2e-5 of the output's scale,
    and it moves with the scale."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.score_networks.flux import Flux as JaxFlux

    from xdiffusion_tpu_torch.config import DotConfig, load_yaml
    from xdiffusion_tpu_torch.score_networks.flux import Flux

    params = load_yaml(config_path("flux")).diffusion.score_network.params.to_dict()
    params.update(TINY["flux"], guidance_embed=True)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    ctx = {"timestep": np.float32([0.3, 0.9]), "distillation_guidance": np.float32([1.0, 4.0]),
           "t5_text_embeddings": rng.standard_normal((2, 7, 768)).astype(np.float32),
           "clip_text_embeddings": rng.standard_normal((2, 768)).astype(np.float32)}
    jmod, port = JaxFlux(JaxDotConfig(params)), Flux(DotConfig(params))
    jctx = {k: jnp.asarray(v) for k, v in ctx.items()}
    variables = shared_weights(jmod, port, jnp.asarray(x), jctx)
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x), jctx))
    pctx = {k: torch.from_numpy(v) for k, v in ctx.items()}
    with torch.no_grad():
        got = port(torch.from_numpy(x), pctx)
        moved = port(torch.from_numpy(x), {**pctx, "distillation_guidance": torch.zeros(2)})
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * np.abs(want).max(), rtol=0)
    assert (moved - got).abs().max().item() > 1e-3


@pytest.mark.parametrize("name", FLUX)
def test_forward_matches_jax(name):
    check_forward(name)


def _sum_pool_mixer(x, pool_size: int = 3):
    """JAX's pooling mixer with Python-scalar init values, so that
    `lax.reduce_window` takes its summing form, which jit can differentiate.
    The JAX package's own passes `jnp.array(0)`: under jit that init is
    traced, the general reduce_window has no linearization rule, and its
    jitted training step fails on chewie.yaml (its eager gradient works,
    and agrees with this one's)."""
    pad = pool_size // 2
    window, strides = (1, 1, pool_size, pool_size), (1, 1, 1, 1)
    padding = ((0, 0), (0, 0), (pad, pad), (pad, pad))
    summed = jax.lax.reduce_window(x, 0.0, jax.lax.add, window, strides, padding)
    counts = jax.lax.reduce_window(jnp.ones((1, 1) + x.shape[2:], x.dtype), 0.0, jax.lax.add,
                                   window, strides, padding)
    return summed / counts - x


@pytest.mark.parametrize("name", FLUX)
def test_loss_and_every_gradient_match_jax(name, monkeypatch):
    """Chewie's JAX side runs with `_sum_pool_mixer` in place of its mixer,
    whose forward it first matches bit for bit: the port's `F.avg_pool2d`
    trains chewie.yaml where the JAX package's jitted step cannot."""
    if name == "chewie":
        from xdiffusion_tpu.layers import chewie as jax_chewie

        x = jnp.asarray(np.random.default_rng(26).standard_normal((2, 2, 144, 64)), jnp.float32)
        np.testing.assert_array_equal(np.asarray(_sum_pool_mixer(x)),
                                      np.asarray(jax_chewie.pooling_token_mixer(x)))
        monkeypatch.setattr(jax_chewie, "pooling_token_mixer", _sum_pool_mixer)
    check_loss_and_gradients(name)


@pytest.mark.parametrize("name", FLUX)
def test_guided_trajectory_matches_jax(name):
    check_trajectory(name)


@pytest.mark.parametrize("name", FLUX)
def test_config_builds_at_full_width_with_jax_parameter_count(name):
    check_full_width(name)


def test_rope_attention_keeps_k5_operands_aligned(monkeypatch):
    """What K5 checks on the card (unit stride on D, 16-byte aligned rows),
    held here on the CPU: the rotated q and k and the joint v that Flux's
    blocks hand `dot_product_attention`."""
    from xdiffusion_tpu_torch.layers import flux
    from xdiffusion_tpu_torch.ops.flash_attention import _rows_aligned

    img, txt, vec, cos, sin = (torch.from_numpy(a) for a in
                               _block_inputs(np.random.default_rng(25), n_txt=128))
    seen = []
    real = flux.dot_product_attention

    def spy(q, k, v, *args, **kwargs):
        seen.append((q, k, v))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(flux, "dot_product_attention", spy)
    with torch.no_grad():
        flux.DoubleStreamBlock(128, 2)(img, txt, vec, cos, sin)
        flux.SingleStreamBlock(128, 2)(torch.cat([txt, img], 1), vec, cos, sin)
    assert len(seen) == 2
    for q, k, v in seen:
        assert q.shape == k.shape == v.shape == (2, 2, 144, 64)
        assert all(_rows_aligned(t) for t in (q, k, v))

