"""Per-layer forward parity of the port against the JAX package, fp32 on the
CPU, with the same seeded weights on both sides (flax tree -> port through
xdiffusion_tpu_torch.weights) and inputs from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from flax import traverse_util

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

# fp32 on both sides; summation orders and the GroupNorm statistics' form
# (K3's two-pass against FastGroupNorm's one-pass) differ.
ATOL = 3e-5


def _normal(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _shared_params(jax_module, port_module, *init_args, seed=0, **init_kwargs):
    """Seeded weights for both: flax params (unflattened) and the port
    module loaded through the bridge."""
    variables = jax_module.init(jax.random.PRNGKey(0), *init_args, **init_kwargs)
    flat = {"/".join(k): v for k, v in
            traverse_util.flatten_dict(variables["params"]).items()}
    drawn = random_flax_params(flat, seed)
    load_flax_params(port_module, drawn)
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in drawn.items()})
    return {"params": tree}


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_scheduler_tables_equal_jax(schedule):
    from xdiffusion_tpu.scheduler import DiscreteNoiseScheduler as JaxSched

    from xdiffusion_tpu_torch.scheduler import DiscreteNoiseScheduler, discrete_noise_scheduler

    want = JaxSched.create(schedule_type=schedule, num_scales=1000)
    got = discrete_noise_scheduler(schedule_type=schedule, num_scales=1000,
                                   importance_sampler={"target": "unused"})
    assert isinstance(got, DiscreteNoiseScheduler) and got.steps() == 1000
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2",
                 "fixed_large_log_variance"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    t = np.array([0, 1, 17, 500, 999], dtype=np.int32)
    np.testing.assert_allclose(got.logsnr_from_index(torch.from_numpy(t).long()).numpy(),
                               np.asarray(want.logsnr_from_index(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c", [64, 12])
@pytest.mark.parametrize("form", ["plain", "silu", "scale_shift", "coefficients",
                                  "coefficients_scale_shift", "coefficients_channel_shift"])
def test_fast_group_norm_matches_jax(c, form):
    from xdiffusion_tpu.layers.resnet import FastGroupNorm as JaxGN

    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, num_groups_for

    rng = np.random.default_rng(1)
    groups = num_groups_for(c)
    x = _normal(rng, 2, 8, 8, c, scale=2.0, shift=0.3)
    ts, tsh, shift = (_normal(rng, 2, c, scale=0.3) for _ in range(3))
    silu = form != "plain"
    jmod = JaxGN(num_groups=groups, silu=silu)
    port = FastGroupNorm(c, groups, silu=silu)
    params = _shared_params(jmod, port, jnp.asarray(x))
    kwargs = {
        "plain": {}, "silu": {},
        "scale_shift": {"t_scale": ts, "t_shift": tsh},
        "coefficients": {"return_coefficients": True},
        "coefficients_scale_shift": {"t_scale": ts, "t_shift": tsh,
                                     "return_coefficients": True},
        "coefficients_channel_shift": {"channel_shift": shift, "return_coefficients": True},
    }[form]
    want = jmod.apply(params, jnp.asarray(x),
                      **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                         for k, v in kwargs.items()})
    got = port(torch.from_numpy(x),
               **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                  for k, v in kwargs.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("dim_in,dim_out,use_ss,use_conv", [
    (64, 64, True, False), (32, 64, True, False), (96, 64, True, True),
    (64, 64, False, False),
])
def test_resnet_block_biggan_fused_matches_jax_unfused(dim_in, dim_out, use_ss, use_conv):
    """The port's fused composition (coefficients + K4 for both convs)
    against the JAX package's default, unfused block."""
    from xdiffusion_tpu.layers import resnet as jax_resnet

    from xdiffusion_tpu_torch.layers.resnet import ResnetBlockBigGAN

    assert not jax_resnet._FUSED_RESBLOCK
    rng = np.random.default_rng(2)
    emb_dim = 128
    x = _normal(rng, 2, 8, 8, dim_in)
    emb = _normal(rng, 2, emb_dim)
    jmod = jax_resnet.ResnetBlockBigGAN(dim_out=dim_out, use_scale_shift_norm=use_ss,
                                        use_conv=use_conv, dropout=0.1)
    port = ResnetBlockBigGAN(dim_in, dim_out, emb_dim, use_scale_shift_norm=use_ss,
                             use_conv=use_conv, dropout=0.1)
    ctx = {"timestep_embedding": jnp.asarray(emb)}
    params = _shared_params(jmod, port, jnp.asarray(x), ctx)
    want = jmod.apply(params, jnp.asarray(x), ctx, deterministic=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), {"timestep_embedding": torch.from_numpy(emb)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c,dim_head", [(128, 32), (64, 64)])
def test_spatial_self_attention_matches_jax(c, dim_head):
    from xdiffusion_tpu.layers.attention import SpatialCrossAttention as JaxAttn

    from xdiffusion_tpu_torch.layers.attention import SpatialCrossAttention

    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 8, 8, c)
    jmod = JaxAttn(in_channels=c, context_dim=-1, heads=2, dim_head=dim_head)
    port = SpatialCrossAttention(c, context_dim=-1, heads=2, dim_head=dim_head)
    assert port.num_heads == c // dim_head
    params = _shared_params(jmod, port, jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_cross_attention_is_not_ported():
    """Cross-attention is ported (tests/test_torch_port_text.py holds it
    against JAX at 333 and 93 keys): a `context_dim` builds the encoder kv
    and, at 8x8 with 12 context tokens, matches the JAX layer."""
    from xdiffusion_tpu.layers.attention import SpatialCrossAttention as JaxAttn

    from xdiffusion_tpu_torch.layers.attention import SpatialCrossAttention

    rng = np.random.default_rng(4)
    x = _normal(rng, 2, 8, 8, 64)
    enc = _normal(rng, 2, 12, 32)
    jmod = JaxAttn(in_channels=64, context_dim=32, heads=2, dim_head=32)
    port = SpatialCrossAttention(64, context_dim=32, heads=2, dim_head=32)
    assert tuple(port.encoder_kv.weight.shape) == (128, 32)
    params = _shared_params(jmod, port, jnp.asarray(x), {"text_embeddings": jnp.asarray(enc)})
    want = jmod.apply(params, jnp.asarray(x), {"text_embeddings": jnp.asarray(enc)})
    with torch.no_grad():
        got = port(torch.from_numpy(x), {"text_embeddings": torch.from_numpy(enc)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


def test_timestep_embedding_projection_matches_jax():
    from xdiffusion_tpu.layers.embedding import TimestepEmbeddingProjection as JaxProj

    from xdiffusion_tpu_torch.layers.embedding import TimestepEmbeddingProjection

    t = np.array([0, 1, 250, 999], dtype=np.int32)
    jmod = JaxProj(num_features=32, time_embedding_mult=4)
    port = TimestepEmbeddingProjection(32, 4)
    params = _shared_params(jmod, port, jnp.asarray(t))
    want = jmod.apply(params, jnp.asarray(t))
    with torch.no_grad():
        got = port(torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


def test_plain_group_norm_matches_jax():
    from xdiffusion_tpu.ops.norm import group_norm as jax_group_norm

    from xdiffusion_tpu_torch.ops.norm import group_norm

    rng = np.random.default_rng(5)
    x = _normal(rng, 2, 4, 4, 64, scale=2.0, shift=0.3)
    scale, bias = _normal(rng, 64, scale=0.1, shift=1.0), _normal(rng, 64, scale=0.1)
    for silu in (False, True):
        want = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                              silu=silu)
        got = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), 32, silu=silu)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_resampling_convs_match_jax(kind):
    """resamp_with_conv: the stride-2 3x3 conv with symmetric padding, and
    nearest upsampling followed by a 3x3 conv."""
    from xdiffusion_tpu.layers import resnet as jax_resnet

    from xdiffusion_tpu_torch.layers import resnet

    x = _normal(np.random.default_rng(6), 2, 8, 8, 16)
    jcls, pcls = {"down": (jax_resnet.Downsample, resnet.Downsample),
                  "up": (jax_resnet.Upsample, resnet.Upsample)}[kind]
    jmod, port = jcls(channels=16, with_conv=True), pcls(16, with_conv=True)
    params = _shared_params(jmod, port, jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_resampling_matches_jax():
    from xdiffusion_tpu.layers.resnet import avg_pool_2x as jax_pool
    from xdiffusion_tpu.layers.resnet import nearest_upsample_2x as jax_up

    from xdiffusion_tpu_torch.layers.resnet import avg_pool_2x, nearest_upsample_2x

    x = _normal(np.random.default_rng(4), 2, 8, 8, 3)
    np.testing.assert_allclose(avg_pool_2x(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_pool(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(nearest_upsample_2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_up(jnp.asarray(x))))
