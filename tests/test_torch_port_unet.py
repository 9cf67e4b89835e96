"""The flagship UNet and its sampling trajectories: port against the JAX
package on the CPU, at num_features 32 with the flagship's [1, 2, 2, 2]
pyramid, the same seeded weights (flax tree -> port through the bridge)
and the same injected noise."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from flax import traverse_util

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs/image/mnist")
FLAGSHIP = os.path.join(CONFIG_DIR, "ddpm_32x32_epsilon_discrete.yaml")
# The UNet configs beside the flagship that the port runs: v target with the
# cosine schedule, an 8x8 UNet (2x2 maps), rectified flow and its sampler.
UNET_CONFIGS = ["ddpm_32x32_v_discrete.yaml", "ddpm_8x8_epsilon.yaml",
                "rectified_flow_32x32.yaml"]


def _small(config, dtype):
    sn = config.diffusion.score_network.params.to_dict()
    sn["num_features"] = 32
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    sn["dtype"] = dtype
    return config


@pytest.fixture(scope="module")
def build():
    """build(dtype) -> (dtype, jax model, flax params, port model) sharing
    seeded weights, built once per dtype."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = _build(dtype)
        return cache[dtype]

    return get


def _build(dtype, path=FLAGSHIP):
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxDDPM(_small(jax_load_yaml(path), dtype))
    # Only the tree's shapes are needed: trace the init, compile nothing.
    init = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}
    drawn = random_flax_params(flat, seed=7)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    pmodel = GaussianDiffusion_DDPM(_small(load_yaml(path), dtype), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return dtype, jmodel, params, pmodel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_forward_matches_jax(build, dtype):
    """fp32: summation order only, 2e-5 of the output's scale. bf16: both
    sides round activations to bf16 (2^-8 relative) at different points (the
    port's K3 normalises in fp32 and rounds once, JAX's FastGroupNorm applies
    its affine in bf16), through 22 residual blocks: 3% of the scale."""
    _, jmodel, params, pmodel = build(dtype)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    t = np.array([10, 900], dtype=np.int32)
    # Jitted: eager flax would compile each op on its own.
    want = np.asarray(jax.jit(jmodel.predict_score)(params, jnp.asarray(x),
                                                    {"timestep": jnp.asarray(t)}))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), {"timestep": torch.from_numpy(t).long()})
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 1)
    scale = np.abs(want).max()
    tol = 2e-5 * max(1.0, scale) if dtype == "float32" else 3e-2 * scale
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,sampler_name", [
    ("float32", "ddim"), ("float32", "ancestral"), ("bfloat16", "ancestral"),
])
def test_ten_step_trajectory_matches_jax(build, dtype, sampler_name):
    """10 steps with injected initial and per-step noise. fp32: 1e-3 on
    samples in [0, 1]; bf16 ancestral: 5e-2 (the per-forward bf16
    differences above, carried through 10 steps at t = 9..0). A bf16 DDIM
    trajectory is not compared point by point: its first step starts at
    t = 999, where x_hat = z / sqrt(alpha_bar) - ... multiplies the two
    sides' different bf16 roundings by ~158 before the clip to [-1, 1]."""
    from xdiffusion_tpu.samplers.ancestral import AncestralSampler as JaxAncestral
    from xdiffusion_tpu.samplers.ddim import DDIMSampler as JaxDDIM

    from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

    _, jmodel, params, pmodel = build(dtype)
    steps, n = 10, 2
    rng = np.random.default_rng(1)
    init = rng.standard_normal((n, 32, 32, 1)).astype(np.float32)
    noise = rng.standard_normal((steps, n, 32, 32, 1)).astype(np.float32)
    jsampler, psampler = {"ddim": (JaxDDIM(), DDIMSampler()),
                          "ancestral": (JaxAncestral(), AncestralSampler())}[sampler_name]
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        sampler=jsampler, initial_noise=jnp.asarray(init),
        context={"sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps, sampler=psampler,
                        initial_noise=torch.from_numpy(init),
                        context={"sampling_noise": torch.from_numpy(noise)})
    assert got.shape == (n, 32, 32, 1)
    tol = 1e-3 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("name", UNET_CONFIGS)
def test_unet_config_trajectory_matches_jax(name):
    """Each UNet config at num_features 32, fp32, with seeded flax weights
    through the bridge: 10 steps of the config's own sampler (ancestral, or
    rectified-flow Euler) with injected initial and per-step noise, within
    1e-3 of JAX's on samples in [0, 1] (summation order only)."""
    _, jmodel, params, pmodel = _build("float32", os.path.join(CONFIG_DIR, name))
    size = pmodel.config().diffusion.score_network.params.input_spatial_size
    steps, n = 10, 2
    rng = np.random.default_rng(2)
    init = rng.standard_normal((n, size, size, 1)).astype(np.float32)
    noise = rng.standard_normal((steps, n, size, size, 1)).astype(np.float32)
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        initial_noise=jnp.asarray(init), context={"sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps,
                        initial_noise=torch.from_numpy(init),
                        context={"sampling_noise": torch.from_numpy(noise)})
    assert got.shape == (n, size, size, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
