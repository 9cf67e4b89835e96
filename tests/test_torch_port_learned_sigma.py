"""Learned sigma in the port against the JAX package on the CPU: the
Gaussian KL and discretised-likelihood helpers, the hybrid loss (the
variational bound in bits, scaled by 1e-3, on a detached prediction), the
UNet's doubled output head, and learned-range ancestral sampling, with and
without guidance, on `ddpm_unconditional_learned_sigma.yaml` at
num_features 32 with the same seeded weights and injected noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_text import build, spatial

NAME = "mnist/ddpm_unconditional_learned_sigma"


def _helpers_inputs():
    """x on the bin grid of [-1, 1] (its ends included), means near and far
    from x, log-scales from -12 (a spike) to 4 (a flat Gaussian)."""
    rng = np.random.default_rng(0)
    x = (np.concatenate([[0, 255, 1, 254, 127, 128], rng.integers(0, 256, 58)])
         .astype(np.float32) / np.float32(127.5) - np.float32(1.0))
    x = np.tile(x, 8)
    means = (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)
    means[::7] = rng.uniform(-3, 3, means[::7].shape)
    log_scales = np.repeat(np.float32([-12.0, -8.0, -5.0, -3.0, -1.0, 0.0, 2.0, 4.0]), 64)
    return x, means, log_scales


def test_helpers_match_jax_at_the_bin_ends_and_extreme_scales():
    """discretized_gaussian_log_likelihood at x = +-1 (the one-sided tails),
    interior bins and log-scales from -12 to 4 (where the tanh CDF
    saturates and each log hits its 1e-12 floor): 1e-5 relative and 1e-6
    absolute, plus the cancellation of the CDF: XLA's tanh (a rational
    approximation) and torch's differ by up to 2 ulps, so each CDF value by
    up to 2^-24, and the log of the bin's mass p moves by up to
    4 * 2^-24 / p. normal_kl and the CDF: 1e-5 relative and 1e-6 absolute.
    Every log-likelihood's gradient is finite (the unselected branches give
    no NaN)."""
    from xdiffusion_tpu import utils as jutils

    from xdiffusion_tpu_torch import utils

    x, means, log_scales = _helpers_inputs()
    assert (x == -1.0).any() and (x == 1.0).any()
    want = np.asarray(jutils.discretized_gaussian_log_likelihood(
        jnp.asarray(x), means=jnp.asarray(means), log_scales=jnp.asarray(log_scales)))
    m = torch.from_numpy(means).requires_grad_()
    ls = torch.from_numpy(log_scales).requires_grad_()
    got = utils.discretized_gaussian_log_likelihood(torch.from_numpy(x), means=m, log_scales=ls)
    cancellation = 4 * 2.0 ** -24 / np.exp(want.astype(np.float64))
    err = np.abs(got.detach().numpy().astype(np.float64) - want)
    assert (err <= 1e-6 + 1e-5 * np.abs(want) + cancellation).all(), err.max()
    assert (err <= 1e-6 + 1e-5 * np.abs(want))[want > np.log(1e-3)].all()  # no cancellation
    assert (want <= np.log(1e-12) + 1e-3).any()  # some logs sit on the floor
    got.sum().backward()
    assert torch.isfinite(m.grad).all() and torch.isfinite(ls.grad).all()

    cdf_in = np.linspace(-8, 8, 101, dtype=np.float32)
    np.testing.assert_allclose(utils.approx_standard_normal_cdf(torch.from_numpy(cdf_in)).numpy(),
                               np.asarray(jutils.approx_standard_normal_cdf(jnp.asarray(cdf_in))),
                               rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(1)
    m1, m2 = rng.normal(size=(2, 512)).astype(np.float32)
    lv1, lv2 = rng.uniform(-20, 2, size=(2, 512)).astype(np.float32)
    want = np.asarray(jutils.normal_kl(*map(jnp.asarray, (m1, lv1, m2, lv2))))
    got = utils.normal_kl(*map(torch.from_numpy, (m1, lv1, m2, lv2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_config_builds_at_full_width_with_the_doubled_head():
    """As shipped: num_features 128, the final conv emits 2 channels, the
    forward returns the (prediction, log-variance) pair."""
    from test_torch_port_text import config_path

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    model = GaussianDiffusion_DDPM(load_yaml(config_path(NAME)), device="cpu")
    net = model.score_network()
    assert model.is_learned_sigma() and net.final_conv.weight.shape[0] == 2
    with torch.no_grad():
        out = net(torch.zeros(1, 32, 32, 1), {"timestep": torch.tensor([5])})
    assert isinstance(out, tuple) and [tuple(o.shape) for o in out] == [(1, 32, 32, 1)] * 2


def test_forward_pair_matches_jax():
    """Both halves of the doubled head, fp32: 2e-5 of the output's scale
    (summation orders), as `check_forward` holds the other UNets."""
    jmodel, params, pmodel = build(NAME)
    size, ch = spatial(pmodel)
    x = np.random.default_rng(0).standard_normal((2, size, size, ch)).astype(np.float32)
    t = np.int32([0, 731])
    want = jax.jit(jmodel.predict_score)(params, jnp.asarray(x), {"timestep": jnp.asarray(t)})
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), {"timestep": torch.from_numpy(t).long()})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (2, size, size, ch)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * max(1.0, np.abs(w).max()), rtol=0)


@pytest.mark.parametrize("t", [[0, 0, 3, 999], [1, 250, 500, 998]])
def test_hybrid_loss_matches_jax(t):
    """loss_on_batch with injected int steps (t == 0 takes the decoder NLL,
    the rest the KL; the port's int64 steps as JAX's int32) and noise,
    dropout off: the loss, vb_loss, mse_loss and the per-example losses
    (the vb term included) to 1e-5 relative."""
    jmodel, params, pmodel = build(NAME)
    size, ch = spatial(pmodel)
    rng = np.random.default_rng(3)
    images = (rng.integers(0, 256, (4, size, size, ch)) / 255.0).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    t = np.int32(t)
    want, want_m = jax.jit(jmodel.loss_on_batch, static_argnames=("deterministic",))(
        params, jax.random.PRNGKey(1), jnp.asarray(images), {}, timesteps=jnp.asarray(t),
        noise=jnp.asarray(noise), deterministic=True)
    got, got_m = pmodel.loss_on_batch(torch.from_numpy(images), {},
                                      timesteps=torch.from_numpy(t).long(),
                                      noise=torch.from_numpy(noise), deterministic=True)
    assert float(want_m["vb_loss"]) > 0
    for key in ("loss", "vb_loss", "mse_loss"):
        np.testing.assert_allclose(got_m[key].item(), float(want_m[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["loss_per_example"].numpy(),
                               np.asarray(want_m["loss_per_example"]), rtol=1e-5)


class _FixedOutput(torch.nn.Module):
    """A stand-in network that returns its two parameter tensors as the
    (prediction, log-variance) pair."""

    def __init__(self, shape):
        super().__init__()
        rng = np.random.default_rng(4)
        self.pred = torch.nn.Parameter(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
        self.logvar = torch.nn.Parameter(torch.from_numpy(
            rng.uniform(-8, -1, shape).astype(np.float32)))

    def forward(self, x, context):
        return self.pred * 1.0, self.logvar * 1.0


def test_vb_gradient_reaches_the_variance_half_only():
    """The vb term's gradient of the mean half is exactly 0 (it sees the
    prediction detached), of the variance half not; the mse term's the
    other way round."""
    _, _, pmodel = build(NAME)
    size, ch = spatial(pmodel)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.random((3, size, size, ch)).astype(np.float32))
    stub = _FixedOutput((3, size, size, ch))
    saved = pmodel._score_network
    pmodel._score_network = stub
    try:
        _, m = pmodel.loss_on_batch(images, {}, timesteps=torch.tensor([0, 17, 600]),
                                    noise=torch.randn(images.shape), deterministic=True)
    finally:
        pmodel._score_network = saved
    d_pred, d_logvar = torch.autograd.grad(m["vb_loss"], [stub.pred, stub.logvar],
                                           retain_graph=True, allow_unused=True)
    assert d_pred is None or not d_pred.any()
    assert d_logvar.abs().sum() > 0
    d_pred, d_logvar = torch.autograd.grad(m["mse_loss"], [stub.pred, stub.logvar],
                                           allow_unused=True)
    assert d_pred.abs().sum() > 0 and (d_logvar is None or not d_logvar.any())


def test_guided_variance_and_log_variance_are_mixed_separately():
    """predict_epsilon of a learned-sigma process whose conditional and
    unconditional outputs differ: the prediction, variance = exp(log-
    variance) of each half mixed with w, and the log-variance mixed with w,
    equal JAX's; the mixed variance is not exp of the mixed log-variance."""
    from xdiffusion_tpu.samplers.base import predict_epsilon as jax_predict_epsilon

    from xdiffusion_tpu_torch.samplers.base import predict_epsilon

    class Process:
        def __init__(self, lib):
            self.lib = lib

        def is_learned_sigma(self):
            return True

        def process_input(self, x, ctx):
            return x

        def predict_score(self, *args):
            x, ctx = args[-2:]
            s = ctx["s"].reshape(-1, 1, 1, 1)
            return x * s, 0.5 * x - 2.0 * s

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
    s_c, s_u = np.float32([1.0, -0.5]), np.float32([0.25, 2.0])
    want = jax_predict_epsilon(Process(jnp), None, jnp.asarray(x), {"s": jnp.asarray(s_c)},
                               {"s": jnp.asarray(s_u)}, 3.0)
    got = predict_epsilon(Process(torch), torch.from_numpy(x), {"s": torch.from_numpy(s_c)},
                          {"s": torch.from_numpy(s_u)}, 3.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got[1], torch.exp(got[2]), rtol=1e-3)


@pytest.mark.parametrize("guidance", [None, 3.0])
def test_learned_range_trajectory_matches_jax(guidance):
    """10 ancestral steps with the learned variance, injected initial and
    per-step noise: the config's guidance (0.0 with the identity
    unconditional context: one forward on the doubled batch) or w = 3.0,
    within 1e-3 on samples in [0, 1]."""
    jmodel, params, pmodel = build(NAME)
    size, ch = spatial(pmodel)
    steps, n = 10, 2
    rng = np.random.default_rng(1)
    init = rng.standard_normal((n, size, size, ch)).astype(np.float32)
    noise = rng.standard_normal((steps, n, size, size, ch)).astype(np.float32)
    w = pmodel.classifier_free_guidance() if guidance is None else guidance
    assert w == jmodel.classifier_free_guidance() or guidance is not None
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        initial_noise=jnp.asarray(init), classifier_free_guidance=w,
        context={"sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps,
                        initial_noise=torch.from_numpy(init), classifier_free_guidance=w,
                        context={"sampling_noise": torch.from_numpy(noise)})
    assert tuple(got.shape) == (n, size, size, ch)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
