"""DiffuSSM in the port against the JAX package on the CPU: the S4D kernel
(the complex64 Vandermonde product), the causal FFT convolution at length
2L, the S4D layer and the bidirectional residual block, one DiffuSSM block,
and `diffussm.yaml` at 16x16 pixels (256 tokens), d_model 32, 2 layers:
forward (class labels ignored, as in JAX), loss, every parameter's
gradient against `jax.value_and_grad`, a 10-step guided ancestral
trajectory; the config built at full width with JAX's parameter count.

Complex exponentials and FFTs from two libraries round differently, and the
kernel sums terms that cancel, so the S4D bounds are relative to each
output's scale. The helpers are tests/test_torch_port_mmdit.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_mmdit import (
    build,
    check_forward,
    check_full_width,
    check_loss_and_gradients,
    check_trajectory,
    shared_weights,
)

# The S4D kernel and convolution: complex64 exps and FFTs in other orders.
SSM_TOL = 1e-5


def _s4d_params(rng, h: int, n: int):
    from xdiffusion_tpu_torch.weights import draw

    return {name: draw(name, shape, 1, rng) for name, shape in
            (("C", (h, n, 2)), ("log_dt", (h,)), ("log_A_real", (h, n)), ("A_imag", (h, n)))}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("h,n,length", [(8, 32, 1024), (3, 4, 7)])
def test_s4d_kernel_matches_jax(h, n, length):
    """The (H, L) kernel at DiffuSSM's length (1024 pixels, 64 states as 32
    conjugate pairs) and a ragged one, from S4D-Lin-like parameters: within
    SSM_TOL of its scale."""
    from xdiffusion_tpu.layers.s4d import S4D as JaxS4D

    from xdiffusion_tpu_torch.layers.s4d import s4d_kernel

    p = _s4d_params(np.random.default_rng(h), h, n)
    args = (p["C"], p["log_dt"], p["log_A_real"], p["A_imag"])
    want = np.asarray(JaxS4D(d_model=h)._kernel(*(jnp.asarray(a) for a in args), length))
    got = s4d_kernel(*(torch.from_numpy(a) for a in args), length)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h, length)
    assert _rel(got.numpy(), want) <= SSM_TOL


@pytest.mark.parametrize("length", [1024, 5])
def test_causal_convolution_matches_direct_sum(length):
    """The FFT at 2L against the direct causal sum y_l = sum_{j<=l} K_j
    x_{l-j} in float64: within SSM_TOL of its scale; an output moves by no
    more than that when later inputs change (the FFT spreads its rounding
    over every position, so not bit for bit)."""
    from xdiffusion_tpu_torch.layers.s4d import causal_convolution

    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, 3, length)).astype(np.float32)
    k = (rng.standard_normal((3, length)) * np.exp(-np.arange(length) / 50)).astype(np.float32)
    want = np.stack([np.stack([np.convolve(x[b, c].astype(np.float64), k[c])[:length]
                               for c in range(3)]) for b in range(2)])
    got = causal_convolution(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert _rel(got, want) <= SSM_TOL
    x2 = x.copy()
    x2[..., length // 2:] += 1.0
    moved = causal_convolution(torch.from_numpy(x2), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(moved[..., :length // 2], got[..., :length // 2],
                               atol=SSM_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("block", ["s4d", "bidirectional", "forward_postnorm"])
def test_s4d_layer_and_residual_block_match_jax(block):
    """S4D on (2, 64, 16) and the residual block as DiffuSSM configures it
    (prenorm, bidirectional: a second S4D on the SAME input) and with
    prenorm off and one direction: within SSM_TOL of the output's scale;
    the block returns (y, None)."""
    from xdiffusion_tpu.layers import s4d as jax_s4d

    from xdiffusion_tpu_torch.layers import s4d

    x = np.random.default_rng(31).standard_normal((2, 64, 16)).astype(np.float32)
    if block == "s4d":
        jmod, port = jax_s4d.S4D(d_model=16), s4d.S4D(16)
    else:
        kw = dict(bidirectional=block == "bidirectional", prenorm=block == "bidirectional")
        jmod, port = jax_s4d.SequenceResidualBlock(d_input=16, **kw), \
            s4d.SequenceResidualBlock(16, **kw)
    params = shared_weights(jmod, port, jnp.asarray(x))
    want = jax.jit(jmod.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if block != "s4d":
        assert got[1] is None and want[1] is None
        got, want = got[0], want[0]
    assert _rel(got.numpy(), np.asarray(want)) <= SSM_TOL


def test_diffussm_block_matches_jax():
    """One block on 256 tokens of 32 channels under a 256-wide condition:
    the hourglass over the sequence axis, the bidirectional S4D, the gated
    fusion added to the MODULATED input: within 2e-5 of the output's
    scale."""
    from xdiffusion_tpu.score_networks.diffussm import DiffusionSSMBlock as JaxBlock

    from xdiffusion_tpu_torch.score_networks.diffussm import DiffusionSSMBlock

    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 256, 32)).astype(np.float32)
    cond = rng.standard_normal((2, 256)).astype(np.float32)
    jmod, port = JaxBlock(d_model=32, seq_len=256), DiffusionSSMBlock(32, 256)
    params = shared_weights(jmod, port, jnp.asarray(x), jnp.asarray(cond))
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x), jnp.asarray(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


def test_forward_matches_jax():
    check_forward("diffussm")


def test_forward_ignores_class_labels():
    """The config is class-conditional, but neither package's network reads
    the labels: the same output for classes (3, 7) and the null class."""
    _, _, pmodel, _ = build("diffussm")
    x = torch.from_numpy(np.random.default_rng(33).standard_normal((2, 16, 16, 1))
                         .astype(np.float32))
    t = torch.tensor([10, 900])
    with torch.inference_mode():
        a = pmodel.predict_score(x, {"timestep": t, "classes": torch.tensor([3, 7])})
        b = pmodel.predict_score(x, {"timestep": t, "classes": torch.tensor([10, 10])})
    assert torch.equal(a, b)


def test_loss_and_every_gradient_match_jax():
    check_loss_and_gradients("diffussm")


def test_guided_trajectory_matches_jax():
    check_trajectory("diffussm")


def test_config_builds_at_full_width_with_jax_parameter_count():
    check_full_width("diffussm")
