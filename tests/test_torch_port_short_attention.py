"""K7, attention on head-major (B, H, S, D) tensors: the port's
`short_attention` against the JAX package's on the CPU.

The JAX function runs its Pallas kernel (`_short_seq_kernel`) in interpret
mode, as tests/test_ops.py runs the package's kernels; the port's wrapper
runs its plain version on CPU tensors. Its gradient, the vjp of the plain
version, is held against `jax.grad` of the JAX function (which runs
`_short_bwd`) and against finite differences. Inputs come from numpy with a
seed. The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from jax.experimental.pallas import tpu as pltpu

from xdiffusion_tpu_torch.ops import flash_attention

# (B, H, Sq, Sk, D): the DiT site's sequence length, self-attention; and an
# odd query count against fewer keys.
SHAPES = [(2, 3, 16, 16, 64), (2, 3, 77, 40, 32)]
IDS = ["self-16x64", "77x40x32"]


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _jax_short_attention(q, k, v, scale):
    from xdiffusion_tpu.ops.flash_attention import short_attention

    with pltpu.force_tpu_interpret_mode():
        return short_attention(q, k, v, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,sq,sk,d", SHAPES, ids=IDS)
def test_short_attention_plain_matches_pallas(b, h, sq, sk, d, dtype):
    """fp32: summation order only, 1e-6. bf16: both sides round the weights
    to bf16 before PV and the output once; the products sum in other orders:
    1 bf16 ulp at the binade of the reference's largest magnitude."""
    q, k, v = _inputs(0, b, h, sq, sk, d)
    scale = d ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _jax_short_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), scale)
    got = flash_attention.short_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                          scale)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, sq, d)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        tol = 1e-6
    else:
        tol = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("b,h,sq,sk,d", SHAPES, ids=IDS)
def test_short_attention_gradient_matches_jax(b, h, sq, sk, d):
    """dq, dk and dv for a cotangent g against jax.grad of the JAX function
    (its forward in interpret mode, its backward `_short_bwd`), fp32: 1e-5."""
    q, k, v = _inputs(1, b, h, sq, sk, d)
    g = np.random.default_rng(2).standard_normal((b, h, sq, d)).astype(np.float32)
    scale = d ** -0.5

    def jax_loss(q, k, v):
        return jnp.sum(_jax_short_attention(q, k, v, scale) * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention.short_attention(*leaves, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_short_attention_gradcheck_float64():
    """The backward (the plain version's vjp) against finite differences."""
    rng = np.random.default_rng(3)
    leaves = [torch.from_numpy(rng.standard_normal((1, 1, 8, 16))).requires_grad_()
              for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention.short_attention(q, k, v, 0.25), leaves)


def test_short_attention_refuses_other_devices_and_shapes():
    """The plain version runs for CPU tensors only: on any other device the
    wrapper launches K7 (CUDA) or raises. Shapes that do not pair raise."""
    t = torch.empty(2, 3, 16, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention.short_attention(t, t, t, 0.125)
    q = torch.zeros(2, 3, 16, 64)
    with pytest.raises(ValueError):
        flash_attention.short_attention(q, torch.zeros(2, 3, 16, 32), torch.zeros(2, 3, 16, 32),
                                        0.125)
