"""Gradients of the port's kernel wrappers and layers against the JAX package.

On the CPU each `torch.autograd.Function` of `xdiffusion_tpu_torch.ops`
runs its plain forward and backward, so these tests exercise the Functions'
wiring; the TPU backward kernel runs in Pallas interpret mode, as
tests/test_torch_port_kernels.py runs the forward kernels. Inputs come from
numpy with a seed; fp32. The CUDA kernels (K2 among them) are held against
these plain versions on the card by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from jax.experimental.pallas import tpu as pltpu

from xdiffusion_tpu_torch.ops import flash_attention, fused_resblock, group_norm

# fp32 on both sides; only summation orders differ.
ATOL = 2e-5


def _normal(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(*arrays, grad=False):
    out = tuple(torch.from_numpy(a).requires_grad_(grad) for a in arrays)
    return out if len(out) > 1 else out[0]


@pytest.mark.parametrize("b,sq,sk,c,heads", [(2, 64, 64, 128, 2), (2, 64, 96, 128, 2),
                                             (2, 16, 16, 256, 4)])
def test_bsc_backward_plain_matches_pallas(b, sq, sk, c, heads):
    """K2's plain version against the TPU backward kernel `_bsc_backward`.
    Tolerance 2e-5 (abs and rel): fp32 summation orders."""
    from xdiffusion_tpu.ops.flash_attention import _bsc_backward

    rng = np.random.default_rng(0)
    q, k, v = _normal(rng, b, sq, c), _normal(rng, b, sk, c), _normal(rng, b, sk, c)
    g = _normal(rng, b, sq, c)
    scale = (c // heads) ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = _bsc_backward(*(jnp.asarray(a) for a in (q, k, v, g)), heads, scale)
    got = flash_attention.short_attention_bsc_bwd(*_t(q, k, v, g), heads, scale)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=ATOL, rtol=ATOL,
                                   err_msg=f"d{name}")


def test_bsc_backward_plain_rounds_as_the_tpu_kernel_in_bf16():
    """In bf16 the plain backward rounds p and ds as `_bsc_bwd_kernel` does
    (p to v's dtype, ds * scale to q's dtype): the results agree to 2 bf16
    ulps at each reference's largest value."""
    from xdiffusion_tpu.ops.flash_attention import _bsc_backward

    rng = np.random.default_rng(1)
    b, s, c, heads = 2, 32, 64, 2
    arrays = [_normal(rng, b, s, c) for _ in range(4)]
    with pltpu.force_tpu_interpret_mode():
        want = _bsc_backward(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), heads, 0.125)
    got = flash_attention.short_attention_bsc_bwd(
        *(torch.from_numpy(a).bfloat16() for a in arrays), heads, 0.125)
    for x, y in zip(got, want):
        y = np.asarray(y.astype(jnp.float32))
        assert x.dtype == torch.bfloat16
        np.testing.assert_allclose(x.float().numpy(), y, rtol=0,
                                   atol=2 * 2.0 ** -7 * max(1.0, np.abs(y).max()))


@pytest.mark.parametrize("sliced", [False, True])
def test_attention_function_gradients_match_jax_grad(sliced):
    """Gradients through `short_attention_bsc` (forward K1's plain version,
    backward K2's) against jax.grad of the einsum `attention_bshd`, as
    tests/test_ops.py checks the JAX custom vjp. With `sliced`, q, k and v are
    column slices of one qkv tensor and the gradient lands in it. Tolerance
    1e-4: fp32, and the backward's order of sums differs from XLA's."""
    from xdiffusion_tpu.ops.attention import attention_bshd

    rng = np.random.default_rng(2)
    b, s, c, heads = 2, 32, 64, 2
    d = c // heads
    qkv = _normal(rng, b, s, 3 * c)
    w = _normal(rng, b, s, c)  # a fixed cotangent, via loss = sum(out * w)

    def ref_loss(qkv):
        q, k, v = (t.reshape(b, s, heads, d) for t in jnp.split(qkv, 3, axis=-1))
        return jnp.sum(attention_bshd(q, k, v, scale=d ** -0.5).reshape(b, s, c) * w)

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(qkv)))
    if sliced:
        t = _t(qkv, grad=True)
        q, k, v = t.chunk(3, dim=-1)
        leaves = (t,)
    else:
        leaves = tuple(_t(a.copy(), grad=True) for a in np.split(qkv, 3, axis=-1))
        q, k, v = leaves
    out = flash_attention.short_attention_bsc(q, k, v, heads, d ** -0.5)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    got = torch.cat([leaf.grad for leaf in leaves], dim=-1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_function_gradients_match_jax_vjp(apply_silu):
    """K3's Function: gradients to x, scale and bias against jax.vjp of the
    JAX package's `_xla_group_norm_silu`. Tolerance 2e-5 (fp32)."""
    from xdiffusion_tpu.ops.group_norm import _xla_group_norm_silu

    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 8, 8, 64, scale=2.0, shift=0.5)
    scale = _normal(rng, 64, scale=0.1, shift=1.0)
    bias = _normal(rng, 64, scale=0.1)
    g = _normal(rng, 2, 8, 8, 64)
    _, vjp = jax.vjp(lambda *ops: _xla_group_norm_silu(*ops, 32, 1e-5, apply_silu),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    xt, st, bt = _t(x, scale, bias, grad=True)
    out = group_norm.group_norm_silu(xt, st, bt, 32, 1e-5, apply_silu)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for name, got, w in zip(("x", "scale", "bias"), (xt.grad, st.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("residual", [True, False])
def test_affine_silu_conv3x3_function_gradients_match_jax_vjp(apply_silu, residual):
    """K4's Function: gradients to x, a, off, kernel_w, bias (and the
    residual, which receives the cotangent itself) against jax.vjp of the JAX
    package's `_xla_impl`. Tolerance 1e-4 (fp32 convolution sums)."""
    from xdiffusion_tpu.ops.fused_resblock import _xla_impl

    rng = np.random.default_rng(4)
    b, h, w, c, co = 2, 8, 8, 32, 16
    x = _normal(rng, b, h, w, c)
    a = _normal(rng, b, c, scale=0.2, shift=1.0)
    off = _normal(rng, b, c, scale=0.1)
    kw = _normal(rng, 3, 3, c, co, scale=0.1)
    bias = _normal(rng, co, scale=0.1)
    res = _normal(rng, b, h, w, co)
    g = _normal(rng, b, h, w, co)
    ops = [x, a, off, kw, bias] + ([res] if residual else [])

    def ref(*args):
        return _xla_impl(*args[:5], args[5] if residual else None, apply_silu)

    _, vjp = jax.vjp(ref, *(jnp.asarray(o) for o in ops))
    want = vjp(jnp.asarray(g))
    leaves = _t(*ops, grad=True)
    out = fused_resblock.affine_silu_conv3x3(*leaves[:5],
                                             residual=leaves[5] if residual else None,
                                             apply_silu=apply_silu)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for i, (leaf, w_) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w_), atol=1e-4, rtol=1e-4,
                                   err_msg=f"operand {i}")
    if residual:
        assert torch.equal(leaves[5].grad, torch.from_numpy(g))


def test_dropout_rate_scale_and_determinism():
    """flax's dropout: zeros at the rate, kept values scaled by 1 / keep, the
    same mask for the same generator seed."""
    from xdiffusion_tpu_torch.utils import dropout

    x = torch.ones(200, 500)
    out = dropout(x, 0.1, torch.Generator().manual_seed(3))
    zeros = (out == 0).float().mean().item()
    assert abs(zeros - 0.1) < 0.005  # 100k draws: 6 sigma is 0.0057
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1.0 / 0.9), atol=0, rtol=0)
    again = dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert not torch.equal(out, dropout(x, 0.1, torch.Generator().manual_seed(4)))
    assert dropout(x, 0.0, None) is x


def _shared_params(jax_module, port_module, *init_args, seed=0, **init_kwargs):
    from flax import traverse_util

    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    variables = jax_module.init(jax.random.PRNGKey(0), *init_args, **init_kwargs)
    flat = {"/".join(k): v for k, v in
            traverse_util.flatten_dict(variables["params"]).items()}
    drawn = random_flax_params(flat, seed)
    load_flax_params(port_module, drawn)
    return drawn


@pytest.mark.parametrize("use_ss", [True, False])
def test_resnet_block_dropout_branch_matches_jax(monkeypatch, use_ss):
    """The training branch of the residual block (norm2 -> dropout -> conv2
    as a plain convolution -> skip add) with an all-ones mask equals the JAX
    block at deterministic=True whose conv2 kernel is scaled by 1 / keep: an
    all-kept mask only scales h by 1 / keep. Tolerance 1e-4 (fp32)."""
    from flax import traverse_util
    from xdiffusion_tpu.layers import resnet as jax_resnet

    from xdiffusion_tpu_torch import utils
    from xdiffusion_tpu_torch.layers.resnet import ResnetBlockBigGAN

    assert not jax_resnet._FUSED_RESBLOCK
    monkeypatch.setattr(utils, "dropout_mask",
                        lambda shape, keep, generator, device: torch.ones(shape, dtype=torch.bool))
    rng = np.random.default_rng(5)
    x = _normal(rng, 2, 8, 8, 32)
    emb = _normal(rng, 2, 64)
    jmod = jax_resnet.ResnetBlockBigGAN(dim_out=64, use_scale_shift_norm=use_ss, dropout=0.1)
    port = ResnetBlockBigGAN(32, 64, 64, use_scale_shift_norm=use_ss, dropout=0.1)
    ctx = {"timestep_embedding": jnp.asarray(emb)}
    drawn = _shared_params(jmod, port, jnp.asarray(x), ctx)
    drawn["conv2/kernel"] = drawn["conv2/kernel"] / np.float32(0.9)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    want = np.asarray(jax.jit(functools.partial(jmod.apply, deterministic=True))(
        params, jnp.asarray(x), ctx))
    port.train()
    got = port(torch.from_numpy(x), {"timestep_embedding": torch.from_numpy(emb),
                                     "dropout_generator": torch.Generator()})
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    # Without a generator, or in eval mode, the block does not drop.
    port.eval()
    with torch.no_grad():
        fused = port(torch.from_numpy(x), {"timestep_embedding": torch.from_numpy(emb),
                                           "dropout_generator": torch.Generator()})
    assert not np.allclose(fused.numpy(), want, atol=1e-3)


def test_attention_layer_drops_after_proj_out(monkeypatch):
    """SpatialCrossAttention applies dropout to proj_out's output, before the
    residual add: with an all-ones mask the branch is scaled by 1 / keep."""
    from xdiffusion_tpu_torch import utils
    from xdiffusion_tpu_torch.layers.attention import SpatialCrossAttention
    from xdiffusion_tpu_torch.weights import randomize_

    monkeypatch.setattr(utils, "dropout_mask",
                        lambda shape, keep, generator, device: torch.ones(shape, dtype=torch.bool))
    layer = SpatialCrossAttention(64, context_dim=-1, dim_head=32, dropout=0.25)
    randomize_(layer, 0)
    x = torch.from_numpy(_normal(np.random.default_rng(6), 2, 4, 4, 64))
    with torch.no_grad():
        layer.eval()
        plain = layer(x, {"dropout_generator": torch.Generator()}) - x
        layer.train()
        dropped = layer(x, {"dropout_generator": torch.Generator()}) - x
        undropped = layer(x, {}) - x
    torch.testing.assert_close(dropped, plain / 0.75, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(undropped, plain, atol=0, rtol=0)
