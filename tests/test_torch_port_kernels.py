"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of `xdiffusion_tpu_torch.ops` runs its plain
PyTorch version; the JAX kernels run in Pallas interpret mode, as
tests/test_ops.py runs them. Inputs come from numpy with a seed; fp32.
The CUDA kernels themselves are checked against these plain versions on
the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from xdiffusion_tpu_torch.ops import flash_attention, fused_resblock, group_norm

# fp32 on both sides; only summation order differs.
ATOL = 2e-5


def _normal(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("b,sq,sk,c,heads", [(4, 64, 64, 128, 2), (2, 64, 96, 128, 2),
                                             (2, 16, 16, 256, 4)])
def test_bsc_attention_plain_matches_pallas(b, sq, sk, c, heads):
    from xdiffusion_tpu.ops.flash_attention import _bsc_forward

    rng = np.random.default_rng(0)
    q, k, v = _normal(rng, b, sq, c), _normal(rng, b, sk, c), _normal(rng, b, sk, c)
    scale = (c // heads) ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_bsc_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads, scale))
    got = flash_attention.short_attention_bsc(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_bsc_attention_takes_qkv_column_slices():
    """q, k, v as the column slices of one qkv projection (the layer's call)."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(_normal(rng, 2, 32, 3 * 64))
    q, k, v = qkv.chunk(3, dim=-1)
    got = flash_attention.short_attention_bsc(q, k, v, 2, 32 ** -0.5)
    want = flash_attention.short_attention_bsc(
        q.contiguous(), k.contiguous(), v.contiguous(), 2, 32 ** -0.5)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_plain_matches_pallas(apply_silu):
    from xdiffusion_tpu.ops.group_norm import _pallas_group_norm_silu

    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 8, 8, 128, scale=2.0, shift=0.5)
    scale = _normal(rng, 128, scale=0.1, shift=1.0)
    bias = _normal(rng, 128, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_group_norm_silu(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, apply_silu))
    got = group_norm.group_norm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                                     torch.from_numpy(bias), 32, 1e-5, apply_silu)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("c,co", [(128, 128), (256, 128)])
def test_affine_silu_conv3x3_plain_matches_pallas(apply_silu, residual, c, co):
    from xdiffusion_tpu.ops.fused_resblock import _pallas_call

    rng = np.random.default_rng(3)
    b, h, w = 2, 8, 8
    x = _normal(rng, b, h, w, c)
    a = _normal(rng, b, c, scale=0.2, shift=1.0)
    off = _normal(rng, b, c, scale=0.1)
    kw = _normal(rng, 3, 3, c, co, scale=0.05)
    bias = _normal(rng, co, scale=0.1)
    res = _normal(rng, b, h, w, co) if residual else None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_call(
            jnp.asarray(x), jnp.asarray(a), jnp.asarray(off), jnp.asarray(kw),
            jnp.asarray(bias), None if res is None else jnp.asarray(res), apply_silu))
    got = fused_resblock.affine_silu_conv3x3(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(off),
        torch.from_numpy(kw), torch.from_numpy(bias),
        None if res is None else torch.from_numpy(res), apply_silu)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


def test_affine_silu_conv3x3_pads_after_the_activation():
    """A tap off the image adds 0, not silu(off): with x = 0 inside, the
    activation is silu(off) everywhere, so border pixels see fewer taps."""
    b, h, w, c = 1, 4, 4, 8
    x = torch.zeros(b, h, w, c)
    a = torch.ones(b, c)
    off = torch.full((b, c), 2.0)
    kw = torch.ones(3, 3, c, 1)
    out = fused_resblock.affine_silu_conv3x3(x, a, off, kw, torch.zeros(1))[0, ..., 0]
    s = c * torch.nn.functional.silu(torch.tensor(2.0))
    assert torch.allclose(out[1, 1], 9 * s) and torch.allclose(out[0, 0], 4 * s)
    assert torch.allclose(out[0, 1], 6 * s)


@pytest.mark.parametrize("op", ["attention", "group_norm", "conv"])
def test_wrappers_raise_off_cpu_and_cuda(op):
    """A wrapper takes its plain version only for CPU tensors; for any other
    device it launches its kernel (CUDA) or raises."""
    t = torch.empty(2, 16, 64, device="meta")
    with pytest.raises(ValueError):
        if op == "attention":
            flash_attention.short_attention_bsc(t, t, t, 1, 0.125)
        elif op == "group_norm":
            group_norm.group_norm_silu(t.reshape(2, 4, 4, 64), torch.empty(64, device="meta"),
                                       torch.empty(64, device="meta"), 32)
        else:
            x = t.reshape(2, 4, 4, 64)
            fused_resblock.affine_silu_conv3x3(
                x, torch.empty(2, 64, device="meta"), torch.empty(2, 64, device="meta"),
                torch.empty(3, 3, 64, 64, device="meta"), torch.empty(64, device="meta"))


def test_kernel_library_names_follow_their_sources(tmp_path, monkeypatch):
    """The build names each library by a hash of its source and the headers
    of csrc/, so an edited source or header builds anew."""
    import os

    from xdiffusion_tpu_torch.ops import _build

    first = _build._library_path("group_norm_silu")
    assert first.startswith(_build.BUILD_DIR)
    for name in os.listdir(_build.CSRC):
        if name.endswith((".cu", ".cuh")):
            (tmp_path / name).write_bytes(open(f"{_build.CSRC}/{name}", "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert _build._library_path("group_norm_silu") == first
    (tmp_path / "group_norm_silu.cu").write_text("// edited\n")
    edited = _build._library_path("group_norm_silu")
    assert edited != first
    (tmp_path / "flash_common.cuh").write_text("// edited\n")
    assert _build._library_path("group_norm_silu") != edited
    assert set(_build.kernels()) == {"bsc_attention", "bsc_attention_bwd",
                                     "group_norm_silu", "affine_silu_conv3x3",
                                     "flash_attention", "flash_attention_bwd"}
