"""`bsc_plan`, the launch plan of K1 and K2 (and K7, which runs K1's device
code): at the main paths' sites, ragged and long shapes, forward and
backward, each launch covers every (batch, head, query row) exactly once
(the dk/dv launch every key row), fits the H100's shared memory, and the
streaming variant is picked only above the threshold. The CUDA entry points
launch exactly this geometry (`csrc/bsc_attention.cuh`)."""

import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from xdiffusion_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, heads, head dim)
SITES = {
    "flagship 16x16": (64, 256, 256, 4, 64),
    "flagship 16x16 train": (128, 256, 256, 4, 64),
    "flagship middle": (64, 16, 16, 4, 64),
    "DiT b64": (64, 16, 16, 6, 64),
    "DiT b128": (128, 16, 16, 6, 64),
    "long": (4, 1024, 1024, 8, 64),
    "K7 DiT merged": (768, 16, 16, 1, 64),
    "K7 UNet merged": (256, 256, 256, 1, 64),
}
RAGGED = [(3, sq, sk, 2, d) for sq, sk in [(1, 1), (15, 15), (17, 17), (100, 100), (255, 255),
                                            (256, 256), (257, 257), (16, 100), (100, 17),
                                            (1, 257), (257, 15), (33, 500)]
          for d in (16, 64, 128)]
CASES = [pytest.param(*s, id=name) for name, s in SITES.items()] + [
    pytest.param(*s, id=f"ragged-{s[1]}x{s[2]}-d{s[4]}") for s in RAGGED]


def _covered(launch, b, heads, sq, sk):
    """How often launch's blocks reach each (batch, head, row) of the axis
    it walks, as the kernels map blocks (slices: every row of the slice)."""
    n = sk if launch.axis == "keys" else sq
    hits = np.zeros((b, heads, n), dtype=np.int64)
    gx, gy, gz = launch.grid
    if launch.axis == "slices":
        assert (gy, gz) == (1, 1)
        for x in range(gx):
            for s in range(x * launch.per_block, min((x + 1) * launch.per_block, b * heads)):
                hits[s // heads, s % heads, :] += 1
    else:
        assert (gy, gz) == (heads, b)
        for x in range(gx):
            hits[:, :, x * launch.per_block:(x + 1) * launch.per_block] += 1
    return hits


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,heads,d", CASES)
def test_plan_covers_each_row_once_and_fits(b, sq, sk, heads, d, dtype, backward):
    plan = fa.bsc_plan(b, sq, sk, heads, d, dtype, backward=backward)
    assert plan.variant in fa.VARIANTS
    # The streaming variant only above the threshold, and always there.
    assert (plan.variant == "stream") == (sk > fa.ROW_MAX_KEYS)
    if plan.variant == "packed":
        assert max(sq, sk) <= plan.tile and plan.tile in (16, 32)
        assert len(plan.launches) == 1  # K2 too: one launch, no statistics
        assert plan.launches[0].axis == "slices"
    else:
        assert plan.launches[0].axis == "queries"
        assert [ln.axis for ln in plan.launches[1:]] == (["keys"] if backward else [])
    if plan.variant == "row":
        assert plan.tile % fa.KEY_TILE == 0 and sk <= plan.tile < sk + fa.KEY_TILE
        assert plan.launches[0].per_block == 16 * plan.slices_per_block
    for launch in plan.launches:
        assert 0 < launch.smem <= fa.SMEM_LIMIT == 232_448
        assert launch.threads in (32, 64, 128) and max(launch.grid[1:]) <= 65535
        np.testing.assert_array_equal(_covered(launch, b, heads, sq, sk), 1)
    ints = list(plan.as_ints())
    assert len(ints) == 13 and ints[0] == fa.VARIANTS.index(plan.variant)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plan_variants_by_key_count(dtype):
    """Packed at 16 (32 for head dims up to 64) rows and keys, row up to the
    threshold, stream beyond; the main paths' sites take the first two."""
    plan = lambda sq, sk, d=64: fa.bsc_plan(8, sq, sk, 2, d, dtype).variant
    assert [plan(s, s) for s in (1, 16, 17, 32, 33)] == ["packed"] * 4 + ["row"]
    assert [plan(17, 17, 128), plan(16, 16, 128)] == ["row", "packed"]
    assert plan(16, fa.ROW_MAX_KEYS) == "row" and plan(16, fa.ROW_MAX_KEYS + 1) == "stream"
    assert fa.ROW_MAX_KEYS >= 256
    for name in ("flagship 16x16", "flagship middle", "DiT b128"):
        b, sq, sk, heads, d = SITES[name]
        assert fa.bsc_plan(b, sq, sk, heads, d, dtype).variant != "stream"


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="head dim"):
        fa.bsc_plan(2, 16, 16, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fa.bsc_plan(2, 16, 16, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        fa.bsc_plan(2, 0, 16, 2, 64, torch.float32)


# Head dim 256 (the wide variant): the SongUNet's one-head attention sites,
# 256 tokens (16x16 maps) and 64 (the 8x8 decoder entry), at every batch the
# sampling (64) and training (128) paths and the tests take, and ragged shapes.
WIDE_SITES = [(b, s, s, 1, 256) for b in (1, 2, 4, 8, 32, 64, 128) for s in (256, 64)]
WIDE_RAGGED = [(3, 17, 17, 1, 256), (2, 100, 37, 1, 256), (1, 5, 300, 1, 256),
               (3, 513, 129, 1, 256), (2, 1024, 1024, 1, 256), (128, 16, 16, 8, 256),
               (2, 16, 77, 8, 256)]
WIDE_CASES = [pytest.param(*s, id=f"edm-b{s[0]}-s{s[1]}") for s in WIDE_SITES] + [
    pytest.param(*s, id=f"ragged-{s[0]}x{s[1]}x{s[2]}x{s[3]}") for s in WIDE_RAGGED]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,heads,d", WIDE_CASES)
def test_wide_plan_covers_each_row_once_and_fits(b, sq, sk, heads, d, dtype, backward):
    """Every head-dim-256 shape takes the wide variant: 16 query rows a warp,
    32-key tiles; each launch covers every (batch, head, row) once and fits
    shared memory; its shared memory is the CUDA side's layout."""
    plan = fa.bsc_plan(b, sq, sk, heads, d, dtype, backward=backward)
    item = 4 if dtype == torch.float32 else 2
    assert plan.variant == "wide" and plan.tile == fa.WIDE_KEYS == 32
    assert plan.slices_per_block in (1, 2, 4)
    assert [ln.axis for ln in plan.launches] == (["queries", "keys"] if backward
                                                 else ["queries"])
    assert plan.launches[0].per_block == 16 * plan.slices_per_block
    smem = ([fa._wide_dq_bytes, fa._wide_dkv_bytes] if backward else [fa._wide_fwd_bytes])
    for launch, nbytes in zip(plan.launches, smem):
        warps = launch.threads // 32
        assert launch.per_block == 16 * warps and warps in (1, 2, 4)
        assert launch.smem == nbytes(item, warps)
        assert 0 < launch.smem <= fa.SMEM_LIMIT == 232_448
        assert max(launch.grid[1:]) <= 65535
        np.testing.assert_array_equal(_covered(launch, b, heads, sq, sk), 1)
    ints = list(plan.as_ints())
    assert len(ints) == 13 and ints[0] == fa.VARIANTS.index("wide") == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wide_plan_fills_the_card_at_the_songunet_sites(dtype):
    """At the 64-token site the plan takes fewer warps a block so that its
    grid has a block for every SM (64 slices of 64 rows would fill 64 of
    132); at 256 tokens four warps already do. Blocks with mostly padded rows
    are avoided (16 tokens: one warp)."""
    for b, s in ((64, 64), (128, 64), (64, 256), (128, 256)):
        for backward in (False, True):
            plan = fa.bsc_plan(b, s, s, 1, 256, dtype, backward=backward)
            for launch in plan.launches:
                assert np.prod(launch.grid) >= fa.SMS, (b, s, backward, launch)
    assert fa.bsc_plan(64, 64, 64, 1, 256, dtype).slices_per_block == 1
    assert fa.bsc_plan(64, 256, 256, 1, 256, dtype).slices_per_block == 4
    assert fa.bsc_plan(128, 16, 16, 8, 256, dtype).slices_per_block == 1


def test_head_dim_256_is_k1_and_k2s_only():
    """K1 and K2 admit 256 on the wide variant; K7 keeps its head dims."""
    assert 256 in fa.BSC_HEAD_DIMS and 256 not in fa.HEAD_DIMS
    with pytest.raises(ValueError, match="head dim"):
        fa.bsc_plan(2, 16, 16, 1, 192, torch.float32)


@pytest.mark.parametrize("b,sq,sk", [(2, 256, 256), (2, 64, 64), (1, 40, 72)],
                         ids=["edm-16x16", "edm-8x8", "ragged"])
def test_wide_plain_matches_pallas_at_head_dim_256(b, sq, sk):
    """K1's and K2's plain versions at head dim 256 (one head of C = 256, the
    SongUNet's) against the TPU kernels `_bsc_forward` / `_bsc_backward` in
    Pallas interpret mode, fp32: summation orders only, 2e-5 (abs and rel)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xdiffusion_tpu.ops.flash_attention import _bsc_backward, _bsc_forward

    rng = np.random.default_rng(11)
    c = 256  # one head
    q, k, v = (rng.standard_normal((b, n, c)).astype(np.float32) for n in (sq, sk, sk))
    g = rng.standard_normal((b, sq, c)).astype(np.float32)
    scale = c ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_bsc_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1,
                                       scale))
        want_grads = _bsc_backward(*(jnp.asarray(a) for a in (q, k, v, g)), 1, scale)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    got = fa.short_attention_bsc(*t[:3], 1, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    for name, x, y in zip("qkv", fa.short_attention_bsc_bwd(*t, 1, scale), want_grads):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=2e-5, rtol=2e-5,
                                   err_msg=f"d{name}")
