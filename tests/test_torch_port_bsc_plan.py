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
