"""`gn_plan`, the launch plan of K3 (the fused GroupNorm+SiLU): at every K3
site of the UNet configs the port runs, at batch 1 to 128, and at ragged
shapes, each cluster's blocks cover every pixel row once, k is a cluster
size the card launches (the least whose blocks fill the card), shared
memory fits the H100, the vector divides C, and every shipped site stages
its slab; the plan refuses what the kernel cannot take. A plain-torch
emulation of the kernel's reduction order (per-block, per-lane channel
partials, then per group, summed over the cluster in rank order, then the
centered pass; `csrc/group_norm_silu.cu`) with the plan's split matches the
JAX package's Pallas kernel (interpret mode) and its XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from xdiffusion_tpu_torch.layers.resnet import num_groups_for
from xdiffusion_tpu_torch.ops import group_norm as gn

# (HW, C, groups, SiLU) of each config's K3 sites (FastGroupNorm's plain
# form: the attention norms and the final norm), read by hooks on one
# forward of each.
CONFIG_SITES = {
    "ddpm_32x32_epsilon_discrete": [(256, 256, 32, False), (16, 256, 32, False),
                                    (1024, 128, 32, True)],
    "ddpm_32x32_v_discrete": [(256, 256, 32, False), (16, 256, 32, False),
                              (1024, 128, 32, True)],
    "ddpm_8x8_epsilon": [(16, 256, 32, False), (4, 256, 32, False), (64, 128, 32, True)],
    "rectified_flow_32x32": [(256, 256, 32, False), (16, 256, 32, False),
                             (1024, 128, 32, True)],
}
BATCHES = (1, 4, 16, 64, 128)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
SITE_CASES = [pytest.param(b, hw, c, g, dt, id=f"{name}-hw{hw}-c{c}-b{b}-{dt}")
              for name, sites in CONFIG_SITES.items() for hw, c, g, _ in sites
              for b in BATCHES for dt in DTYPES]
RAGGED_CASES = [pytest.param(3, hw, c, num_groups_for(c), dt, id=f"hw{hw}-c{c}-{dt}")
                for c in (4, 48, 64, 128, 256, 512, 1024)
                for hw in (1, 4, 49, 64, 256, 1024, 16384) for dt in DTYPES]
ATOL = 2e-5  # tests/test_torch_port_kernels.py: fp32, summation order only


def _check_plan(plan, b, hw, c, groups, dtype):
    itemsize = 4 if dtype == torch.float32 else 2
    assert plan.variant in gn.VARIANTS
    assert plan.k in gn.CLUSTERS and plan.k <= hw
    # Every pixel row of a batch element belongs to exactly one block of
    # its cluster, in rank order, and no block is empty.
    covered = []
    for rank in range(plan.k):
        lo, hi = plan.rows(hw, rank)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(hw))
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    assert plan.vec in (16 // itemsize, 1) and c % plan.vec == 0
    assert plan.cols(c) * plan.lanes(c) <= plan.threads and plan.lanes(c) >= 1
    assert plan.smem == gn.gn_smem(plan.variant, hw, c, groups, itemsize, plan.k, plan.threads,
                                   plan.vec, plan.pieces)
    assert plan.smem <= gn.SMEM_LIMIT == 232_448
    vec = 16 // itemsize
    ks = [k for k in gn.CLUSTERS if k <= hw]
    stages = {k: c % vec == 0 and gn.gn_smem("staged", hw, c, groups, itemsize, k, gn.THREADS,
                                              vec, 1) <= gn.SMEM_LIMIT for k in ks}
    if plan.variant == "stream":
        assert plan.pieces == 1 and plan.threads == gn.WIDE_THREADS
        # Only where the 16-byte vector does not divide C (or x is not
        # aligned: then scalar loads) or no cluster size stages the share.
        assert plan.vec == 1 or not any(stages.values())
    else:
        assert plan.vec == vec and stages[plan.k]
        assert 1 <= plan.pieces <= gn.PIECES
        # Each piece a whole number of rows and at least PIECE_MIN_BYTES.
        assert plan.pieces == 1 or (hw // plan.k) * c * itemsize >= (
            plan.pieces * gn.PIECE_MIN_BYTES)
        if hw * c * itemsize <= gn.SMALL_SLAB:
            assert plan.k == 1  # set by a launch's latency: one block
            return
        ks = [k for k in ks if stages[k]]
    # The least cluster size whose blocks fill the card, else the largest.
    fill = gn.SMS * gn.FILL_SHARE
    assert plan.k == next((k for k in ks if b * k >= fill), max(ks))


@pytest.mark.parametrize("b,hw,c,groups,dt", SITE_CASES)
def test_gn_plan_stages_every_unet_site(b, hw, c, groups, dt):
    dtype = DTYPES[dt]
    plan = gn.gn_plan(b, hw, c, groups, dtype)
    _check_plan(plan, b, hw, c, groups, dtype)
    assert plan.variant == "staged"
    if hw * c * (4 if dt == "fp32" else 2) <= gn.SMALL_SLAB:
        assert plan.k == 1  # latency-bound small slabs: one block


@pytest.mark.parametrize("b,hw,c,groups,dt", RAGGED_CASES)
def test_gn_plan_ragged(b, hw, c, groups, dt):
    dtype = DTYPES[dt]
    plan = gn.gn_plan(b, hw, c, groups, dtype)
    _check_plan(plan, b, hw, c, groups, dtype)
    itemsize = 4 if dt == "fp32" else 2
    stageable = (c * itemsize) % 16 == 0 and gn.gn_smem(
        "staged", hw, c, groups, itemsize, min(8, hw), gn.THREADS, 16 // itemsize, 1
    ) <= gn.SMEM_LIMIT
    assert (plan.variant == "staged") == stageable
    # Misaligned data reads by scalar loads on the stream variant.
    scalar = gn.gn_plan(b, hw, c, groups, dtype, aligned=False)
    _check_plan(scalar, b, hw, c, groups, dtype)
    assert (scalar.variant, scalar.vec) == ("stream", 1)


@pytest.mark.parametrize("args,match", [
    ((2, 16, 48, 5, torch.float32), "do not divide"),
    ((2, 16, 256, 0, torch.float32), "empty"),
    ((0, 16, 256, 32, torch.float32), "empty"),
    ((2, 0, 256, 32, torch.bfloat16), "empty"),
    ((2, 16, 0, 32, torch.bfloat16), "empty"),
    ((2, 16, 256, 32, torch.float16), "not supported"),
    ((2, 16, 256, 32, torch.float64), "not supported"),
    ((70_000, 16, 256, 32, torch.float32), "batch"),
], ids=["groups", "no-groups", "batch-0", "hw-0", "c-0", "fp16", "fp64", "grid"])
def test_gn_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        gn.gn_plan(*args)


def _emulate(x, scale, bias, groups, eps, silu, plan):
    """The kernel's arithmetic in plain torch, fp32: per block (rank) the
    per-lane channel sums (pass 1 piece by piece as the copies land), summed
    per channel over the lanes, per group over its channels, then over the
    cluster's blocks in rank order; the centered squares the same way; then
    (x - mean) * rsqrt(var + eps) * scale + bias, SiLU, one rounding."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    hw, cg, lanes = xf.shape[1], c // groups, plan.lanes(c)
    n = float(hw * cg)

    def cluster_sum(rows_of, pieces):
        total = torch.zeros(b, groups)
        for rank in range(plan.k):
            lo, hi = plan.rows(hw, rank)
            rows = hi - lo
            part = torch.zeros(lanes, b, c)
            for p in range(pieces):
                r0, r1 = lo + p * rows // pieces, lo + (p + 1) * rows // pieces
                for lane in range(lanes):
                    part[lane] += rows_of[:, r0 + lane:r1:lanes].sum(1)
            chan = part[0]
            for lane in range(1, lanes):
                chan = chan + part[lane]
            total = total + chan.reshape(b, groups, cg).sum(-1)
        return total

    mean = cluster_sum(xf, plan.pieces) / n
    d = xf - mean.repeat_interleave(cg, 1)[:, None, :]
    var = cluster_sum(d * d, 1) / n
    inv = torch.rsqrt(var + eps).repeat_interleave(cg, 1)[:, None, :]
    y = d * inv * scale.float() + bias.float()
    if silu:
        y = torch.nn.functional.silu(y)
    return y.reshape(x.shape).to(x.dtype)


# (x shape, groups, sms, SiLU): sms sets how many blocks fill the card, so
# that small shapes take each cluster size (k 1, 2, 4, 8), two pieces, 512
# threads and uneven rows (7x7).
EMULATION_CASES = [((2, 16, 16, 64), 32, 2, True), ((2, 16, 16, 64), 32, 4, False),
                   ((2, 16, 16, 64), 32, 8, True), ((2, 16, 16, 128), 32, 132, False),
                   ((3, 7, 7, 48), 12, 132, True), ((1, 64, 32, 32), 8, 1, False)]


@pytest.mark.parametrize("shape,groups,sms,silu", EMULATION_CASES,
                         ids=[f"{'x'.join(map(str, s))}-g{g}-sms{m}{'-silu' if a else ''}"
                              for s, g, m, a in EMULATION_CASES])
def test_emulated_reduction_order_matches_jax(shape, groups, sms, silu):
    from xdiffusion_tpu.ops.group_norm import _pallas_group_norm_silu, _xla_group_norm_silu

    rng = np.random.default_rng(7)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    hw = int(np.prod(shape[1:-1]))
    plan = gn.gn_plan(shape[0], hw, c, groups, torch.float32, sms=sms)
    got = _emulate(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), groups,
                   1e-5, silu, plan).numpy()
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5, silu)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(_pallas_group_norm_silu(*args))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, np.asarray(_xla_group_norm_silu(*args)), atol=ATOL,
                               rtol=ATOL)


def test_emulation_cases_take_every_cluster_size_and_variant():
    plans = [gn.gn_plan(shape[0], int(np.prod(shape[1:-1])), shape[-1], groups, torch.float32,
                        sms=sms) for shape, groups, sms, _ in EMULATION_CASES]
    assert {p.k for p in plans} == set(gn.CLUSTERS)
    assert max(p.pieces for p in plans) == gn.PIECES
    variants = {gn.gn_plan(3, 49, c, num_groups_for(c), torch.bfloat16).variant for c in (4, 48)}
    assert variants == set(gn.VARIANTS)


def test_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version, bit for bit, with or
    without a gradient to record."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((2, 4, 4, 64)) * 2).astype(np.float32))
    scale, bias = torch.ones(64), torch.zeros(64)
    want = gn.group_norm_silu_plain(x, scale, bias, 32)
    assert torch.equal(gn.group_norm_silu(x, scale, bias, 32), want)
    xg = x.clone().requires_grad_()
    out = gn.group_norm_silu(xg, scale, bias, 32)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)
