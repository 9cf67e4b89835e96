"""`flash_plan`, the launch plan of K5 and K6 (the streamed attention forward
and backward), and the numerics of their redesign.

At every site `chip_smoke.py` runs (the LTX paths' self- and cross-attention
at batch 4 and 8, 512 queries against 512 and 128 keys; 16,384 queries at
batch 1 against 16,384 and 128 keys; WideFormer-PixArt's 16 tokens against
77 caption keys and against themselves at batch 1 to 128; the MM-DiT
family's joint attention over 93, 144, 152 and 16 tokens at batch 2 to 128;
Sana's 16 queries against 300 caption keys at head dim 576 at batch 1 to
128), at ragged Sq and Sk, head dims 64, 128, 256 and 576, fp32 and bf16,
forward and backward: each launch covers every (batch,
head, row) tile of its axis exactly once, the dk/dv launch's split partials
cover the query walk in one fixed order, shared memory fits the H100, and
the dk/dv blocks cover the SMs where the plan splits. The CUDA entry points
launch exactly this geometry and refuse any other
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`).

Then two float64 emulations against the plain versions, within
`chip_smoke.py`'s fp32 tolerance (1e-5 of each output's largest value):
split TF32 (hi rounded to nearest with a 10-bit mantissa, lo the rest as
the tensor cores read it, three products a product), the arithmetic of the
fp32 kernels, for K5 and K6, with the wide variant's reduction order at
head dim 576 (each product over D nine fp32 partials of 64 columns, summed
in warp order in fp32; 16-key tiles);
and K6's dk/dv from the plan's split partials summed in split order.
"""

import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from xdiffusion_tpu_torch.ops import flash_attention as fa

SMS = 132
LONG = 16 * 32 * 32
HEADS = 6
# (B, Sq, Sk): chip_smoke.py's K5 (batch 4) and K6 (batch 8) sites at the
# shipped 8x8x8 grid and at the 16x32x32 grid.
SITES = {
    "self b4": (4, 512, 512), "cross b4": (4, 512, 128),
    "self b8": (8, 512, 512), "cross b8": (8, 512, 128),
    "self 16k": (1, LONG, LONG), "cross 16k": (1, LONG, 128),
}
RAGGED = [(3, sq, sk) for sq in (1, 63, 65, 200, 1000) for sk in (1, 63, 65, 200, 1000)]
# WideFormer-PixArt's K5/K6 sites (head dim 256): 16 queries against the 77
# caption keys, at the guided sampling batch (128) and in training (128),
# and smaller batches; its 16-token self-attention shape too.
WIDE_SITES = {f"wideformer {kind} b{b}": (b, 16, sk) for kind, sk in (("cross", 77), ("self", 16))
              for b in (1, 2, 32, 64, 128)}
# The MM-DiT family's joint attention, square over [text; image] tokens: SD3's
# 77 + 16, Flux's and Chewie's 128 + 16, AuraFlow's 8 registers + 128 + 16
# (head dim 256 as shipped), SD3.5's second, image-only attention over 16;
# at the guided sampling batch (128), the companions' CLI batch (16) and the
# card-against-CPU batch (2); then ragged neighbours and one key.
MMDIT_SITES = {f"{name} b{b}": (b, s, s) for name, s in
               (("sd3", 93), ("flux", 144), ("auraflow", 152), ("sd3.5 image", 16))
               for b in (2, 16, 128)}
MMDIT_RAGGED = [(3, 92, 92), (3, 145, 145), (3, 151, 151), (3, 144, 1), (3, 1, 152)]
# Sana's cross-attention (head dim 576 as shipped): 16 queries against the
# 300 caption keys at the guided sampling batch (128), the CLI's and the
# card-against-CPU batches, and its neighbours.
SANA_SITES = {f"sana b{b}": (b, 16, 300) for b in (1, 2, 32, 64, 128)}
SANA_RAGGED = [(3, 1, 300), (3, 17, 300), (3, 16, 1), (3, 16, 299), (3, 16, 301)]
CASES = [pytest.param(*s, id=name) for name, s in SITES.items()] + [
    pytest.param(*s, id=f"ragged-{s[1]}x{s[2]}") for s in RAGGED] + [
    pytest.param(*s, id=name) for name, s in WIDE_SITES.items()] + [
    pytest.param(*s, id=name) for name, s in MMDIT_SITES.items()] + [
    pytest.param(*s, id=f"mmdit ragged-{s[1]}x{s[2]}") for s in MMDIT_RAGGED] + [
    pytest.param(*s, id=name) for name, s in SANA_SITES.items()] + [
    pytest.param(*s, id=f"sana ragged-{s[1]}x{s[2]}") for s in SANA_RAGGED]
WIDE_DIMS = (256, 576)


def _cdiv(a, b):
    return -(-a // b)


def _covered(plan, launch, b, heads, sq, sk):
    """How often the launch's blocks reach each (batch, head, row tile) of
    its axis, tiles of 64 rows or of a block's rows where it takes fewer
    (the wide variant's 16), as the kernels map blocks (the dk/dv launch:
    batch z // splits)."""
    n = sk if launch.axis == "keys" else sq
    unit = min(launch.rows, fa.FLASH_TILE)
    tiles = _cdiv(n, unit)
    hits = np.zeros((b, heads, tiles), dtype=np.int64)
    gx, gy, gz = launch.grid
    splits = plan.splits if launch.axis == "keys" else 1
    assert gy == heads and gz == b * splits
    per = launch.rows // unit
    for z in range(gz):
        for x in range(gx):
            hits[z // splits, :, x * per:(x + 1) * per] += 1
    return hits / splits  # each split of a key tile walks one range of its queries


def _split_ranges(plan, sq):
    """The query-tile range [t0, t1) of each split, as `Walk` computes it."""
    qtiles = _cdiv(sq, fa.FLASH_TILE)
    return [(s * plan.tiles_per_split, min((s + 1) * plan.tiles_per_split, qtiles))
            for s in range(plan.splits)]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [64, 128, 256, 576])
@pytest.mark.parametrize("b,sq,sk", CASES)
def test_plan_covers_each_tile_once_and_fits(b, sq, sk, d, dtype, backward):
    plan = fa.flash_plan(b, HEADS, sq, sk, d, dtype, sms=SMS, backward=backward)
    # The variant by dtype and head dim: split TF32 for fp32, wgmma for bf16
    # at D 64, mma.sync for bf16 at D 128; at D 256 and 576 the wide variant
    # in both dtypes.
    assert plan.variant == ("wide" if d in WIDE_DIMS else "tf32" if dtype == torch.float32 else
                            "wgmma" if d == 64 else "mma")
    wide = plan.variant == "wgmma"
    assert [ln.axis for ln in plan.launches] == (["queries", "keys"] if backward else
                                                 ["queries"])
    kinds = ["dq", "dkv"] if backward else ["fwd"]
    for launch, kind in zip(plan.launches, kinds):
        # wgmma: warpgroups of 64 rows and a producer warp; else 4 warps of
        # 16 rows, in the fp32 forward and dq launches at D 64 of two row
        # tiles each where the grid of 128-row blocks stays at RESIDENT
        # blocks an SM.
        two = ((kind, dtype, d) in (("dq", torch.float32, 64), ("fwd", torch.float32, 64))
               and -(-sq // 128) * HEADS * b >= fa.RESIDENT["tf32"] * SMS)
        groups = fa.WG_GROUPS[kind] if wide else 2 if two else 1
        # The wide variant: D / 64 warps (4 or 9) on one tile of 16 rows.
        assert launch.rows == (fa.FLASH_WIDE_ROWS if d in WIDE_DIMS else 64 * groups)
        assert launch.threads == (128 * groups + 32 if wide else
                                  32 * (d // 64) if d in WIDE_DIMS else 128)
        # Dynamic shared memory, with the dq kernels' static 64 floats of
        # delta, within the 227 KB a block may opt into.
        assert 0 < launch.smem + 256 <= fa.SMEM_LIMIT == 232_448
        assert launch.grid[0] <= 2 ** 31 - 1 and max(launch.grid[1:]) <= 65535
        np.testing.assert_array_equal(_covered(plan, launch, b, HEADS, sq, sk), 1)
    ints = list(plan.as_ints())
    assert ints[0] == fa.FLASH_VARIANTS.index(plan.variant)
    first = plan.launches[0]
    if not backward:
        assert plan.splits == 1 and len(ints) == 7
        assert ints[1:] == [first.rows, *first.grid, first.threads, first.smem]
        return
    dq, dkv = plan.launches
    assert ints == [ints[0], dq.rows, dq.grid[0], dq.threads, dq.smem, dkv.rows, dkv.grid[0],
                    dkv.threads, dkv.smem, plan.splits, plan.tiles_per_split]
    if not wide:
        assert dq.threads == dkv.threads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [64, 128, 256, 576])
@pytest.mark.parametrize("b,sq,sk", CASES)
def test_split_walk_is_fixed_and_fills_the_card(b, sq, sk, d, dtype):
    """The dk/dv launch's splits are contiguous, ascending, non-empty ranges
    that cover every query tile once (their partials sum in this order), and
    the split fills the card: one split where the key blocks alone reach
    the blocks the card holds at once (RESIDENT an SM), else as many
    blocks as that, or one a query tile of each key block if that is
    fewer."""
    plan = fa.flash_plan(b, HEADS, sq, sk, d, dtype, sms=SMS, backward=True)
    qtiles = _cdiv(sq, fa.FLASH_TILE)
    ranges = _split_ranges(plan, sq)
    assert ranges[0][0] == 0 and ranges[-1][1] == qtiles
    assert all(t0 < t1 for t0, t1 in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    assert all(t1 - t0 == plan.tiles_per_split for t0, t1 in ranges[:-1])
    key_blocks = plan.launches[1].grid[0] * HEADS * b
    target = fa.RESIDENT[plan.variant] * SMS
    if key_blocks >= target:
        assert plan.splits == 1
    else:
        assert key_blocks * plan.splits >= min(target, key_blocks * qtiles)
        assert plan.splits <= qtiles


def test_split_counts_at_the_named_sites():
    """The sites the split walk is aimed at: the 16,384-token cross sites
    (12 tf32 or 6 wgmma key blocks unsplit) and the training path's cross
    sites (96 or 48); the self sites keep one split."""
    def splits(b, sq, sk, dtype):
        p = fa.flash_plan(b, HEADS, sq, sk, 64, dtype, sms=SMS, backward=True)
        return p.splits, p.launches[1].grid[0] * HEADS * b * p.splits

    assert splits(1, LONG, 128, torch.float32) == (24, 288)
    assert splits(1, LONG, 128, torch.bfloat16) == (24, 144)
    assert splits(8, 512, 128, torch.float32) == (4, 384)
    assert splits(8, 512, 128, torch.bfloat16) == (4, 192)
    assert splits(8, 512, 512, torch.float32) == (1, 384)
    assert splits(8, 512, 512, torch.bfloat16) == (1, 192)
    # The fp32 dq and forward launches: two row tiles a warp at 16,384
    # queries, one on the main paths' 512 (192 or 96 blocks of 128 rows
    # would leave SMs idle).
    for backward, b in ((True, 8), (False, 4)):
        rows = [fa.flash_plan(bb, HEADS, sq, sk, 64, torch.float32, sms=SMS,
                              backward=backward).launches[0].rows
                for bb, sq, sk in ((1, LONG, LONG), (1, LONG, 128), (b, 512, 512), (b, 512, 128))]
        assert rows == [128, 128, 64, 64]
    assert splits(1, LONG, LONG, torch.float32)[0] == 1
    assert splits(1, LONG, LONG, torch.bfloat16)[0] == 1
    # Another card: the plan takes its SM count.
    assert fa.flash_plan(1, HEADS, LONG, 128, 64, torch.float32, sms=66,
                         backward=True).splits == 12


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        fa.flash_plan(1, 2, 64, 64, 32, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_plan(1, 2, 64, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        fa.flash_plan(1, 2, 0, 64, 64, torch.float32)


# ---- float64 emulations of the fp32 kernels' arithmetic ------------------------


def _tf32(x):
    """fp32 x rounded to TF32 (10-bit mantissa), to nearest, ties away from
    zero: `cvt.rna.tf32.f32`."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _truncated(x):
    """fp32 x as the tensor cores read a .tf32 operand: its low 13 bits
    dropped."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """hi = tf32(x) rounded to nearest, lo = x - hi read as TF32."""
    x = np.asarray(x, dtype=np.float32)
    hi = _tf32(x)
    lo = _truncated(x - hi)
    return hi.astype(np.float64), lo.astype(np.float64)


def _mm(a, b, products=3):
    """a @ b of fp32 operands as the tensor cores take them in split TF32:
    lo.hi + hi.lo + hi.hi (products=3), or hi.hi alone (1), summed in
    float64."""
    ah, al = _split(a)
    bh, bl = _split(b)
    out = ah @ bh
    return out + ah @ bl + al @ bh if products == 3 else out


def _dots(a, b, products=3):
    """a @ b contracting over D. The wide variant (D 256 and 576) sums it as
    its warps do: D / 64 partials of 64 columns, each a split-TF32 product
    rounded to fp32, added in warp order in fp32."""
    d = a.shape[1]
    if d not in WIDE_DIMS:
        return _mm(a, b, products)
    total = None
    for c0 in range(0, d, 64):
        part = _mm(a[:, c0:c0 + 64], b[c0:c0 + 64], products).astype(np.float32)
        total = part if total is None else total + part
    return total.astype(np.float64)


def _k5_emulated(q, k, v, scale, products=3):
    """One (batch, head) of the fp32 K5 (tf32, or wide at D 256 and 576):
    key tiles of 64 (wide: 32 at D 256, 16 at D 576), the running max and
    sum, p as fp32 split again for P.V."""
    sq, d = q.shape
    tile = fa.FLASH_WIDE_TILE.get(d, fa.FLASH_TILE)
    m, l, acc = np.full(sq, -np.inf), np.zeros(sq), np.zeros((sq, d))
    for t0 in range(0, k.shape[0], tile):
        s = _dots(q, k[t0:t0 + tile].T, products).astype(np.float32) * np.float32(scale)
        mn = np.maximum(m, s.max(axis=1))
        a = np.exp(m - mn)
        p = np.exp(s - mn[:, None]).astype(np.float32)
        l = l * a + p.sum(axis=1)
        acc = acc * a[:, None] + _mm(p, v[t0:t0 + tile], products)
        m = mn
    return acc / l[:, None], m + np.log(l)


def _k6_emulated(q, k, v, o, lse, g, scale, ranges, products=3):
    """One (batch, head) of the fp32 K6 (tf32 or wide): the dq pass, then dk
    and dv as fp32 partials over the split ranges of query tiles, summed in
    split order."""
    f32 = np.float32
    delta = (g.astype(np.float64) * o).sum(axis=1)

    def ds_of(s, dp, rows):
        p = np.exp(s.astype(f32) * f32(scale) - lse[rows, None])
        return p, (p * (dp - delta[rows, None]) * scale).astype(f32)

    _, ds = ds_of(_dots(q, k.T, products), _dots(g, v.T, products), slice(None))
    dq = _mm(ds, k, products)
    dk, dv = np.zeros(k.shape, f32), np.zeros(v.shape, f32)
    for t0, t1 in ranges:
        rows = slice(t0 * fa.FLASH_TILE, t1 * fa.FLASH_TILE)
        st, dpt = _dots(k, q[rows].T, products).T, _dots(v, g[rows].T, products).T
        p, ds = ds_of(st, dpt, rows)
        dv = dv + _mm(p.astype(f32).T, g[rows], products).astype(f32)
        dk = dk + _mm(ds.T, q[rows], products).astype(f32)
    return dq, dk, dv


def _inputs(seed, b, h, sq, sk, d, spread=2.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, s, d)) * spread).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("d", [64, 128, 256, 576])
@pytest.mark.parametrize("sq,sk", [(1, 200), (100, 65), (130, 300), (144, 144), (93, 93),
                                   (16, 300)])
def test_split_tf32_forward_matches_plain(sq, sk, d):
    q, k, v, _ = _inputs(sq * 7 + sk + d, 1, 2, sq, sk, d)
    scale = d ** -0.5
    want_o, want_lse = (t.numpy() for t in fa.flash_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), scale))
    worst_one = 0.0
    for h in range(2):
        o, lse = _k5_emulated(q[0, h], k[0, h], v[0, h], scale)
        assert np.abs(o - want_o[0, h]).max() <= _tol(want_o)
        assert np.abs(lse - want_lse[0, h, :, 0]).max() <= 1e-5 * np.abs(want_lse).max()
        o1, _ = _k5_emulated(q[0, h], k[0, h], v[0, h], scale, products=1)
        worst_one = max(worst_one, np.abs(o1 - want_o[0, h]).max())
    # One TF32 product would not do: the split is what holds 1e-5.
    assert worst_one > _tol(want_o)


@pytest.mark.parametrize("d", [64, 128, 256, 576])
@pytest.mark.parametrize("b,sq,sk", [(1, 1000, 65), (1, 200, 200), (2, 63, 1000),
                                     (2, 144, 144), (2, 16, 300)])
def test_split_tf32_backward_and_split_sum_match_plain(b, sq, sk, d):
    """K6 in split TF32 with dk and dv summed from the plan's split partials
    (at these small key counts the plan splits the query walk: see
    test_split_walk_is_fixed_and_fills_the_card)."""
    q, k, v, g = _inputs(sq + sk * 3 + d, b, 2, sq, sk, d)
    scale = d ** -0.5
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    o, lse = fa.flash_attention_plain(tq, tk, tv, scale)
    want = [t.numpy() for t in fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tg, scale)]
    plan = fa.flash_plan(b, 2, sq, sk, d, torch.float32, sms=SMS, backward=True)
    ranges = _split_ranges(plan, sq)
    assert len(ranges) == plan.splits
    if sq > fa.FLASH_TILE:
        assert plan.splits > 1
    o, lse = o.numpy(), lse.numpy()[..., 0]
    worst_one = 0.0
    for bi in range(b):
        for h in range(2):
            args = (q[bi, h], k[bi, h], v[bi, h], o[bi, h], lse[bi, h], g[bi, h], scale)
            for got, ref in zip(_k6_emulated(*args, ranges), want):
                assert np.abs(got - ref[bi, h]).max() <= _tol(ref)
            worst_one = max(worst_one, max(
                np.abs(x - ref[bi, h]).max() / _tol(ref)
                for x, ref in zip(_k6_emulated(*args, ranges, products=1), want)))
    assert worst_one > 1.0
