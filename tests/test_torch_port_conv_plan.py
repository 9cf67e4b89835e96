"""`conv_plan`, the launch plan of K4 (the fused affine+SiLU+conv3x3): at
every site of the UNet configs the port runs, and at ragged shapes, the
staged variant covers every output pixel and channel exactly once, its K
splits cover all 9*C in a fixed order, its shared memory fits the H100, and
each tile's staged halo stays inside its own images; the generic variant
takes fp32 and the channel counts the staged one refuses. A plain-PyTorch
emulation of the staged kernel's indexing (halo staging, tap shifts, the
split sum in the plan's order; `csrc/affine_silu_conv3x3.cu`, `staged::`)
matches `affine_silu_conv3x3_plain` at small sizes."""

import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from xdiffusion_tpu_torch.ops import fused_resblock as fr

# (H, W, C, Co) of the flagship's 44 K4 sites of a sampling forward, with
# their counts (ddpm_32x32_epsilon_discrete.yaml), and of ddpm_8x8_epsilon.yaml.
FLAGSHIP = {(32, 32, 128, 128): 7, (32, 32, 256, 128): 2, (32, 32, 384, 128): 1,
            (16, 16, 128, 256): 1, (16, 16, 256, 256): 6, (16, 16, 384, 256): 1,
            (16, 16, 512, 256): 2, (8, 8, 256, 256): 7, (8, 8, 512, 256): 3,
            (4, 4, 256, 256): 11, (4, 4, 512, 256): 3}
SMALL = {(8, 8, 128, 128): 7, (8, 8, 256, 128): 2, (8, 8, 384, 128): 1, (4, 4, 128, 256): 1,
         (4, 4, 256, 256): 6, (4, 4, 384, 256): 1, (4, 4, 512, 256): 2,
         (2, 2, 256, 256): 11, (2, 2, 512, 256): 3}
# (B, H, W, C, Co): partial last tiles (H*W not a multiple of 128 rows), a
# half chunk (C = 96), C = 48 and Co = 40 (generic and staged), 1x1 maps.
RAGGED = [(3, 12, 12, 96, 40), (2, 8, 8, 48, 40), (5, 5, 7, 64, 136), (3, 33, 20, 32, 64),
          (4, 3, 3, 96, 128), (2, 1, 1, 64, 72), (1, 128, 128, 32, 8), (7, 9, 9, 160, 256)]
CASES = ([pytest.param(64, *s, id=f"flagship-b64-{s[0]}x{s[1]}-c{s[2]}-co{s[3]}")
          for s in FLAGSHIP]
         + [pytest.param(128, *s, id=f"flagship-b128-{s[0]}x{s[1]}-c{s[2]}-co{s[3]}")
            for s in FLAGSHIP]
         + [pytest.param(64, *s, id=f"8x8-b64-{s[0]}x{s[1]}-c{s[2]}-co{s[3]}") for s in SMALL]
         + [pytest.param(*s, id=f"ragged-{'x'.join(map(str, s))}") for s in RAGGED])


def _cdiv(a, b):
    return -(-a // b)


def _tiles(plan, b, h, w, co):
    """Every tile of a staged plan as the kernel numbers it (split fastest,
    then N tile, then M tile): (split, n0, b0, y0, (u_lo, u_hi))."""
    tpi = _cdiv(h, plan.tile_rows)
    for t in range(plan.m_tiles * plan.n_tiles * plan.splits):
        split, rest = t % plan.splits, t // plan.splits
        nt, mt = rest % plan.n_tiles, rest // plan.n_tiles
        rows = plan.units // 3
        units = (3 * (split * rows // plan.splits), 3 * ((split + 1) * rows // plan.splits))
        yield split, nt * plan.bn, (mt // tpi) * plan.images, (mt % tpi) * plan.tile_rows, units


def _rows(plan, b, h, w, b0, y0):
    """The tile's output pixels by GEMM row (-1: empty) and each row's staged
    pixel at tap (0, 0), as `out_pixel` of the kernel computes them."""
    r = np.arange(fr.TILE_M)
    per = plan.tile_rows * w
    i, rr = r // per, r % per
    y, x = rr // w, rr % w
    ok = (i < plan.images) & (b0 + i < b) & (y0 + y < h)
    m = np.where(ok, ((b0 + i) * h + y0 + y) * w + x, -1)
    s = np.where(ok, (i * (plan.tile_rows + 2) + y) * (w + 2) + x, 0)
    return m, s


def _staged_source(plan, b, h, w, b0, y0):
    """(batch, row, column) each staged pixel of the tile reads, or None
    for a zero: the halo outside the image, or past the batch."""
    sr, p = plan.tile_rows + 2, w + 2
    src = []
    for s in range(plan.staged_pixels):
        i, rem = divmod(s, sr * p)
        yy, xx = y0 - 1 + rem // p, rem % p - 1
        inside = b0 + i < b and 0 <= yy < h and 0 <= xx < w
        src.append((b0 + i, yy, xx) if inside else None)
    return src


@pytest.mark.parametrize("b,h,w,c,co", CASES)
def test_plan_covers_each_output_once_and_fits(b, h, w, c, co):
    plan = fr.conv_plan(b, h, w, c, co, torch.bfloat16)
    staged = c % 32 == 0 and co % 8 == 0 and w <= fr.TILE_M
    assert plan.variant == ("staged" if staged else "generic")
    if not staged:
        assert plan.grid == _cdiv(b * h * w, fr.GENERIC_TILE) * _cdiv(co, fr.GENERIC_TILE)
        return
    assert plan.images * plan.tile_rows * w <= fr.TILE_M and plan.bn in (64, 128)
    assert plan.images == 1 or plan.tile_rows == h
    assert plan.stages >= fr.MIN_STAGES and plan.units == 9 * _cdiv(c, fr.CHUNK)
    assert plan.staged_pixels == plan.images * (plan.tile_rows + 2) * (w + 2)
    assert plan.staged_pixels <= fr.MAX_STAGED_PIXELS
    assert plan.smem == fr.staged_smem(plan.bn, plan.stages, plan.staged_pixels)
    assert 0 < plan.smem <= fr.SMEM_LIMIT == 232_448
    assert 1 <= plan.grid <= min(fr.SMS, plan.m_tiles * plan.n_tiles * plan.splits)
    hits = np.zeros((plan.splits, b * h * w, _cdiv(co, 8)), dtype=np.int32)
    seen_units = {}
    for split, n0, b0, y0, (u_lo, u_hi) in _tiles(plan, b, h, w, co):
        m, _ = _rows(plan, b, h, w, b0, y0)
        cols = np.arange(n0, min(n0 + plan.bn, co), 8) // 8
        hits[split][np.ix_(m[m >= 0], cols)] += 1
        seen_units.setdefault(split, (u_lo, u_hi))
        assert seen_units[split] == (u_lo, u_hi) and u_lo < u_hi
    np.testing.assert_array_equal(hits, 1)
    # The splits cut units 0 .. 9 * ceil(C / 64) into contiguous ranges of
    # whole tap rows, in order.
    bounds = [seen_units[s] for s in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.units
    assert all(lo % 3 == 0 and hi % 3 == 0 for lo, hi in bounds)
    assert all(bounds[s][1] == bounds[s + 1][0] for s in range(plan.splits - 1))


@pytest.mark.parametrize("b,h,w,c,co", [pytest.param(*p.values[:5], id=p.id)
                                        for p in CASES[:len(FLAGSHIP)]]
                         + [pytest.param(*s, id=f"ragged-{'x'.join(map(str, s))}")
                            for s in RAGGED if s[3] % 32 == 0])
def test_halo_stays_inside_each_image(b, h, w, c, co):
    """Every tap of every row reads a staged pixel inside the staged region,
    which holds exactly the input pixel the convolution needs there, or a
    zero exactly where that pixel lies outside the image."""
    plan = fr.conv_plan(b, h, w, c, co, torch.bfloat16)
    assert plan.variant == "staged"
    p = w + 2
    checked = set()
    for _, _, b0, y0, _ in _tiles(plan, b, h, w, co):
        if (b0, y0) in checked:
            continue
        checked.add((b0, y0))
        src = _staged_source(plan, b, h, w, b0, y0)
        m, s = _rows(plan, b, h, w, b0, y0)
        for r in np.nonzero(m >= 0)[0]:
            bb, rem = divmod(int(m[r]), h * w)
            y, x = divmod(rem, w)
            for dy in range(3):
                for dx in range(3):
                    k = int(s[r]) + dy * p + dx
                    assert 0 <= k < plan.staged_pixels
                    inside = 0 <= y + dy - 1 < h and 0 <= x + dx - 1 < w
                    assert src[k] == ((bb, y + dy - 1, x + dx - 1) if inside else None)


def test_variants_by_dtype_and_channels():
    """fp32 and channel counts off the staged grid take the generic kernel;
    every site of the shipped UNets takes the staged one."""
    for b, h, w, c, co in [(64, 32, 32, 128, 128), (8, 8, 8, 48, 40), (2, 4, 4, 96, 12),
                           (1, 4, 200, 64, 64)]:
        assert fr.conv_plan(b, h, w, c, co, torch.float32).variant == "generic"
    assert fr.conv_plan(8, 8, 8, 48, 40, torch.bfloat16).variant == "generic"
    assert fr.conv_plan(2, 4, 4, 96, 12, torch.bfloat16).variant == "generic"
    assert fr.conv_plan(1, 4, 200, 64, 64, torch.bfloat16).variant == "generic"
    assert fr.conv_plan(3, 12, 12, 96, 40, torch.bfloat16).variant == "staged"
    for sites in (FLAGSHIP, SMALL):
        for h, w, c, co in sites:
            assert fr.conv_plan(64, h, w, c, co, torch.bfloat16).variant == "staged"
    # The 32x32 and 16x16 maps fill the card without splits; the small maps
    # split their K so that the tiles cover more than half of the SMs.
    assert fr.conv_plan(64, 32, 32, 128, 128, torch.bfloat16).splits == 1
    assert fr.conv_plan(64, 16, 16, 256, 256, torch.bfloat16).splits == 1
    for h, c in ((8, 256), (4, 256), (4, 512), (2, 512)):
        plan = fr.conv_plan(64, h, h, c, 256, torch.bfloat16)
        assert plan.splits > 1 and plan.m_tiles * plan.n_tiles * plan.splits > fr.SMS // 2
    with pytest.raises(ValueError, match="empty"):
        fr.conv_plan(0, 8, 8, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        fr.conv_plan(2, 8, 8, 64, 64, torch.float16)


def test_site_lists_are_the_unets_own():
    """FLAGSHIP and SMALL are what hooks on FusedAffineConv read off the
    port's full-width UNets (one forward at batch 1 on the CPU)."""
    import os

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.layers.resnet import FusedAffineConv

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, want in (("ddpm_32x32_epsilon_discrete.yaml", FLAGSHIP),
                       ("ddpm_8x8_epsilon.yaml", SMALL)):
        model = GaussianDiffusion_DDPM(load_yaml(os.path.join(root, "configs/image/mnist", name)),
                                       device="cpu")
        found = {}

        def hook(mod, args, kwargs, out):
            key = (*args[0].shape[1:], mod.kernel.shape[-1])
            found[key] = found.get(key, 0) + 1

        net = model.score_network()
        hooks = [m.register_forward_hook(hook, with_kwargs=True)
                 for m in net.modules() if isinstance(m, FusedAffineConv)]
        size = net.input_spatial_size if hasattr(net, "input_spatial_size") else (
            32 if "32x32" in name else 8)
        with torch.inference_mode():
            model.predict_score(torch.zeros((1, size, size, 1)),
                                {"timestep": torch.zeros((1,), dtype=torch.long)})
        for h in hooks:
            h.remove()
        assert found == want, name


def _emulate(x, a, off, kw, bias, res, plan):
    """The staged kernel's arithmetic in float64, step by step as it indexes:
    per tile, each chunk's halo'd region staged once (zeros outside the image
    and past C), each unit's tap a shifted view of it times the unit's 64
    weight rows, split partials summed in split order, then bias and
    residual."""
    b, h, w, c = x.shape
    co = kw.shape[-1]
    act = torch.nn.functional.silu(x.double() * a.double()[:, None, None, :]
                                   + off.double()[:, None, None, :])
    wmat = kw.double().reshape(9 * c, co)
    part = torch.zeros(plan.splits, b * h * w, co, dtype=torch.float64)
    p = w + 2
    for split, n0, b0, y0, (u_lo, u_hi) in _tiles(plan, b, h, w, co):
        m, s = _rows(plan, b, h, w, b0, y0)
        src = _staged_source(plan, b, h, w, b0, y0)
        ncols = min(n0 + plan.bn, co) - n0
        staged = {}
        for u in range(u_lo, u_hi):
            j, tap = divmod(u, 9)
            if j not in staged:
                tile = torch.zeros(plan.staged_pixels, fr.CHUNK, dtype=torch.float64)
                nch = min(fr.CHUNK, c - j * fr.CHUNK)
                for k, pix in enumerate(src):
                    if pix is not None:
                        tile[k, :nch] = act[pix[0], pix[1], pix[2], j * fr.CHUNK:j * fr.CHUNK + nch]
                staged[j] = tile
            rows = torch.from_numpy(s + (tap // 3) * p + tap % 3)
            amat = staged[j][rows]
            # All 64 weight rows of the unit, as TMA loads them: past C they are
            # the next tap's rows (met by A's zeros), past 9 * C zeros.
            k0 = tap * c + j * fr.CHUNK
            bmat = torch.zeros(fr.CHUNK, plan.bn, dtype=torch.float64)
            kend = min(k0 + fr.CHUNK, 9 * c)
            bmat[:kend - k0, :ncols] = wmat[k0:kend, n0:n0 + ncols]
            prod = amat @ bmat
            valid = torch.from_numpy(m >= 0)
            part[split, torch.from_numpy(m[m >= 0]), n0:n0 + ncols] += prod[valid, :ncols]
    total = part[0]
    for k in range(1, plan.splits):
        total = total + part[k]
    total = total + bias.double()
    if res is not None:
        total = total + res.double().reshape(-1, co)
    return total.reshape(b, h, w, co)


@pytest.mark.parametrize("b,h,w,c,co,splits,residual", [
    (2, 8, 8, 64, 64, 1, True),     # whole images a tile
    (1, 12, 12, 96, 40, 2, False),  # rows of one image, a half chunk, Co = 40, 2 splits
    (2, 16, 16, 64, 136, 3, True),  # 8 rows a tile, two N tiles (the last partial), splits
    (3, 4, 4, 96, 72, 4, True),     # splits that cross a chunk boundary
    (5, 2, 2, 64, 72, 3, False),    # 2x2 maps: 5 images a tile, a tap row a split
    (2, 5, 7, 32, 8, 1, True),      # ragged images
])
def test_emulated_indexing_matches_plain(b, h, w, c, co, splits, residual):
    rng = np.random.default_rng(0)
    t = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    x, a, off = t(b, h, w, c), 1.0 + t(b, c, scale=0.2), t(b, c, scale=0.2)
    kw, bias = t(3, 3, c, co, scale=(9 * c) ** -0.5), t(co, scale=0.1)
    res = t(b, h, w, co) if residual else None
    plan = fr.conv_plan(b, h, w, c, co, torch.bfloat16)
    assert plan.variant == "staged" and plan.splits == splits
    want = fr.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)
    got = _emulate(x, a, off, kw, bias, res, plan)
    # float64 against the plain version's fp32 convolution: summation order.
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * want.abs().max().item(),
                               rtol=0)
