"""K4: fused affine + SiLU + 3x3 conv (+ residual) for the residual blocks.

Counterpart of xdiffusion_tpu/ops/fused_resblock.py:

    out = conv3x3_same(silu(x * a + off), w) + bias [+ residual]

with x (B, H, W, C) NHWC, a/off (B, C) per-(batch, channel) fp32
coefficients (a GroupNorm with any timestep scale-shift folded in, see
ops/norm.py), w (3, 3, C, Co) HWIO, bias (Co,), residual (B, H, W, Co).

The weight stays in the JAX package's HWIO layout: the kernel of
`csrc/affine_silu_conv3x3.cu` reads it as the (9*C, Co) row-major matrix
of its implicit GEMM. `conv_plan` picks the kernel's variant and geometry
from the shape before the launch. On CPU tensors the plain version runs;
it mirrors the JAX package's `_xla_impl` (affine and SiLU in the activation
dtype, then the convolution).

`affine_silu_conv3x3` is a `torch.autograd.Function` whose forward is the
kernel. Its backward is, as in the JAX package's custom vjp
(fused_resblock.py:223-242), autograd of the plain version without the
residual, and the cotangent itself for the residual.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, plain_vjp, require_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN = ctypes.POINTER(ctypes.c_int)
KERNEL = Kernel(
    "affine_silu_conv3x3", "xd_affine_silu_conv3x3",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _PLAN, _P],
)


# ---- the launch plan of K4 ---------------------------------------------------
#
# Two variants (csrc/affine_silu_conv3x3.cu):
# - "staged": bf16 with C % 32 == 0, Co % 8 == 0 and W <= 128. A tile is
#   TILE_M GEMM rows of whole image rows: `tile_rows` rows of one image, or
#   `images` whole images (tile_rows = H) where an image holds at most
#   TILE_M / 2 pixels; its N tile is `bn` output channels. K is walked in
#   units (chunk j of CHUNK input channels, tap t), chunk-major, 9 taps a
#   chunk, a tap row (3 units) to each group of wgmma. `splits` cut the tap
#   rows of every tile into contiguous ranges (split s takes units
#   [3 * (s * R // splits), 3 * ((s + 1) * R // splits)), R = units / 3),
#   whose fp32 partials a second launch sums in split order. Tiles are
#   numbered split fastest, then N tile, then M tile (image group, then
#   tile rows of an image); a persistent grid of `grid` blocks takes tiles
#   blockIdx.x, + grid, ... For each chunk a block stages the halo'd region
#   of its tile once: `staged_pixels` = images x (tile_rows + 2) x (W + 2)
#   pixels of CHUNK channels. Splits are taken where the tiles alone would
#   leave more than half of the SMs idle (the 8x8, 4x4 and 2x2 maps), and
#   only as far as each split keeps SPLIT_MIN_MACS of work.
# - "generic": everything else (fp32, other channel counts): 64 x 64 tiles
#   over (B*H*W, Co), one launch, no workspace.

SMEM_LIMIT = 232_448   # dynamic shared memory a block may opt into (H100)
SMS = 132              # streaming multiprocessors of an H100 SXM
TILE_M = 128           # GEMM rows (output pixels) of a staged tile
CHUNK = 64             # input channels a staged chunk (one k unit a tap)
STAGES = 6             # weight tiles in flight (two tap rows); fewer where they don't fit
MIN_STAGES = 4
A_BUFFERS = 3          # staged activation buffers (loads run two chunks ahead)
SPLIT_MIN_MACS = 3 << 20  # least multiply-adds a split of a tile keeps
MAX_STAGED_PIXELS = 768   # 64 activation passes of 12 pixels: one 64-bit mask each
_ALIGN = 1024                  # the 128-byte swizzle's atom
GENERIC_TILE = 64
VARIANTS = ("generic", "staged")


class ConvPlan(NamedTuple):
    """variant: one of VARIANTS. Staged: tile_rows, images, bn, splits and
    stages as above; m_tiles x n_tiles x splits tiles on `grid` persistent
    blocks; units = 9 x ceil(C / CHUNK); staged_pixels per chunk buffer;
    smem the dynamic shared bytes of a block. Generic: its (M, N) tiles of
    GENERIC_TILE, grid = m_tiles x n_tiles, the rest 0 or 1."""
    variant: str
    tile_rows: int
    images: int
    bn: int
    splits: int
    stages: int
    grid: int
    smem: int
    m_tiles: int
    n_tiles: int
    units: int
    staged_pixels: int

    def workspace(self, b: int, h: int, w: int, co: int) -> int:
        """fp32 elements of the split partials (0 for one split)."""
        return self.splits * b * h * w * co if self.splits > 1 else 0

    def as_ints(self):
        vals = (VARIANTS.index(self.variant), self.tile_rows, self.images, self.bn,
                self.splits, self.stages, self.grid, self.smem)
        return (ctypes.c_int * len(vals))(*vals)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def staged_smem(bn: int, stages: int, staged_pixels: int) -> int:
    """A staged block's shared memory: alignment slack, the weight ring
    (stages x CHUNK x bn bf16), A_BUFFERS activation buffers of 128 bytes a
    staged pixel (each rounded up to _ALIGN), the bf16 output tile, the
    tile's bias and the mbarriers (full and empty per weight stage; loaded,
    activated and read per activation buffer; one for the residual)."""
    a_bytes = _cdiv(staged_pixels * CHUNK * 2, _ALIGN) * _ALIGN
    return (_ALIGN + stages * CHUNK * bn * 2 + A_BUFFERS * a_bytes + TILE_M * bn * 2 + bn * 4
            + (2 * stages + 3 * A_BUFFERS + 1) * 8)


def conv_plan(b: int, h: int, w: int, c: int, co: int, dtype: torch.dtype) -> ConvPlan:
    """K4's launch plan for x (b, h, w, c) and co output channels."""
    if min(b, h, w, c, co) <= 0:
        raise ValueError(f"conv_plan: empty shape b={b} h={h} w={w} c={c} co={co}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_plan: dtype {dtype} not supported")
    if dtype != torch.bfloat16 or c % 32 or co % 8 or w > TILE_M:
        mt, nt = _cdiv(b * h * w, GENERIC_TILE), _cdiv(co, GENERIC_TILE)
        return ConvPlan("generic", 0, 1, GENERIC_TILE, 1, 0, mt * nt, 0, mt, nt, 0, 0)
    bn = 64 if co <= 64 else 128
    if h * w <= TILE_M // 2:
        rows, images = h, min(b, TILE_M // (h * w))
    else:
        rows, images = min(h, TILE_M // w), 1
    while True:  # fewer images a tile until the buffers and the ring fit
        pixels = images * (rows + 2) * (w + 2)
        stages = next((s for s in range(STAGES, MIN_STAGES - 1, -1)
                       if staged_smem(bn, s, pixels) <= SMEM_LIMIT
                       and pixels <= MAX_STAGED_PIXELS), None)
        if stages is not None or images == 1:
            break
        images -= 1
    if stages is None:
        raise ValueError(f"conv_plan: no staged tile fits for h={h} w={w}")
    m_tiles = _cdiv(b, images) * _cdiv(h, rows)
    n_tiles = _cdiv(co, bn)
    units = 9 * _cdiv(c, CHUNK)
    tiles = m_tiles * n_tiles
    # Split only tiles worth more than a partial sum's pass.
    tile_macs = TILE_M * bn * 9 * c
    splits = (1 if tiles >= SMS // 2
              else max(1, min(units // 3, SMS // tiles, tile_macs // SPLIT_MIN_MACS)))
    return ConvPlan("staged", rows, images, bn, splits, stages,
                    min(tiles * splits, SMS), staged_smem(bn, stages, pixels),
                    m_tiles, n_tiles, units, pixels)


@functools.lru_cache(maxsize=None)
def _plan_ints(b: int, h: int, w: int, c: int, co: int, dtype: torch.dtype):
    plan = conv_plan(b, h, w, c, co, dtype)
    return plan, plan.as_ints()


def conv2d_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, bias=None, stride: int = 1,
                padding: int = 0, groups: int = 1) -> torch.Tensor:
    """F.conv2d on NHWC tensors (OIHW weight); returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def affine_silu_conv3x3_plain(x, a, off, kernel_w, bias, residual=None,
                              apply_silu: bool = True) -> torch.Tensor:
    bsz, c = x.shape[0], x.shape[-1]
    y = x * a.reshape(bsz, 1, 1, c).to(x.dtype) + off.reshape(bsz, 1, 1, c).to(x.dtype)
    if apply_silu:
        y = F.silu(y)
    out = conv2d_nhwc(y, kernel_w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    out = out + bias.to(x.dtype)
    if residual is not None:
        out = out + residual
    return out


def _forward(x, a, off, kernel_w, bias, residual, apply_silu: bool) -> torch.Tensor:
    bsz, h, w, c = x.shape
    co = kernel_w.shape[-1]
    if x.device.type == "cpu":
        return affine_silu_conv3x3_plain(x, a, off, kernel_w, bias, residual, apply_silu)
    tensors = (x, a, off, kernel_w, bias) + (() if residual is None else (residual,))
    require_cuda("affine_silu_conv3x3", *tensors)
    code = dtype_code("affine_silu_conv3x3", x)
    if kernel_w.dtype != x.dtype or (residual is not None and residual.dtype != x.dtype):
        raise TypeError("affine_silu_conv3x3: x, kernel_w and residual must share a dtype")
    if kernel_w.shape[2] != c or bias.shape != (co,):
        raise ValueError(f"affine_silu_conv3x3: kernel {tuple(kernel_w.shape)} for {c} channels")
    if residual is not None and residual.shape != (bsz, h, w, co):
        raise ValueError(f"affine_silu_conv3x3: residual {tuple(residual.shape)}")
    if not (x.is_contiguous() and kernel_w.is_contiguous()
            and (residual is None or residual.is_contiguous())):
        raise ValueError("affine_silu_conv3x3: x, kernel_w and residual must be contiguous")
    a = a.float().contiguous()
    off = off.float().contiguous()
    bias = bias.float().contiguous()
    plan, ints = _plan_ints(bsz, h, w, c, co, x.dtype)
    out = torch.empty((bsz, h, w, co), dtype=x.dtype, device=x.device)
    n_part = plan.workspace(bsz, h, w, co)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device) if n_part else None
    KERNEL.launch(x.data_ptr(), a.data_ptr(), off.data_ptr(), kernel_w.data_ptr(),
                  bias.data_ptr(), None if residual is None else residual.data_ptr(),
                  out.data_ptr(), None if part is None else part.data_ptr(),
                  bsz, h, w, c, co, int(apply_silu), code, ints)
    return out


class _AffineSiLUConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, off, kernel_w, bias, residual, apply_silu: bool):
        ctx.save_for_backward(x, a, off, kernel_w, bias)
        ctx.apply_silu = apply_silu
        return _forward(x, a, off, kernel_w, bias, residual, apply_silu)

    @staticmethod
    def backward(ctx, g):
        apply_silu = ctx.apply_silu
        grads = plain_vjp(
            lambda *ops: affine_silu_conv3x3_plain(*ops, None, apply_silu),
            ctx.saved_tensors, g, ctx.needs_input_grad[:5])
        return grads + (g if ctx.needs_input_grad[5] else None, None)


def affine_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor,
                        kernel_w: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        apply_silu: bool = True) -> torch.Tensor:
    """conv3x3_same(silu(x * a + off), kernel_w) + bias [+ residual],
    differentiable in every tensor argument."""
    if kernel_w.ndim != 4 or kernel_w.shape[:2] != (3, 3):
        raise ValueError("affine_silu_conv3x3: 3x3 HWIO kernels only")
    bsz, c = x.shape[0], x.shape[-1]
    return _AffineSiLUConv3x3.apply(x, a.reshape(bsz, c), off.reshape(bsz, c), kernel_w,
                                    bias, residual, apply_silu)
