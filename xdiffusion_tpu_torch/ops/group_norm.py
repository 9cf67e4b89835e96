"""K3: GroupNorm (+ SiLU) over the trailing channel axis of an NHWC map.

Counterpart of xdiffusion_tpu/ops/group_norm.py. `group_norm_silu` is a
`torch.autograd.Function`. On a CUDA tensor its forward launches the
hand-written kernel of `csrc/group_norm_silu.cu` on the launch plan of
`gn_plan`; on a CPU tensor it runs the plain version `group_norm_silu_plain`,
which mirrors the JAX package's `_xla_group_norm_silu` (two-pass fp32
statistics, eps 1e-5, the result rounded once to the input dtype). The JAX
package has no backward kernel for it (XLA differentiates the composition),
so the backward recomputes the plain version under autograd and
backpropagates through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from xdiffusion_tpu_torch.ops._build import (DTYPE_CODES, Kernel, dtype_code, plain_vjp,
                                             require_cuda)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN = ctypes.POINTER(ctypes.c_int)
KERNEL = Kernel(
    "group_norm_silu", "xd_group_norm_silu",
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _PLAN, _P],
)
_CLUSTERS_ARGS = [_I, _I, _I, _I, _I, _PLAN, ctypes.POINTER(ctypes.c_int)]


# ---- the launch plan of K3 ---------------------------------------------------
#
# A cluster of k blocks takes one batch element's (HW, C) slab: grid (k, B),
# block `rank` the pixel rows [rank * HW // k, (rank + 1) * HW // k). Each
# block's threads are `cols` channel vectors of `vec` elements (16 bytes, or
# one element) by `lanes` row lanes; a thread owns vector columns col,
# col + cols, ... and walks rows lane, lane + lanes, ... Two variants
# (csrc/group_norm_silu.cu):
# - "staged": the block's rows arrive in shared memory by bulk copies in
#   `pieces` pieces and every pass reads them there: one read of HBM. k is
#   the least of CLUSTERS whose share fits a block's shared memory
#   (SMEM_LIMIT) with B * k filling the SMs (FILL_SHARE of them), else
#   the largest that fits; slabs of at most SMALL_SLAB bytes (set by a
#   launch's latency, not by bytes) take k = 1. The kernel is bound by its
#   chain of latencies more than by bytes: one large block an SM, in one
#   wave, beat two smaller ones at every flagship site (tools/torch_gn_ab.py
#   --sweep), so the budget is the whole of a block's shared memory. Blocks
#   take THREADS threads, or WIDE_THREADS where a row is at most half a
#   warp's vectors (C <= 128 in bf16) and each row lane still walks at
#   least ROWS_PER_LANE rows; the rows arrive in PIECES pieces of at least
#   PIECE_MIN_BYTES (more pieces restart the row walk and cost more than
#   the overlap pays).
# - "stream": where no k stages the share, or the 16-byte vector does not
#   divide C (or x is not 16-byte aligned: scalar loads): every pass
#   re-reads the block's rows from global memory; k as above.

SMEM_LIMIT = 232_448      # dynamic shared memory a block may opt into (H100)
SMS = 132                 # streaming multiprocessors of an H100 SXM
FILL_SHARE = 15 / 16      # blocks that fill the card: B = 64, k = 2 (128)
CLUSTERS = (1, 2, 4, 8)   # cluster sizes (8: the largest portable one)
THREADS, WIDE_THREADS = 256, 512  # a block; WIDE: long rows of few vectors, and stream
ROWS_PER_LANE = 16
VEC_BYTES = 16
SMALL_SLAB = 16 << 10
PIECES, PIECE_MIN_BYTES = 2, 16 << 10
VARIANTS = ("staged", "stream")


class GnPlan(NamedTuple):
    """variant: one of VARIANTS; k: blocks in a cluster (one cluster per
    batch element); threads per block; vec: elements of a channel vector;
    pieces: bulk copies a block's rows arrive in (staged; 1 for stream);
    smem: a block's dynamic shared memory in bytes (`gn_smem`)."""
    variant: str
    k: int
    threads: int
    vec: int
    pieces: int
    smem: int

    def rows(self, hw: int, rank: int) -> Tuple[int, int]:
        """The pixel rows [lo, hi) of the cluster's block `rank`."""
        return rank * hw // self.k, (rank + 1) * hw // self.k

    def cols(self, c: int) -> int:
        """Channel vectors a row lane covers at once."""
        return min(c // self.vec, self.threads)

    def lanes(self, c: int) -> int:
        return self.threads // self.cols(c)

    def as_ints(self):
        vals = (VARIANTS.index(self.variant), self.k, self.threads, self.vec, self.pieces,
                self.smem)
        return (ctypes.c_int * len(vals))(*vals)


def gn_smem(variant: str, hw: int, c: int, groups: int, itemsize: int, k: int,
            threads: int, vec: int, pieces: int) -> int:
    """A block's shared memory: the staged rows (ceil(HW / k) of C), the row
    lanes' per-channel fp32 partials, scale and bias, four per-group fp32
    arrays (sum and centered-square partials, mean, inverse deviation), the
    pieces' mbarriers (8-byte aligned). csrc/group_norm_silu.cu `gn_smem` is
    the same."""
    lanes = threads // min(c // vec, threads)
    share = -(-hw // k) * c * itemsize if variant == "staged" else 0
    return -(-(share + (lanes + 2) * c * 4 + 16 * groups) // 8) * 8 + 8 * pieces


def gn_plan(b: int, hw: int, c: int, groups: int, dtype: torch.dtype, sms: int = SMS,
            aligned: bool = True) -> GnPlan:
    """K3's launch plan for x (b, hw, c) in `groups` groups; `aligned`: x's
    data is 16-byte aligned."""
    if min(b, hw, c, groups) <= 0:
        raise ValueError(f"gn_plan: empty shape b={b} hw={hw} c={c} groups={groups}")
    if c % groups:
        raise ValueError(f"gn_plan: {groups} groups do not divide {c} channels")
    if b > 65_535:
        raise ValueError(f"gn_plan: batch {b} exceeds the grid's 65535")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gn_plan: dtype {dtype} not supported (float32, bfloat16)")
    itemsize = 4 if dtype == torch.float32 else 2
    vec = VEC_BYTES // itemsize
    ks = [k for k in CLUSTERS if k <= hw]
    fill = sms * FILL_SHARE
    if aligned and c % vec == 0:
        staged = {}
        for k in ks:
            rows = hw // k  # the smallest block's rows
            pieces = max(1, min(PIECES, rows * c * itemsize // PIECE_MIN_BYTES))
            wide = c // vec <= 16 and rows >= ROWS_PER_LANE * WIDE_THREADS // (c // vec)
            for threads in (WIDE_THREADS, THREADS) if wide else (THREADS,):
                smem = gn_smem("staged", hw, c, groups, itemsize, k, threads, vec, pieces)
                if smem <= SMEM_LIMIT:
                    staged[k] = GnPlan("staged", k, threads, vec, pieces, smem)
                    break
        if staged:
            if hw * c * itemsize <= SMALL_SLAB:
                return staged[min(staged)]
            return staged[next((k for k in staged if b * k >= fill), max(staged))]
    else:
        vec = 1
    k = next((k for k in ks if b * k >= fill), ks[-1])
    return GnPlan("stream", k, WIDE_THREADS, vec, 1,
                  gn_smem("stream", hw, c, groups, itemsize, k, WIDE_THREADS, vec, 1))


@functools.lru_cache(maxsize=None)
def _launch_plan(b: int, hw: int, c: int, groups: int, dtype: torch.dtype, aligned: bool):
    """`gn_plan` and its ints, once per shape, after asking the card whether
    a cluster of the plan's geometry can be scheduled at all."""
    plan = gn_plan(b, hw, c, groups, dtype, aligned=aligned)
    ints = plan.as_ints()
    clusters = ctypes.c_int(0)
    query = KERNEL.symbol("xd_group_norm_silu_clusters", _CLUSTERS_ARGS)
    rc = query(b, hw, c, groups, DTYPE_CODES[dtype], ints, ctypes.byref(clusters))
    if rc != 0 or clusters.value < 1:
        raise RuntimeError(f"group_norm_silu: {plan} cannot be scheduled (code {rc}, "
                           f"{clusters.value} clusters)")
    return plan, ints


def group_norm_silu_plain(x, scale, bias, num_groups: int, eps: float = 1e-5,
                          apply_silu: bool = True) -> torch.Tensor:
    c = x.shape[-1]
    grouped = x.float().reshape(*x.shape[:-1], num_groups, c // num_groups)
    axes = tuple(range(1, grouped.ndim - 2)) + (grouped.ndim - 1,)
    mean = grouped.mean(dim=axes, keepdim=True)
    var = grouped.var(dim=axes, correction=0, keepdim=True)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = normed * scale.float() + bias.float()
    if apply_silu:
        out = F.silu(out)
    return out.to(x.dtype)


def _forward(x, scale, bias, num_groups: int, eps: float, apply_silu: bool,
             plan: Optional[GnPlan] = None):
    """K3 on CUDA tensors (on `gn_plan`'s plan unless `plan` is given), the
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)
    require_cuda("group_norm_silu", x, scale, bias)
    code = dtype_code("group_norm_silu", x)
    shape = x.shape
    b, c = shape[0], shape[-1]
    if len(shape) < 2 or c % num_groups != 0:
        raise ValueError(f"group_norm_silu: {num_groups} groups do not divide {c} channels")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("group_norm_silu: scale and bias must be (C,)")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be contiguous")
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    ptr = x.data_ptr()
    hw = x.numel() // (b * c) if b * c else 0
    ints = (plan.as_ints() if plan else
            _launch_plan(b, hw, c, num_groups, x.dtype, ptr % VEC_BYTES == 0)[1])
    out = torch.empty_like(x)
    KERNEL.launch(ptr, scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, hw, c, num_groups,
                  eps, int(apply_silu), code, ints)
    return out


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float, apply_silu: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        return _forward(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps, apply_silu = ctx.args
        grads = plain_vjp(
            lambda x, s, b: group_norm_silu_plain(x, s, b, num_groups, eps, apply_silu),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return grads + (None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """silu?(group_norm(x) * scale + bias) for x (B, ..., C); scale/bias (C,).
    Differentiable in x, scale and bias. Without a gradient to record (no
    grad mode, or no input that requires one) the forward runs directly."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
    return _forward(x, scale, bias, num_groups, eps, apply_silu)
