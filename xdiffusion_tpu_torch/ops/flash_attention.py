"""K1 and K2: fused non-causal attention in the (B, S, C=H*D) qkv-projection
layout, forward and backward; K5 and K6: the streamed attention on
(B, H, S, D), forward and backward; K7: attention on head-major
(B, H, S, D) tensors, forward (its backward is plain autograd).

Counterpart of `short_attention_bsc` in xdiffusion_tpu/ops/flash_attention.py
and its custom vjp. `short_attention_bsc` is a `torch.autograd.Function`:
its forward launches K1 (`csrc/bsc_attention.cu`) on CUDA tensors and saves
q, k and v; its backward launches K2 (`csrc/bsc_attention_bwd.cu`). On CPU
tensors the two plain versions run instead:

- the forward is the head-batched einsum path (`ops.attention.attention_bshd`):
  fp32 logits, fp32 softmax, probabilities rounded to v's dtype before PV;
- the backward, `short_attention_bsc_bwd_plain`, transcribes the TPU backward
  kernel `_bsc_bwd_kernel` with its three roundings (p to v's dtype, p back to
  fp32 for the row sum, ds * scale to q's dtype).

`flash_attention` is the counterpart of `flash_attention` / `_flash_forward`
and its custom vjp `_flash_bwd` in the same JAX module, a
`torch.autograd.Function` that saves q, k, v, the output and the per-row
logsumexp:

- the forward launches K5 (`csrc/flash_attention.cu`) on CUDA tensors, on
  `flash_plan`'s variant, which returns the output and the logsumexp; on
  CPU tensors `flash_attention_plain` computes both;
- the backward launches K6 (`csrc/flash_attention_bwd.cu`) on CUDA tensors,
  on `flash_plan`'s variant and split of the dk/dv query walk; on CPU
  tensors `flash_attention_bwd_plain` transcribes the TPU backward kernels
  `_flash_dq_kernel` and `_flash_dkv_kernel` with their roundings.

`short_attention` is K7, the counterpart of `short_attention` /
`_short_forward` and its custom vjp `_short_bwd`: non-causal attention on
head-major (B, H, S, D) tensors, a `torch.autograd.Function`:

- the forward launches K7 (`csrc/short_attention.cu`, K1's device code run
  with one head over the merged B*H axis) on CUDA tensors; on CPU tensors
  `short_attention_plain` runs instead;
- the backward is the vjp of `short_attention_plain`, recomputed from the
  saved q, k and v, as `_short_bwd` is an XLA vjp of the einsum reference
  with no Pallas kernel.

No module of the JAX package calls `short_attention`, so no path of the
port does either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, plain_vjp, require_cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_PLAN = ctypes.POINTER(ctypes.c_int)
KERNEL = Kernel(
    "bsc_attention", "xd_bsc_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _PLAN, _P],
)
BWD_KERNEL = Kernel(
    "bsc_attention_bwd", "xd_bsc_attention_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _PLAN, _P],
)
FLASH_KERNEL = Kernel(
    "flash_attention", "xd_flash_attention",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _PLAN, _P],
)
FLASH_BWD_KERNEL = Kernel(
    "flash_attention_bwd", "xd_flash_attention_bwd",
    [_P] * 11 + [_I, _I, _I, _I, _I, _STRIDES, _F, _I, _PLAN, _P],
)
SHORT_KERNEL = Kernel(
    "short_attention", "xd_short_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _STRIDES, _F, _I, _PLAN, _P],
)
HEAD_DIMS = (16, 32, 64, 128)      # K7's head dims
BSC_HEAD_DIMS = HEAD_DIMS + (256,)  # K1's and K2's: 256 on the wide variant
FLASH_HEAD_DIMS = (64, 128, 256, 576)


# ---- the launch plan of K1 and K2 (and K7, which runs K1's device code) -----
#
# Three variants, chosen by the key count Sk (csrc/bsc_attention.cuh):
# - "packed": Sq and Sk both at most 16 (or 32 for head dims up to 64). One
#   warp takes one whole (batch, head) slice; a block takes
#   `slices_per_block` of them. K2 runs one launch and one pass.
# - "row": Sk up to ROW_MAX_KEYS. A block takes 16 query rows per warp of one
#   (batch, head) and holds each row's logits over all keys (in registers
#   for bf16 up to REG_MAX_KEYS keys and head dim 64, else in a per-warp
#   shared strip), so Q.K^T is computed once. K2 adds a dk/dv launch, one
#   block per 64 keys, from the row statistics its dq launch writes. The
#   warps per block: the most of 4, 2, 1 whose shared memory fits.
# - "stream": longer Sk. 64 query rows a block, 64-key tiles walked twice (K1)
#   or three times (K2's dq launch), then K2's dk/dv launch.
# - "wide": head dim 256, any Sq and Sk (the SongUNet's one-head attention).
#   The stream variant's walks over 32-key tiles, 1, 2 or 4 warps of 16
#   query rows a block; K2's dk/dv kernel runs twice on launch 1's geometry
#   (dv, then dk), a warp of 16 keys holding one 16 x 256 accumulator. The
#   warps: the most of 4, 2, 1 whose shared memory fits and whose grid still
#   fills the SMs (`_wide_warps`).
#
# ROW_MAX_KEYS = 512 is measured: at 512 keys the row variant is as fast as
# the stream one or faster in fp32 and bf16, forward and backward, on the
# H100 (chip_smoke.py phase 2 times the two at 256, 384 and 512 keys). The
# CUDA side launches exactly the grid, block size and shared memory the
# plan gives, and refuses a plan that does not cover the shape.

SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt into (H100)
SMS = 132             # streaming multiprocessors of an H100 SXM
KEY_TILE = 64         # keys per streamed tile; query rows per stream block
FWD_STAGES = 4        # K1 row variant: 64-key tiles in its cp.async ring
DQ_STAGES = 2         # K2 row variant's dq launch: (k, v) tile pairs in its ring
DQ_REG_STAGES = 3     # ... with the logits in registers: single tiles in its ring
REG_MAX_KEYS = 256    # bf16, head dim <= 64: the longest Sk held in registers
ROW_MAX_KEYS = 512    # the threshold: the longest Sk the "row" variant takes
WIDE_HEAD_DIM = 256
WIDE_KEYS = 32        # wide variant: keys (dk/dv: queries) per streamed tile
WIDE_FWD_STAGES = {4: 2, 2: 3}  # K1's ring of single tiles, by element size
WIDE_PAIR_STAGES = 2  # K2's rings: stages of a tile pair
WIDE_LDP = WIDE_KEYS + 4  # fp32 rows of a warp's p / ds staging tile
VARIANTS = ("packed", "row", "stream", "wide")
_PLAN_INTS = 13       # variant, per_block, tile, then 5 ints per launch, 2 launches


class BscLaunch(NamedTuple):
    """One kernel launch. `axis` says what a block covers: "slices", block x
    takes (batch, head) slices [x * per_block, (x + 1) * per_block) of the
    B*H axis (slice = batch * heads + head), each whole; "queries" or
    "keys", block (x, head, batch) takes rows [x * per_block, (x + 1) *
    per_block) of that axis."""
    axis: str
    per_block: int
    grid: Tuple[int, int, int]
    threads: int
    smem: int


class BscPlan(NamedTuple):
    """variant: one of VARIANTS; slices_per_block: (batch, head) slices a
    block takes (packed), or warps of 16 query rows (row, wide), or 4
    (stream); tile: a slice's padded length (packed), the keys a logit strip
    holds (row), KEY_TILE (stream) or WIDE_KEYS (wide); launches: one, or two
    for K2's dq and dk/dv launches (wide: the dk/dv kernel runs twice on the
    second's geometry)."""
    variant: str
    slices_per_block: int
    tile: int
    launches: Tuple[BscLaunch, ...]

    def as_ints(self):
        vals = [VARIANTS.index(self.variant), self.slices_per_block, self.tile]
        for ln in self.launches:
            vals += [*ln.grid, ln.threads, ln.smem]
        vals += [0] * (_PLAN_INTS - len(vals))
        return (ctypes.c_int * _PLAN_INTS)(*vals)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_bytes(item: int, d: int) -> int:
    """Bytes of one staged shared row: d elements and 16 bytes of padding."""
    return d * item + 16


def _packed_warp_bytes(item: int, d: int, ns: int, backward: bool) -> int:
    """Per warp: the slice's q, k, v (and g) tiles of ns rows, and the fp32
    (ns, ns + 4) probability (and ds) tile."""
    tiles, scratch = (4, 2) if backward else (3, 1)
    return tiles * ns * _row_bytes(item, d) + scratch * ns * (ns + 4) * 4


def _row_bytes_total(item: int, d: int, warps: int, keys: int, backward: bool) -> int:
    """The row variant's block: 16 query rows a warp of q (and g), a ring of
    64-key stages (K1: FWD_STAGES of one tile; K2: DQ_STAGES of k and v), and
    a logit strip (and a dp strip) of `keys` fp32 values per row. In bf16 up
    to REG_MAX_KEYS keys and head dim 64 the logits stay in registers: K1
    keeps no strip, K2 only the dp strip and a ring of DQ_REG_STAGES single
    tiles."""
    rows = 16 * warps * _row_bytes(item, d) * (2 if backward else 1)
    regs = item == 2 and d <= 64 and keys <= REG_MAX_KEYS
    if backward:
        ring = (DQ_REG_STAGES if regs else 2 * DQ_STAGES) * KEY_TILE * _row_bytes(item, d)
        nstrips = 1 if regs else 2
    else:
        ring = FWD_STAGES * KEY_TILE * _row_bytes(item, d)
        nstrips = 0 if regs else 1
    strip_ld = keys if item == 2 else keys + 8  # bf16: fragment order; fp32: padded rows
    return rows + ring + nstrips * warps * 16 * strip_ld * 4


def _stream_fwd_bytes(item: int, d: int) -> int:
    pad = 1 if item == 4 else 8
    lds = max(d, KEY_TILE) + 4
    return 4 * KEY_TILE * lds + item * (3 * KEY_TILE * (d + pad) + KEY_TILE * (KEY_TILE + pad))


def _stream_dq_bytes(item: int, d: int) -> int:
    f32 = item == 4
    ld = d + (1 if f32 else 8)
    lds = (KEY_TILE if f32 else max(d, KEY_TILE)) + 4
    ldp = lds if f32 else KEY_TILE + 8
    ds_bytes = 0 if f32 else item * KEY_TILE * ldp
    return 4 * item * KEY_TILE * ld + 2 * 4 * KEY_TILE * lds + ds_bytes


def _dkv_bytes(item: int, d: int) -> int:
    """K2's dk/dv launch: k, v and two buffers each of q and g, 64 rows each;
    fp32 adds a (64, 68) probability tile."""
    return 6 * KEY_TILE * _row_bytes(item, d) + (KEY_TILE * 68 * 4 if item == 4 else 0)


def _wide_fwd_bytes(item: int, warps: int) -> int:
    """K1's wide block: its query rows, a ring of 32-key tiles and, in fp32,
    a (16, WIDE_LDP) p tile a warp."""
    staging = warps * 16 * WIDE_LDP * 4 if item == 4 else 0
    return (16 * warps + WIDE_FWD_STAGES[item] * WIDE_KEYS) * _row_bytes(item, 256) + staging


def _wide_dq_bytes(item: int, warps: int) -> int:
    """K2's wide dq block: q and g rows, a ring of (k, v) tile pairs and, in
    fp32, a ds tile a warp."""
    staging = warps * 16 * WIDE_LDP * 4 if item == 4 else 0
    return ((2 * 16 * warps + 2 * WIDE_PAIR_STAGES * WIDE_KEYS) * _row_bytes(item, 256)
            + staging)


def _wide_dkv_bytes(item: int, warps: int) -> int:
    """K2's wide dk/dv block: k and v rows, a ring of (q, g) tile pairs with
    their rows' statistics, and in fp32 a p or ds tile a warp."""
    return _wide_dq_bytes(item, warps) + WIDE_PAIR_STAGES * 4 * WIDE_KEYS * 4


def _wide_warps(rows: int, heads: int, b: int, nbytes) -> int:
    """Warps of 16 rows a wide block takes: the most of 4, 2 and 1 whose
    shared memory fits, that leaves no more than half the block's rows past
    `rows` and whose grid has a block for every SM; else 1."""
    for warps in (4, 2):
        if (nbytes(warps) <= SMEM_LIMIT and 16 * warps // 2 < rows
                and _cdiv(rows, 16 * warps) * heads * b >= SMS):
            return warps
    return 1


def _wide_plan(b: int, sq: int, sk: int, heads: int, item: int, backward: bool) -> BscPlan:
    if backward:
        w = _wide_warps(sq, heads, b, lambda n: _wide_dq_bytes(item, n))
        wk = _wide_warps(sk, heads, b, lambda n: _wide_dkv_bytes(item, n))
        launches = (BscLaunch("queries", 16 * w, (_cdiv(sq, 16 * w), heads, b), 32 * w,
                              _wide_dq_bytes(item, w)),
                    BscLaunch("keys", 16 * wk, (_cdiv(sk, 16 * wk), heads, b), 32 * wk,
                              _wide_dkv_bytes(item, wk)))
    else:
        w = _wide_warps(sq, heads, b, lambda n: _wide_fwd_bytes(item, n))
        launches = (BscLaunch("queries", 16 * w, (_cdiv(sq, 16 * w), heads, b), 32 * w,
                              _wide_fwd_bytes(item, w)),)
    return BscPlan("wide", w, WIDE_KEYS, launches)


def _packed_slices_per_block(n: int) -> int:
    """Slices a block takes: the choice of 4, 2 or 1 that puts the fewest
    warps on the fullest SM, the larger on a tie."""
    return min((4, 2, 1), key=lambda spb: _cdiv(_cdiv(n, spb), SMS) * spb)


def bsc_plan(b: int, sq: int, sk: int, heads: int, d: int, dtype: torch.dtype,
             backward: bool = False, max_row_keys: int = ROW_MAX_KEYS) -> BscPlan:
    """The variant, slices per block, grid and shared memory of K1 (or K2,
    `backward`) on q (b, sq, heads * d) against k, v (b, sk, heads * d).
    K7 plans with heads = 1 over its merged B*H axis. `max_row_keys` is the
    threshold; other values serve only to time the variants against each
    other."""
    if d not in BSC_HEAD_DIMS or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bsc_plan: head dim {d} or dtype {dtype} not supported")
    if min(b, sq, sk, heads) <= 0:
        raise ValueError(f"bsc_plan: empty shape b={b} sq={sq} sk={sk} heads={heads}")
    item = 4 if dtype == torch.float32 else 2
    if d == WIDE_HEAD_DIM:
        return _wide_plan(b, sq, sk, heads, item, backward)
    n = b * heads
    ns = 16 if max(sq, sk) <= 16 else 32 if max(sq, sk) <= 32 and d <= 64 else 0
    if ns:
        spb = _packed_slices_per_block(n)
        smem = spb * _packed_warp_bytes(item, d, ns, backward)
        launch = BscLaunch("slices", spb, (_cdiv(n, spb), 1, 1), 32 * spb, smem)
        return BscPlan("packed", spb, ns, (launch,))
    dkv = BscLaunch("keys", KEY_TILE, (_cdiv(sk, KEY_TILE), heads, b), 128,
                    _dkv_bytes(item, d))
    if sk <= max_row_keys:
        keys = _cdiv(sk, KEY_TILE) * KEY_TILE
        for warps in (4, 2, 1):
            smem = _row_bytes_total(item, d, warps, keys, backward)
            if smem <= SMEM_LIMIT and (warps == 1 or 16 * warps // 2 < sq):
                rows = BscLaunch("queries", 16 * warps, (_cdiv(sq, 16 * warps), heads, b),
                                 32 * warps, smem)
                return BscPlan("row", warps, keys, (rows, dkv) if backward else (rows,))
    smem = _stream_dq_bytes(item, d) if backward else _stream_fwd_bytes(item, d)
    rows = BscLaunch("queries", KEY_TILE, (_cdiv(sq, KEY_TILE), heads, b), 128, smem)
    return BscPlan("stream", 4, KEY_TILE, (rows, dkv) if backward else (rows,))


def _heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = t.shape
    return t.reshape(b, s, heads, c // heads)


def short_attention_bsc_plain(q, k, v, heads: int, scale: float) -> torch.Tensor:
    from xdiffusion_tpu_torch.ops.attention import attention_bshd

    out = attention_bshd(_heads_view(q, heads), _heads_view(k, heads),
                         _heads_view(v, heads), scale=scale)
    return out.reshape(q.shape)


def short_attention_bsc_bwd_plain(q, k, v, g, heads: int, scale: float):
    """(dq, dk, dv) of `short_attention_bsc` for the output cotangent g
    (B, Sq, C), as the TPU kernel computes them (flash_attention.py:366-399):

        p  = softmax(q k^T * scale) rounded to v's dtype
        dv = p^T g;   dp = g v^T (fp32)
        ds = p (dp - rowsum(dp * p)) * scale, rounded to q's dtype
        dq = ds k;    dk = ds^T q

    Every product accumulates in fp32 and rounds once to its output's dtype."""
    qh, kh, vh, gh = (_heads_view(t, heads).float() for t in (q, k, v, g))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    pf = p.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pf, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    ds = pf * (dp - (dp * pf).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def _check(name: str, heads: int, q: torch.Tensor, *others: torch.Tensor) -> int:
    """Validates CUDA operands the kernels read in place; returns the dtype
    code. Each needs a unit stride on C and rows on 16-byte boundaries."""
    require_cuda(name, q, *others)
    code = dtype_code(name, q)
    if any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name}: q, k, v (and g) must share a dtype")
    b, _, c = q.shape
    if c % heads != 0 or c // heads not in BSC_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {c // heads} ({c}/{heads}) not in {BSC_HEAD_DIMS}")
    item = q.element_size()
    for t in (q,) + others:
        if t.ndim != 3 or t.shape[0] != b or t.shape[2] != c:
            raise ValueError(f"{name}: shape {tuple(t.shape)} against q {tuple(q.shape)}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}: operands need unit stride on C")
        if t.data_ptr() % 16 or (t.stride(0) * item) % 16 or (t.stride(1) * item) % 16:
            raise ValueError(f"{name}: operand rows must be 16-byte aligned")
    return code


def _strides(*tensors: torch.Tensor):
    vals = [s for t in tensors for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


@functools.lru_cache(maxsize=256)
def _cached_plan(b: int, sq: int, sk: int, heads: int, d: int, dtype: torch.dtype,
                 backward: bool):
    """`bsc_plan` and its ints, once per shape: the wrappers run on the
    host-bound paths, where each call's microseconds count."""
    plan = bsc_plan(b, sq, sk, heads, d, dtype, backward=backward)
    return plan, plan.as_ints()


def _forward(q, k, v, heads: int, scale: float, plan: Optional[BscPlan] = None) -> torch.Tensor:
    """K1 on CUDA tensors (on `bsc_plan`'s plan unless `plan` is given), the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return short_attention_bsc_plain(q, k, v, heads, scale)
    code = _check("short_attention_bsc", heads, q, k, v)
    if k.shape != v.shape:
        raise ValueError(f"short_attention_bsc: k {tuple(k.shape)} and v {tuple(v.shape)}")
    b, sq, c = q.shape
    sk = k.shape[1]
    plan, ints = ((plan, plan.as_ints()) if plan else
                  _cached_plan(b, sq, sk, heads, c // heads, q.dtype, False))
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, sk, heads, c // heads, _strides(q, k, v, out),
                  float(scale), code, ints)
    return out


def short_attention_bsc_bwd(q, k, v, g, heads: int, scale: float, plan: Optional[BscPlan] = None):
    """(dq, dk, dv): K2 on CUDA tensors (on `bsc_plan`'s plan unless `plan`
    is given), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return short_attention_bsc_bwd_plain(q, k, v, g, heads, scale)
    code = _check("short_attention_bsc_bwd", heads, q, k, v, g)
    if k.shape != v.shape or g.shape != q.shape:
        raise ValueError("short_attention_bsc_bwd: k/v or g shape mismatch")
    b, sq, c = q.shape
    sk = k.shape[1]
    plan, ints = ((plan, plan.as_ints()) if plan else
                  _cached_plan(b, sq, sk, heads, c // heads, q.dtype, True))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Per-row softmax statistics (max, sum, rowsum(dp * p), 1 / sum) that the
    # dq launch hands to the dk/dv launch; the packed variant needs none.
    stats = (None if plan.variant == "packed" else
             torch.empty((4, b, heads, sq), dtype=torch.float32, device=q.device))
    BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      None if stats is None else stats.data_ptr(),
                      b, sq, sk, heads, c // heads, _strides(q, k, v, g, dq, dk, dv),
                      float(scale), code, ints)
    return dq, dk, dv


class _ShortAttentionBSC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return _forward(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = short_attention_bsc_bwd(q, k, v, g.contiguous(), ctx.heads,
                                             ctx.scale)
        return dq, dk, dv, None, None


def short_attention_bsc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, scale: float) -> torch.Tensor:
    """q: (B, Sq, C); k/v: (B, Sk, C), C = heads * head_dim. Returns (B, Sq, C),
    differentiable in q, k and v.

    q, k and v may be column slices of one qkv projection: each needs a unit
    stride on its last axis and rows that start on 16-byte boundaries."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"short_attention_bsc: shapes {tuple(q.shape)}, {tuple(k.shape)}")
    return _ShortAttentionBSC.apply(q, k, v, heads, scale)


# ---- K5 and K6: streamed attention on (B, H, S, D), forward and backward ---
#
# The launch plan. Four variants, chosen by dtype and head dim
# (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu):
# - "tf32": fp32, D 64 or 128. Split TF32 (three TF32 products a product)
#   on mma.sync, 4 warps of 16 rows: 64 keys a dk/dv block; 64 query rows a
#   forward or dq block or, at D 64 where the grid stays large (16,384
#   tokens), 128 (two row tiles a warp: `_query_rows`); streamed tiles
#   double buffered by cp.async, of 64 rows (K5) or 32 (K6).
# - "wgmma": bf16, D 64. Consumer warpgroups of 64 rows and a producer warp
#   streaming by TMA: K5 has three (192 query rows a block) and streams
#   128-key tiles (WG_FWD_STAGES in its ring); K6's dq launch has three (192
#   query rows a block) and its dk/dv launch two (128 keys), streaming
#   64-row tiles (WG_BWD_STAGES). One block an SM.
# - "mma": bf16, D 128: 4 warps of 16 rows on mma.sync m16n8k16, 64 query
#   rows or keys a block, 64-row streamed tiles.
# - "wide": fp32 (split TF32) or bf16 (mma.sync), D 256 or 576: 16 query
#   rows or keys a block, its D / 64 warps (4 or 9) each owning 64 columns
#   of D (a 16 x 256 fp32 accumulator would take 128 registers a lane, and
#   64-row fp32 tiles no longer fit); the products over D are D / 64
#   partials exchanged through shared memory and summed in warp order;
#   streamed tiles double buffered, of 32 rows at D 256 and of 16 at D 576
#   (32-row fp32 tiles of 576 columns would not fit), where K6 also
#   exchanges S and dP in turn through one slot.
# K6's dk/dv launch walks the 64-row query tiles. Where its key blocks alone
# number fewer than the blocks the card holds at once (RESIDENT an SM: two
# for tf32 and mma, one for wgmma and wide; e.g. at 128 caption keys), the walk is
# cut into `splits` contiguous ranges of `tiles_per_split` tiles, whose fp32
# partials of dk and dv a third launch sums in split order. The CUDA side
# launches exactly the plan's geometry and refuses a plan that is not its
# variant's or does not cover the shape.

FLASH_VARIANTS = ("tf32", "mma", "wgmma", "wide")
FLASH_TILE = 64          # rows of a streamed tile; of a tf32 / mma block
WG_GROUPS = {"fwd": 3, "dq": 3, "dkv": 2}  # consumer warpgroups of a wgmma block
WG_FWD_KEYS = 128        # keys of K5's wgmma tile
WG_FWD_STAGES = 3        # K5's wgmma ring: (K, V) tile pairs
WG_BWD_STAGES = 4        # K6's wgmma ring: 64-row tile pairs
RESIDENT = {"tf32": 2, "mma": 2, "wgmma": 1, "wide": 1}  # K6's blocks an SM, for the split
FLASH_WIDE_ROWS = 16     # "wide": query rows (dk/dv: keys) a block
FLASH_WIDE_TILE = {256: 32, 576: 16}  # "wide": rows of a streamed tile, by head dim
FLASH_WIDE_SLOTS = {256: 2, 576: 1}   # "wide": K6's exchange slots, by head dim


class FlashLaunch(NamedTuple):
    """One launch: block (x, head, z) takes rows [x * rows, (x + 1) * rows)
    of `axis` ("queries" or "keys") of batch z (the dk/dv launch: batch
    z // splits, split z % splits)."""
    axis: str
    rows: int
    grid: Tuple[int, int, int]
    threads: int
    smem: int


class FlashPlan(NamedTuple):
    """variant: one of FLASH_VARIANTS; launches: K5's one, or K6's dq and
    dk/dv launches (a split sum follows where splits > 1); splits and
    tiles_per_split: the dk/dv launch's query walk, `splits` ranges of
    `tiles_per_split` 64-row tiles (the last one shorter)."""
    variant: str
    launches: Tuple[FlashLaunch, ...]
    splits: int = 1
    tiles_per_split: int = 0

    def as_ints(self):
        v = FLASH_VARIANTS.index(self.variant)
        first = self.launches[0]
        if len(self.launches) == 1:
            vals = [v, first.rows, *first.grid, first.threads, first.smem]
        else:
            dkv = self.launches[1]
            vals = [v, first.rows, first.grid[0], first.threads, first.smem, dkv.rows,
                    dkv.grid[0], dkv.threads, dkv.smem, self.splits, self.tiles_per_split]
        return (ctypes.c_int * len(vals))(*vals)


def _wg_launch(axis: str, n: int, heads: int, z: int, launch: str) -> FlashLaunch:
    """A wgmma launch over n rows of `axis`: its warpgroups' rows a block,
    a producer warp beside them, and its shared memory (1024 bytes of
    alignment slack, 128-byte swizzled rows): K5 its Q tile and the ring;
    K6 two fixed tiles, the ring and its rows of lse and delta, delta, the
    barriers."""
    groups = WG_GROUPS[launch]
    rows = 64 * groups
    if launch == "fwd":
        smem = 1024 + rows * 128 + 2 * WG_FWD_STAGES * WG_FWD_KEYS * 128 + 64
    else:
        smem = (1024 + 2 * rows * 128 + 2 * WG_BWD_STAGES * FLASH_TILE * 128 + 4 * rows
                + WG_BWD_STAGES * 2 * FLASH_TILE * 4 + 128)
    return FlashLaunch(axis, rows, (_cdiv(n, rows), heads, z), 128 * groups + 32, smem)


def _query_rows(item: int, d: int, blocks_wide: int, sms: int) -> int:
    """Query rows of a tf32 or mma forward or dq block, 16 a row tile of a
    warp: two row tiles a warp (128 rows; each K and V fragment split once
    for both) in fp32 at D 64 where the `blocks_wide` blocks of 128 rows
    still make RESIDENT blocks an SM, else one."""
    wide = item == 4 and d == 64 and blocks_wide >= RESIDENT["tf32"] * sms
    return 2 * FLASH_TILE if wide else FLASH_TILE


def _flash_smem(item: int, d: int, launch: str, rows: int = FLASH_TILE,
                streamed: int = 0) -> int:
    """Dynamic shared memory of a tf32 or mma block, as the kernels lay it
    out: padded rows of d elements; K5 its 64-row Q and double-buffered K
    and V; K6 two fixed tiles of the block's `rows` and two double-buffered
    streamed ones (of 32 rows in fp32, or of `streamed` rows when given)."""
    pad = 4 if item == 4 else 8  # elements of row padding
    streamed = streamed or (64 if launch == "fwd" or item == 2 else 32)
    fixed = rows if launch == "fwd" else 2 * rows
    return (fixed + 4 * streamed) * (d + pad) * item


def _flash_wide_smem(item: int, d: int, backward: bool) -> int:
    """Dynamic shared memory of a "wide" block at head dim d: `_flash_smem`'s
    layout with its rows and streamed tiles, and the fp32 exchange slots
    (K5: one; K6: FLASH_WIDE_SLOTS) of d / 64 partials of 16 x tile."""
    tile = FLASH_WIDE_TILE[d]
    tiles = _flash_smem(item, d, "dq" if backward else "fwd", FLASH_WIDE_ROWS, tile)
    slots = FLASH_WIDE_SLOTS[d] if backward else 1
    return tiles + slots * (d // 64) * FLASH_WIDE_ROWS * tile * 4


def _walk_splits(blocks: int, qtiles: int, target: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the dk/dv launch's query walk: one
    split where its `blocks` reach `target`, else contiguous ranges of
    equal length (the last one shorter, none empty), enough of them for
    that many blocks or one tile each."""
    if blocks >= target:
        return 1, qtiles
    tps = max(1, qtiles // _cdiv(target, blocks))
    return _cdiv(qtiles, tps), tps


def flash_plan(b: int, heads: int, sq: int, sk: int, d: int, dtype: torch.dtype,
               sms: int = SMS, backward: bool = False) -> FlashPlan:
    """The variant and launches of K5 (or K6, `backward`) on q (b, heads,
    sq, d) against k, v (b, heads, sk, d), on a card of `sms` SMs."""
    if d not in FLASH_HEAD_DIMS or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_plan: head dim {d} or dtype {dtype} not supported")
    if min(b, heads, sq, sk) <= 0:
        raise ValueError(f"flash_plan: empty shape b={b} heads={heads} sq={sq} sk={sk}")
    item = 4 if dtype == torch.float32 else 2
    if d in FLASH_WIDE_TILE:
        rows, smem, threads = FLASH_WIDE_ROWS, _flash_wide_smem(item, d, backward), 32 * (d // 64)
        first = FlashLaunch("queries", rows, (_cdiv(sq, rows), heads, b), threads, smem)
        if not backward:
            return FlashPlan("wide", (first,))
        splits, tps = _walk_splits(_cdiv(sk, rows) * heads * b, _cdiv(sq, FLASH_TILE),
                                   RESIDENT["wide"] * sms)
        dkv = FlashLaunch("keys", rows, (_cdiv(sk, rows), heads, b * splits), threads, smem)
        return FlashPlan("wide", (first, dkv), splits, tps)
    variant = "tf32" if item == 4 else "wgmma" if d == 64 else "mma"
    if variant == "wgmma":
        first = _wg_launch("queries", sq, heads, b, "dq" if backward else "fwd")
        keys = 64 * WG_GROUPS["dkv"]
    else:
        rows = _query_rows(item, d, _cdiv(sq, 2 * FLASH_TILE) * heads * b, sms)
        first = FlashLaunch("queries", rows, (_cdiv(sq, rows), heads, b), 128,
                            _flash_smem(item, d, "dq" if backward else "fwd", rows))
        keys = FLASH_TILE
    if not backward:
        return FlashPlan(variant, (first,))
    splits, tps = _walk_splits(_cdiv(sk, keys) * heads * b, _cdiv(sq, FLASH_TILE),
                               RESIDENT[variant] * sms)
    dkv = (_wg_launch("keys", sk, heads, b * splits, "dkv") if variant == "wgmma" else
           FlashLaunch("keys", keys, (_cdiv(sk, keys), heads, b * splits), 128,
                       _flash_smem(item, d, "dkv")))
    return FlashPlan(variant, (first, dkv), splits, tps)


@functools.lru_cache(maxsize=256)
def _cached_flash_plan(b: int, heads: int, sq: int, sk: int, d: int, dtype: torch.dtype,
                       backward: bool):
    """`flash_plan` and its ints, once per shape (the LTX paths call K5 and
    K6 24 times a forward or step, host-bound)."""
    plan = flash_plan(b, heads, sq, sk, d, dtype, backward=backward)
    return plan, plan.as_ints()


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t widened to the plain versions' accumulation type: fp32, or fp64
    for fp64 inputs (which only gradient checks pass)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def flash_attention_plain(q, k, v, scale: float):
    """(o, lse) of non-causal attention over (B, H, S, D) tensors, as the
    JAX package's reference `_xla_attention` computes o: fp32 logits and
    softmax, the normalised weights rounded to v's dtype before the PV
    product, which accumulates in fp32. lse (B, H, Sq, 1) is fp32."""
    logits = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * scale
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", _acc(weights), _acc(v)).to(v.dtype)
    return out, lse


def flash_attention_bwd_plain(q, k, v, o, lse, g, scale: float):
    """(dq, dk, dv) of `flash_attention` for the output cotangent g, from the
    forward's output o and logsumexp lse, as the TPU kernels compute them
    (flash_attention.py:445-541, delta :552):

        delta = rowsum(g * o) in fp32
        p  = exp(q k^T * scale - lse)        (fp32, from the saved lse)
        dp = g v^T;  ds = p (dp - delta) * scale, rounded to q's dtype
        dq = ds k;   dk = ds^T q;   dv = p^T g with p rounded to g's dtype

    Every product accumulates in fp32 and rounds once to its output's
    dtype (q's, k's, v's)."""
    qf, kf, vf, gf = _acc(q), _acc(k), _acc(v), _acc(g)
    delta = (gf * _acc(o)).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale - lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = _acc((p * (dp - delta) * scale).to(q.dtype))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", _acc(p.to(g.dtype)), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride on D and every (batch, head, row) start on 16 bytes."""
    sb, sh, ss, sd = t.stride()
    return (sd == 1 and t.data_ptr() % 16 == 0
            and (sb | sh | ss) * t.element_size() % 16 == 0)


def _flash_check(name: str, *tensors: torch.Tensor) -> int:
    """Validates CUDA operands K5 or K6 reads through strides; returns the
    dtype code."""
    require_cuda(name, *tensors)
    code = dtype_code(name, tensors[0])
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"{name}: the operands must share a dtype")
    d = tensors[0].shape[-1]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {FLASH_HEAD_DIMS}")
    for t in tensors:
        if not _rows_aligned(t):
            raise ValueError(f"{name}: operands need unit stride on D and 16-byte "
                             f"aligned rows")
    return code


def _strides3(*tensors: torch.Tensor):
    """The (batch, head, row) strides of each tensor as one C array; the
    arrays are kept per stride pattern (the LTX paths repeat a few)."""
    return _stride_array(tuple(s for t in tensors for s in t.stride()[:3]))


@functools.lru_cache(maxsize=256)
def _stride_array(vals: Tuple[int, ...]):
    return (ctypes.c_longlong * len(vals))(*vals)


def _heads_major(b: int, s: int, h: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) view of (B, S, H, D) storage: a caller that
    moves the heads back next to D gets a contiguous tensor for free."""
    return torch.empty((b, s, h, d), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def _flash_forward(q, k, v, scale: float):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    code = _flash_check("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _, ints = _cached_flash_plan(b, h, sq, sk, d, q.dtype, False)
    out = _heads_major(b, sq, h, d, q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    FLASH_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), b, h, sq, sk, d, _strides3(q, k, v, out),
                        float(scale), code, ints)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, g, scale: float):
    """(dq, dk, dv) of `flash_attention` for the cotangent g of its output o:
    K6 on CUDA tensors, the plain version on CPU tensors.

    q, o, g: (B, H, Sq, D); k, v: (B, H, Sk, D); lse: the forward's fp32
    (B, H, Sq, 1). On CUDA, q, k, v, o and g share a dtype, D is 64, 128, 256 or 576,
    each needs a unit stride on D and 16-byte aligned rows, and lse is
    contiguous; any Sq and Sk. dq, dk and dv come back as (B, H, S, D) views
    of (B, S, H, D) storage. Causal attention never reaches it:
    `dot_product_attention` refuses it on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, g, scale)
    code = _flash_check("flash_attention_bwd", q, k, v, o, g)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if o.shape != q.shape or g.shape != q.shape or v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, g {tuple(g.shape)} "
                         f"against q {tuple(q.shape)}; v {tuple(v.shape)}, k {tuple(k.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq, 1) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be K5's contiguous fp32 (B, H, Sq, 1)")
    plan, ints = _cached_flash_plan(b, h, sq, sk, d, q.dtype, True)
    dq = _heads_major(b, sq, h, d, q)
    dk, dv = _heads_major(b, sk, h, d, k), _heads_major(b, sk, h, d, v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)  # rowsum(g * o)
    # fp32 partials of dk and dv, one per split of the query walk.
    part = (torch.empty((2 * plan.splits * b * h * sk * d,), dtype=torch.float32,
                        device=q.device) if plan.splits > 1 else None)
    FLASH_BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(),
                            None if part is None else part.data_ptr(), b, h, sq, sk, d,
                            _strides3(q, k, v, o, g, dq, dk, dv), float(scale), code, ints)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = _flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.scale = scale
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g.device.type != "cpu" and not _rows_aligned(g):
            g = g.contiguous()  # e.g. the expanded cotangent of a sum
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """q: (B, H, Sq, D); k/v: (B, H, Sk, D). Returns (o, lse): o (B, H, Sq, D)
    in q's dtype, differentiable in q, k and v, and the fp32 logsumexp of
    each row's scaled logits, (B, H, Sq, 1).

    On CUDA, D must be 64, 128, 256 or 576 and each operand needs a unit stride on D
    and 16-byte aligned rows; any Sq and Sk."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k {tuple(k.shape)}")
    return _FlashAttention.apply(q, k, v, scale)


# ---- K7: attention on head-major (B, H, S, D) ------------------------------


def short_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Non-causal attention over (B, H, S, D) tensors as the JAX package's
    reference `ref` of `_short_bwd` computes it: fp32 logits and softmax, the
    weights rounded to v's dtype, the PV product accumulated in fp32 and
    returned in v's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", _acc(weights), _acc(v)).to(v.dtype)


def _merged_strides(name: str, t: torch.Tensor):
    """(slice stride, row stride) of t (B, H, S, D) seen as (B*H, S, D)."""
    b, h = t.shape[:2]
    if h == 1 or b == 1 or t.stride(0) == h * t.stride(1):
        return (t.stride(0) if h == 1 else t.stride(1)), t.stride(2)
    raise ValueError(f"{name}: the batch and head axes of a {tuple(t.shape)} operand with "
                     f"strides {t.stride()} do not merge into one")


def _short_forward(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, scale)
    name = "short_attention"
    require_cuda(name, q, k, v)
    code = dtype_code(name, q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{name}: {b * h} (batch, head) slices exceed the grid's 65535")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = []
    for t in (q, k, v, out):
        if not _rows_aligned(t):
            raise ValueError(f"{name}: operands need unit stride on D and 16-byte aligned rows")
        strides.extend(_merged_strides(name, t))
    _, ints = _cached_plan(b * h, sq, k.shape[2], 1, d, q.dtype, False)
    SHORT_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq,
                        k.shape[2], d, (ctypes.c_longlong * 8)(*strides), float(scale), code,
                        ints)
    return out


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _short_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        scale = ctx.scale
        dq, dk, dv = plain_vjp(lambda q, k, v: short_attention_plain(q, k, v, scale),
                               ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return dq, dk, dv, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, H, Sk, D). Returns (B, H, Sq, D) in q's
    dtype, differentiable in q, k and v.

    On CUDA the forward launches K7: q, k and v share a dtype (fp32 or
    bf16), D is one of HEAD_DIMS, each operand has a unit stride on D,
    16-byte aligned rows and batch and head axes that merge into one; any
    Sq and Sk. The backward is autograd of `short_attention_plain` on the
    saved inputs, the vjp the JAX package takes (`_short_bwd`); it does not
    go through K2, which transcribes the roundings of the TPU backward
    kernel of `short_attention_bsc`, not that vjp."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"short_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"short_attention: q {tuple(q.shape)} against k {tuple(k.shape)}")
    return _ShortAttention.apply(q, k, v, scale)
