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

- the forward launches K5 (`csrc/flash_attention.cu`) on CUDA tensors, which
  returns the output and the logsumexp; on CPU tensors
  `flash_attention_plain` computes both;
- the backward launches K6 (`csrc/flash_attention_bwd.cu`) on CUDA tensors;
  on CPU tensors `flash_attention_bwd_plain` transcribes the TPU backward
  kernels `_flash_dq_kernel` and `_flash_dkv_kernel` with their roundings.

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

import torch

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, plain_vjp, require_cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
KERNEL = Kernel(
    "bsc_attention", "xd_bsc_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _P],
)
BWD_KERNEL = Kernel(
    "bsc_attention_bwd", "xd_bsc_attention_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _P],
)
FLASH_KERNEL = Kernel(
    "flash_attention", "xd_flash_attention",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _P],
)
FLASH_BWD_KERNEL = Kernel(
    "flash_attention_bwd", "xd_flash_attention_bwd",
    [_P] * 10 + [_I, _I, _I, _I, _I, _STRIDES, _F, _I, _P],
)
SHORT_KERNEL = Kernel(
    "short_attention", "xd_short_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _STRIDES, _F, _I, _P],
)
HEAD_DIMS = (16, 32, 64, 128)
FLASH_HEAD_DIMS = (64, 128)


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
    if c % heads != 0 or c // heads not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {c}/{heads} not in {HEAD_DIMS}")
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


def _forward(q, k, v, heads: int, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return short_attention_bsc_plain(q, k, v, heads, scale)
    code = _check("short_attention_bsc", heads, q, k, v)
    if k.shape != v.shape:
        raise ValueError(f"short_attention_bsc: k {tuple(k.shape)} and v {tuple(v.shape)}")
    b, sq, c = q.shape
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, k.shape[1], heads, c // heads, _strides(q, k, v, out),
                  float(scale), code)
    return out


def short_attention_bsc_bwd(q, k, v, g, heads: int, scale: float):
    """(dq, dk, dv): K2 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return short_attention_bsc_bwd_plain(q, k, v, g, heads, scale)
    code = _check("short_attention_bsc_bwd", heads, q, k, v, g)
    if k.shape != v.shape or g.shape != q.shape:
        raise ValueError("short_attention_bsc_bwd: k/v or g shape mismatch")
    b, sq, c = q.shape
    sk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Per-row softmax statistics (max, sum, rowsum(dp * p)) that the dq pass
    # hands to the dk/dv pass.
    stats = torch.empty((3, b, heads, sq), dtype=torch.float32, device=q.device)
    BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                      b, sq, sk, heads, c // heads, _strides(q, k, v, g, dq, dk, dv),
                      float(scale), code)
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
    item = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all((t.stride(i) * item) % 16 == 0 for i in range(3)))


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
    vals = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
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
    out = _heads_major(b, sq, h, d, q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    FLASH_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), b, h, sq, sk, d, _strides3(q, k, v, out),
                        float(scale), code)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, g, scale: float):
    """(dq, dk, dv) of `flash_attention` for the cotangent g of its output o:
    K6 on CUDA tensors, the plain version on CPU tensors.

    q, o, g: (B, H, Sq, D); k, v: (B, H, Sk, D); lse: the forward's fp32
    (B, H, Sq, 1). On CUDA, q, k, v, o and g share a dtype, D is 64 or 128,
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
    dq = _heads_major(b, sq, h, d, q)
    dk, dv = _heads_major(b, sk, h, d, k), _heads_major(b, sk, h, d, v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)  # rowsum(g * o)
    FLASH_BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d,
                            _strides3(q, k, v, o, g, dq, dk, dv), float(scale), code)
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

    On CUDA, D must be 64 or 128 and each operand needs a unit stride on D
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
    SHORT_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq,
                        k.shape[2], d, (ctypes.c_longlong * 8)(*strides), float(scale), code)
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
