"""S4D, the diagonal state-space sequence layer, and DiffuSSM's residual block.

Counterpart of `S4D` and `SequenceResidualBlock` in
xdiffusion_tpu/layers/s4d.py ("On the Parameterization and Initialization
of Diagonal State Space Models", S4D-Lin). The layer materialises its
length-L convolution kernel from the diagonal recurrence,

    K_l = 2 Re( sum_n C_n (e^{dt A_n})^l (e^{dt A_n} - 1) / A_n ),

with a complex64 Vandermonde product, runs the causal convolution as an
rfft/irfft at length 2L (plain `torch.fft`: the JAX package computes both
with XLA, outside any Pallas kernel, so no kernel of the port takes them),
adds the D skip, and ends with GELU (tanh) -> out_proj (h -> 2h) -> GLU.

Parameters carry the JAX package's layout, so they map 1:1: `C` is the
(H, N/2, 2) real view of the complex C, `log_dt` (H,), `log_A_real` and
`A_imag` (H, N/2), `D` (H,). The JAX layer's dropout (0 in every config:
`SequenceResidualBlock` never sets it) is left out.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm


def s4d_kernel(c: torch.Tensor, log_dt: torch.Tensor, log_a_real: torch.Tensor,
               a_imag: torch.Tensor, length: int) -> torch.Tensor:
    """The (H, length) fp32 convolution kernel of the diagonal SSM."""
    dt = torch.exp(log_dt)[:, None]
    a = torch.complex(-torch.exp(log_a_real), a_imag)
    dt_a = a * dt
    c_disc = torch.complex(c[..., 0], c[..., 1]) * (torch.exp(dt_a) - 1.0) / a
    positions = torch.arange(length, device=c.device, dtype=torch.float32)
    vander = torch.exp(dt_a[..., None] * positions)  # (H, N, L)
    return 2.0 * torch.einsum("hn,hnl->hl", c_disc, vander).real


def causal_convolution(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x (B, H, L) convolved causally with kernel (H, L), by FFT at 2L."""
    length = x.shape[-1]
    n = 2 * length
    y = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(kernel, n=n)[None], n=n)
    return y[..., :length]


class S4D(nn.Module):
    """Diagonal SSM over (B, L, H) sequences; the parameters are drawn as the
    JAX package initialises them (S4D-Lin)."""

    def __init__(self, d_model: int, d_state: int = 64, dt_min: float = 1e-3,
                 dt_max: float = 1e-1):
        super().__init__()
        h, n = d_model, d_state // 2
        self.log_dt = nn.Parameter(torch.rand(h) * (math.log(dt_max) - math.log(dt_min))
                                   + math.log(dt_min))
        self.log_A_real = nn.Parameter(torch.log(0.5 * torch.ones(h, n)))
        self.A_imag = nn.Parameter(math.pi * torch.arange(n, dtype=torch.float32).expand(h, n)
                                   .clone())
        self.C = nn.Parameter(torch.randn(h, n, 2) * 0.5 ** 0.5)
        self.D = nn.Parameter(torch.randn(h))
        self.out_proj = Dense(h, 2 * h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        length = x.shape[1]
        kernel = s4d_kernel(self.C, self.log_dt, self.log_A_real, self.A_imag, length)
        x_t = x.transpose(1, 2)  # (B, H, L)
        y = causal_convolution(x_t, kernel) + x_t * self.D[None, :, None]
        y = self.out_proj(F.gelu(y, approximate="tanh").transpose(1, 2))
        a, g = y.chunk(2, dim=-1)
        return a * torch.sigmoid(g)


class SequenceResidualBlock(nn.Module):
    """The residual block as DiffuSSM configures it: a LayerNorm before (or,
    with prenorm off, after) the SSM; bidirectional, a second S4D on the SAME
    input (the reference never flips it) and a Linear(2h -> h) fusing the
    two; no inner residual. Returns (y, None)."""

    def __init__(self, d_input: int, bidirectional: bool = True, prenorm: bool = True,
                 d_state: int = 64):
        super().__init__()
        self.prenorm = prenorm
        self.norm = LayerNorm(d_input)
        self.layer = S4D(d_input, d_state)
        self.reverse_layer = S4D(d_input, d_state) if bidirectional else None
        self.bidirectional_linear = Dense(2 * d_input, d_input) if bidirectional else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        y = self.norm(x) if self.prenorm else x
        out = self.layer(y)
        if self.reverse_layer is not None:
            out = self.bidirectional_linear(torch.cat([out, self.reverse_layer(y)], dim=-1))
        if not self.prenorm:
            out = self.norm(out)
        return out, None
