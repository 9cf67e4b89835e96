"""Mixture-of-Experts MLP (Switch / GShard routing with dense dispatch).

Counterpart of `compute_capacity`, `top_k_routing` and `MoEMlp` in
xdiffusion_tpu/layers/moe.py: tokens reach their experts through two
einsums against a dense (tokens, experts, capacity) dispatch / combine
tensor; each expert takes at most `compute_capacity` tokens and a token
past it gets nothing from the MLP branch (its residual is untouched). The
router runs in fp32, the experts in the layer's dtype, the combine in fp32.
The expert parameters stay stacked in flax's layout, `experts_fc1` (E, D, H)
and `experts_fc2` (E, H, D) with their biases, so the weight bridge passes
them through unchanged.

Each forward records its Switch load-balance loss, E * sum_e f_e * p_e over
the first choice, in `aux_loss`, where the diffusion process collects it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.resnet import dropout_generator
from xdiffusion_tpu_torch.utils import dropout


def compute_capacity(num_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """Tokens per expert: ceil(T * top_k * capacity_factor / E), within [1, T]."""
    cap = int(math.ceil(num_tokens * top_k * capacity_factor / num_experts))
    return max(1, min(num_tokens, cap))


def top_k_routing(gates: torch.Tensor, capacity: int, top_k: int):
    """(dispatch, combine, aux_loss) of router probabilities `gates` (T, E).

    dispatch (T, E, C) is 0/1, combine (T, E, C) the gate weights, both
    fp32. Choices are made in turn: round k + 1's slots follow the tokens
    that rounds 1..k gave each expert; ties go to the lowest expert index
    (as `jnp.argmax` and `torch.argmax` break them). Tokens past `capacity`
    are dropped. With top_k > 1 the kept gates of a token are renormalised."""
    tokens, num_experts = gates.shape
    dispatch = torch.zeros((tokens, num_experts, capacity), dtype=torch.float32,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    gate_sum = torch.zeros((tokens,), dtype=torch.float32, device=gates.device)
    counts = torch.zeros((num_experts,), dtype=torch.long, device=gates.device)
    remaining = gates
    first_choice = None
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(idx, num_experts)
        if first_choice is None:
            first_choice = onehot
        pos = torch.cumsum(onehot, dim=0) - 1 + counts[None, :]
        pos_tok = (pos * onehot).sum(dim=-1)
        keep = (pos_tok < capacity).float()
        gate_val = torch.gather(remaining, -1, idx[:, None])[:, 0] * keep
        slot = F.one_hot(pos_tok.clamp(0, capacity - 1), capacity).float()
        assignment = onehot.float()[:, :, None] * slot[:, None, :] * keep[:, None, None]
        dispatch = dispatch + assignment
        combine = combine + gate_val[:, None, None] * assignment
        gate_sum = gate_sum + gate_val
        counts = counts + onehot.sum(dim=0)
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
    if top_k > 1:
        combine = combine / (gate_sum[:, None, None] + 1e-9)
    f = first_choice.float().mean(dim=0)
    p = gates.mean(dim=0)
    aux_loss = num_experts * (f * p).sum()
    return dispatch, combine, aux_loss


class MoEMlp(nn.Module):
    """(B, S, D) -> (B, S, D): a drop-in for a transformer's MLP branch. The
    routing capacity is reckoned over the B * S tokens of one call."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.dropout = dropout
        self.compute_dtype = dtype
        self.router = Dense(hidden_size, num_experts, dtype=torch.float32)

        def lecun(*shape):  # variance 1 / fan_in, as flax's lecun_normal
            return nn.Parameter(torch.randn(shape) * shape[-2] ** -0.5)

        self.experts_fc1 = lecun(num_experts, hidden_size, mlp_dim)
        self.experts_fc1_bias = nn.Parameter(torch.zeros(num_experts, mlp_dim))
        self.experts_fc2 = lecun(num_experts, mlp_dim, hidden_size)
        self.experts_fc2_bias = nn.Parameter(torch.zeros(num_experts, hidden_size))
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        batch, seq, dim = x.shape
        tokens = x.reshape(batch * seq, dim)
        gates = torch.softmax(self.router(tokens.float()), dim=-1)
        capacity = compute_capacity(batch * seq, self.num_experts, self.top_k,
                                    self.capacity_factor)
        dispatch, combine, self.aux_loss = top_k_routing(gates, capacity, self.top_k)

        dt = self.compute_dtype
        # The dispatch tensor is 0/1, exact in bf16.
        expert_in = torch.einsum("td,tec->ecd", tokens.to(dt), dispatch.to(dt))
        h = torch.einsum("ecd,edh->ech", expert_in, self.experts_fc1.to(dt))
        h = F.gelu(h + self.experts_fc1_bias.to(dt)[:, None, :], approximate="tanh")
        generator = dropout_generator(self, context)
        if generator is not None:
            h = dropout(h, self.dropout, generator)
        out = torch.einsum("ech,ehd->ecd", h, self.experts_fc2.to(dt))
        out = out + self.experts_fc2_bias.to(dt)[:, None, :]
        y = torch.einsum("ecd,tec->td", out.float(), combine)
        return y.reshape(batch, seq, dim).to(x.dtype)
