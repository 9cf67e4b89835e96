"""Frozen text-encoder towers: the CLIP text transformer and the T5 encoder.

Counterpart of xdiffusion_tpu/layers/text_encoders.py: `CLIPTextConfig`,
`CLIPTextTransformer` (causal pre-LN, the `penultimate` tap, EOS pooling,
the optional `text_projection`), `T5Config`, `T5Encoder` (RMS norms, the
relative-position bias of block 0 shared by every block, no 1/sqrt(d)
scaling), the importers of HF torch state dicts (`import_hf_clip_text`,
`import_hf_t5_encoder`) and the loaders of locally cached checkpoints
(`load_pretrained_clip_text`, `load_pretrained_t5`).

Submodules carry the names of the JAX package's flax parameter paths
(`layers_<i>/self_attn/q_proj`, `block_<i>/attn/relative_attention_bias`,
...), so the weight bridge (weights.py) maps a flax tree onto a tower
mechanically, and an importer is the JAX importer's flax-layout leaves put
through that bridge.

Attention is plain matmul and softmax with fp32 logits, as the JAX package
computes it with einsums outside any Pallas kernel: CLIP's mask is causal
with padding and T5's carries a bias, which neither K1 nor K5 takes. Each
layer computes in the promotion of its input's dtype and the parameters'
(fp32 for an fp32 tower, fp64 for one cast to fp64). "gelu" and "gelu_new"
are both the tanh approximation, as `jax.nn.gelu` is (HF's "gelu" is the
exact erf form; ROADMAP queue 3).

The loaders read local files only: a checkpoint directory given as the
version, or the HuggingFace cache. Where the cache holds nothing for the
version they return None before importing `transformers` (an import that
takes seconds); otherwise they import it inside a `try` and return None on
any failure, as the JAX loaders do. A tower loads on `device`, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm

# =========================================================================
# CLIP text tower (HF CLIPTextModel-compatible)
# =========================================================================


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # set for the WithProjection variants


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new"):
        return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name}")


def _attend(q, k, v, bias, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T (* scale) + bias) v over (B, H, S, D) heads: logits in
    the promotion of q's dtype and fp32, the weights cast to v's dtype."""
    dt = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2))
    if scale is not None:
        logits = logits * scale
    weights = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, n, _ = t.shape
    return t.reshape(b, n, h, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class _CLIPAttention(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        d = c.hidden_size
        self.num_heads = c.num_attention_heads
        self.scale = (d // self.num_heads) ** -0.5
        self.q_proj = Dense(d, d, dtype=None)
        self.k_proj = Dense(d, d, dtype=None)
        self.v_proj = Dense(d, d, dtype=None)
        self.out_proj = Dense(d, d, dtype=None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.num_heads
        out = _attend(_heads(self.q_proj(x), h), _heads(self.k_proj(x), h),
                      _heads(self.v_proj(x), h), mask, self.scale)
        return self.out_proj(_merge(out))


class _CLIPLayer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.self_attn = _CLIPAttention(c)
        self.layer_norm2 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.fc1 = Dense(c.hidden_size, c.intermediate_size, dtype=None)
        self.fc2 = Dense(c.intermediate_size, c.hidden_size, dtype=None)
        self._act = _act(c.hidden_act)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.fc2(self._act(self.fc1(self.layer_norm2(x))))


class CLIPTextTransformer(nn.Module):
    """CLIP text tower over BPE ids (B, N): returns (last_hidden_state,
    pooled), the hidden states after the final LayerNorm (with
    `penultimate`, the input of the last layer, HF's hidden_states[-2],
    before the final LayerNorm: SD3's sequence tap) and the final hidden
    state at the EOS position (the largest id when `eos_token_id` is 2, the
    legacy HF rule; else the first `eos_token_id`), projected by
    `text_projection` when `projection_dim` is set. The attention mask is
    causal, plus -inf at the keys where `attention_mask` is 0."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        c = self.config = config
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            0.02 * torch.randn(c.max_position_embeddings, c.hidden_size))
        self._layers = []
        for i in range(c.num_hidden_layers):
            layer = _CLIPLayer(c)
            self.add_module(f"layers_{i}", layer)
            self._layers.append(layer)
        self.final_layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.text_projection = (Dense(c.hidden_size, c.projection_dim, dtype=None, bias=False)
                                if c.projection_dim is not None else None)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                penultimate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        b, n = input_ids.shape
        ids = input_ids.long()
        x = self.token_embedding(ids) + self.position_embedding[None, :n]
        dt = torch.promote_types(x.dtype, torch.float32)
        mask = torch.full((n, n), -math.inf, dtype=dt, device=x.device).triu(1)[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -math.inf)
            mask = mask + pad.to(dt)
        penult = x
        for i, layer in enumerate(self._layers):
            if i == c.num_hidden_layers - 1:
                penult = x
            x = layer(x, mask)
        x = self.final_layer_norm(x)
        if c.eos_token_id == 2:
            eos = torch.argmax(ids, dim=-1)
        else:
            eos = torch.argmax((ids == c.eos_token_id).int(), dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return (penult if penultimate else x), pooled


# =========================================================================
# T5 encoder stack (HF T5EncoderModel-compatible)
# =========================================================================


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # t5-v1_1; classic t5 = "relu"


class _T5RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps), the mean in (at least) fp32, cast back to
    x's dtype before the scale."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


def _t5_relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                                 max_distance: int) -> np.ndarray:
    """Bidirectional bucketing (HF T5Attention._relative_position_bucket),
    in numpy int64 as the JAX package computes it."""
    ret = np.zeros_like(relative_position)
    num_buckets //= 2
    ret += (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


class _T5Attention(nn.Module):
    def __init__(self, c: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.c = c
        inner = c.num_heads * c.d_kv
        self.q = Dense(c.d_model, inner, dtype=None, bias=False)
        self.k = Dense(c.d_model, inner, dtype=None, bias=False)
        self.v = Dense(c.d_model, inner, dtype=None, bias=False)
        self.o = Dense(inner, c.d_model, dtype=None, bias=False)
        self.relative_attention_bias = (
            nn.Embedding(c.relative_attention_num_buckets, c.num_heads)
            if has_relative_bias else None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                position_bias: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        c, n = self.c, x.shape[1]
        if position_bias is None:
            pos = np.arange(n)
            buckets = _t5_relative_position_bucket(
                pos[None, :] - pos[:, None], c.relative_attention_num_buckets,
                c.relative_attention_max_distance)
            table = self.relative_attention_bias(torch.from_numpy(buckets).to(x.device))
            position_bias = table.permute(2, 0, 1)[None]  # (1, H, n, n)
        h = c.num_heads
        # No 1/sqrt(d) scaling: T5 folds it into its initialisation.
        out = _attend(_heads(self.q(x), h), _heads(self.k(x), h), _heads(self.v(x), h),
                      position_bias + mask)
        return self.o(_merge(out)), position_bias


class _T5Block(nn.Module):
    def __init__(self, c: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.attn_norm = _T5RMSNorm(c.d_model, eps=c.layer_norm_epsilon)
        self.attn = _T5Attention(c, has_relative_bias=has_relative_bias)
        self.ff_norm = _T5RMSNorm(c.d_model, eps=c.layer_norm_epsilon)
        self.gated = c.feed_forward_proj.startswith("gated")
        if self.gated:
            self._act = _act("gelu_new" if "gelu" in c.feed_forward_proj else "relu")
            self.wi_0 = Dense(c.d_model, c.d_ff, dtype=None, bias=False)
            self.wi_1 = Dense(c.d_model, c.d_ff, dtype=None, bias=False)
        else:
            self.wi = Dense(c.d_model, c.d_ff, dtype=None, bias=False)
        self.wo = Dense(c.d_ff, c.d_model, dtype=None, bias=False)

    def forward(self, x, mask, position_bias):
        attn_out, position_bias = self.attn(self.attn_norm(x), mask, position_bias)
        x = x + attn_out
        h = self.ff_norm(x)
        h = self._act(self.wi_0(h)) * self.wi_1(h) if self.gated else F.relu(self.wi(h))
        return x + self.wo(h), position_bias


class T5Encoder(nn.Module):
    """T5 encoder stack over sentencepiece ids (B, N): the final RMS-normed
    hidden states (HF `last_hidden_state`); keys where `attention_mask` is
    0 get -inf."""

    def __init__(self, config: T5Config):
        super().__init__()
        c = self.config = config
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        self._blocks = []
        for i in range(c.num_layers):
            block = _T5Block(c, has_relative_bias=(i == 0))
            self.add_module(f"block_{i}", block)
            self._blocks.append(block)
        self.final_norm = _T5RMSNorm(c.d_model, eps=c.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared(input_ids.long())
        dt = torch.promote_types(x.dtype, torch.float32)
        if attention_mask is not None:
            mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -math.inf).to(dt)
        else:
            mask = torch.zeros((1, 1, 1, input_ids.shape[1]), dtype=dt, device=x.device)
        position_bias = None
        for block in self._blocks:
            x, position_bias = block(x, mask, position_bias)
        return self.final_norm(x)


# =========================================================================
# HF state-dict importers
# =========================================================================


def _load_flax_leaves(module: nn.Module, resolve, sd: Dict[str, np.ndarray]) -> nn.Module:
    """Fills `module` from the HF state dict `sd`: `resolve(path)` gives the
    flax-layout array (the JAX importer's) of each flax path of the module,
    which the weight bridge lays out as the port's parameter. Raises on a
    missing key or a shape that differs."""
    from xdiffusion_tpu_torch.weights import flax_paths, flax_to_state_dict

    flat = {}
    for path in flax_paths(module).values():
        flat[path] = np.asarray(resolve(path.split("/"))).astype(np.float32)
    module.load_state_dict(flax_to_state_dict(flat, module))
    return module


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def import_hf_clip_text(module: CLIPTextTransformer, sd: Dict) -> CLIPTextTransformer:
    """Loads an HF CLIPTextModel(WithProjection) state dict, with or without
    its `text_model.` prefix, into `module` in place and returns it."""
    pfx = "text_model." if any(k.startswith("text_model.") for k in sd) else ""

    def resolve(sub):
        leaf = sub[-1]
        if sub[0] == "token_embedding":
            return _np(sd[f"{pfx}embeddings.token_embedding.weight"])
        if sub[0] == "position_embedding":
            return _np(sd[f"{pfx}embeddings.position_embedding.weight"])
        if sub[0] == "final_layer_norm":
            return _np(sd[f"{pfx}final_layer_norm.{'weight' if leaf == 'scale' else 'bias'}"])
        if sub[0] == "text_projection":
            return _np(sd["text_projection.weight"]).T
        if sub[0].startswith("layers_"):
            base = f"{pfx}encoder.layers.{sub[0].split('_')[-1]}"
            mod = sub[1]
            if mod == "self_attn":
                t = _np(sd[f"{base}.self_attn.{sub[2]}.{'weight' if leaf == 'kernel' else 'bias'}"])
                return t.T if leaf == "kernel" else t
            if mod in ("layer_norm1", "layer_norm2"):
                return _np(sd[f"{base}.{mod}.{'weight' if leaf == 'scale' else 'bias'}"])
            if mod in ("fc1", "fc2"):
                t = _np(sd[f"{base}.mlp.{mod}.{'weight' if leaf == 'kernel' else 'bias'}"])
                return t.T if leaf == "kernel" else t
        raise KeyError(f"unmapped CLIP path {sub}")

    return _load_flax_leaves(module, resolve, sd)


def import_hf_t5_encoder(module: T5Encoder, sd: Dict) -> T5Encoder:
    """Loads an HF T5EncoderModel state dict (its table as `shared.weight`
    or `encoder.embed_tokens.weight`) into `module` in place and returns it."""

    def resolve(sub):
        if sub[0] == "shared":
            return _np(sd["shared.weight"] if "shared.weight" in sd
                       else sd["encoder.embed_tokens.weight"])
        if sub[0] == "final_norm":
            return _np(sd["encoder.final_layer_norm.weight"])
        if sub[0].startswith("block_"):
            base = f"encoder.block.{sub[0].split('_')[-1]}"
            mod = sub[1]
            if mod == "attn_norm":
                return _np(sd[f"{base}.layer.0.layer_norm.weight"])
            if mod == "ff_norm":
                return _np(sd[f"{base}.layer.1.layer_norm.weight"])
            if mod == "attn":
                if sub[2] == "relative_attention_bias":
                    return _np(sd[f"{base}.layer.0.SelfAttention.relative_attention_bias.weight"])
                return _np(sd[f"{base}.layer.0.SelfAttention.{sub[2]}.weight"]).T
            if mod in ("wi", "wi_0", "wi_1", "wo"):
                return _np(sd[f"{base}.layer.1.DenseReluDense.{mod}.weight"]).T
        raise KeyError(f"unmapped T5 path {sub}")

    return _load_flax_leaves(module, resolve, sd)


# =========================================================================
# Pretrained loading (local files only)
# =========================================================================


def _hub_caches():
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
        "huggingface")
    return [p for p in (os.environ.get("HF_HUB_CACHE"), os.environ.get("HUGGINGFACE_HUB_CACHE"),
                        os.environ.get("TRANSFORMERS_CACHE"), os.path.join(home, "hub")) if p]


def locally_cached(version: str) -> bool:
    """Whether `version` could load from local files: a directory, or a
    `models--<org>--<name>` entry of a HuggingFace cache."""
    if os.path.isdir(version):
        return True
    entry = "models--" + version.replace("/", "--")
    return any(os.path.isdir(os.path.join(root, entry)) for root in _hub_caches())


def local_tokenizer(version: str, cls: str = "AutoTokenizer"):
    """The `transformers` tokenizer `cls` of `version` from local files, or
    None (nothing cached, no `transformers`, or any failure)."""
    if not locally_cached(version):
        return None
    try:
        import transformers

        return getattr(transformers, cls).from_pretrained(version, local_files_only=True)
    except Exception:
        return None


def _finish(model: nn.Module, device) -> nn.Module:
    from xdiffusion_tpu_torch.utils import resolve_device

    return model.to(resolve_device(device)).eval().requires_grad_(False)


def load_pretrained_clip_text(version: str, with_projection: bool = False, device=None):
    """(config, tower on `device`, tokenizer) of a locally cached CLIP text
    model, or None when none loads; never touches the network.
    `with_projection` gives CLIPTextModelWithProjection's pooled
    `text_embeds` (SD3's stack)."""
    if not locally_cached(version):
        return None
    try:
        from transformers import AutoTokenizer, CLIPTextModel

        if with_projection:
            from transformers import CLIPTextModelWithProjection

            hf = CLIPTextModelWithProjection.from_pretrained(version, local_files_only=True)
        else:
            hf = CLIPTextModel.from_pretrained(version, local_files_only=True)
        tok = AutoTokenizer.from_pretrained(version, local_files_only=True)
    except Exception:
        return None
    hc = hf.config
    cfg = CLIPTextConfig(
        vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
        intermediate_size=hc.intermediate_size, num_hidden_layers=hc.num_hidden_layers,
        num_attention_heads=hc.num_attention_heads,
        max_position_embeddings=hc.max_position_embeddings, layer_norm_eps=hc.layer_norm_eps,
        hidden_act=hc.hidden_act, eos_token_id=hc.eos_token_id,
        projection_dim=hc.projection_dim if with_projection else None)
    model = import_hf_clip_text(CLIPTextTransformer(cfg), hf.state_dict())
    return cfg, _finish(model, device), tok


def load_pretrained_t5(version: str, device=None):
    """(config, encoder on `device`, tokenizer) of a locally cached T5
    encoder, or None; see `load_pretrained_clip_text`."""
    if not locally_cached(version):
        return None
    try:
        from transformers import AutoTokenizer, T5EncoderModel

        hf = T5EncoderModel.from_pretrained(version, local_files_only=True)
        tok = AutoTokenizer.from_pretrained(version, local_files_only=True)
    except Exception:
        return None
    hc = hf.config
    cfg = T5Config(
        vocab_size=hc.vocab_size, d_model=hc.d_model, d_kv=hc.d_kv, d_ff=hc.d_ff,
        num_layers=hc.num_layers, num_heads=hc.num_heads,
        relative_attention_num_buckets=hc.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(hc, "relative_attention_max_distance", 128),
        layer_norm_epsilon=hc.layer_norm_epsilon, feed_forward_proj=hc.feed_forward_proj)
    model = import_hf_t5_encoder(T5Encoder(cfg), hf.state_dict())
    return cfg, _finish(model, device), tok
