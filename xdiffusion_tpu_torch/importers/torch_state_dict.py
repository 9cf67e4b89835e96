"""Reference-layout (PyTorch) score-network state dicts into the port.

Counterpart of xdiffusion_tpu/importers/torch_state_dict.py, resolved leaf
by leaf as there. The reference trainer saves `torch.save({"model_state_dict":
...})` checkpoints whose module tree parallels the flax tree layer for layer;
each port parameter is named by its flax path (`weights.flax_paths`), the
copied resolvers name its reference key and the layout transform into flax's
layout, and the result is laid out as the weight bridge lays a flax leaf out
(weights.py): a Dense kernel (I, O) becomes the (O, I) `weight`, a conv run
by `F.conv2d` OIHW, a residual block's K4 kernel stays HWIO. The import is
therefore the JAX import followed by the bridge, without a flax tree.

The layout differences:

- Conv2d OIHW -> flax HWIO; Conv1d(k=1) used as a channel mixer -> Dense.
- Linear (out, in) -> Dense (in, out).
- GroupNorm/LayerNorm `weight` -> `scale`.
- The UNet's fused qkv Conv1d interleaves (q, k, v) per head, while the
  port's Dense emits (q of every head, k, v): rows are de-interleaved.
- Separate q/k/v (or k/v) Linears concatenate into one fused Dense
  (`MULTI`: the leaf is assembled from several reference tensors).

Every transform is a `Layout` (or, for `MULTI`, a `Gather`) that carries
its exact inverse, so a reference-layout state dict can be written back from
port parameters through the same resolvers.

Imports nothing of JAX; torch reads the `.pt` files.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from xdiffusion_tpu_torch.weights import KERNEL_AXES, flax_paths

Array = np.ndarray

# Sentinel: resolve() returns (MULTI, gather) when a flax leaf is assembled
# from several reference tensors; the gather receives the whole state dict.
MULTI = object()


class Layout:
    """A reference tensor -> flax layout transform (`fwd`, the call) and its
    exact inverse (`inv`)."""

    __slots__ = ("fwd", "inv")

    def __init__(self, fwd: Callable[[Array], Array], inv: Callable[[Array], Array]):
        self.fwd, self.inv = fwd, inv

    def __call__(self, w: Array) -> Array:
        return self.fwd(w)


Transform = Layout


class Gather:
    """A flax leaf assembled from several reference tensors: `fwd(sd)` gives
    the flax-layout array, `inv(value, out)` writes the tensors it came
    from into the dict `out` (a tensor that two leaves share, SD3.5's fused
    modulation, is assembled from both)."""

    __slots__ = ("fwd", "inv")

    def __init__(self, fwd: Callable[[Dict[str, Array]], Array],
                 inv: Callable[[Array, Dict[str, Array]], None]):
        self.fwd, self.inv = fwd, inv

    def __call__(self, sd: Dict[str, Array]) -> Array:
        return self.fwd(sd)


# -- tensor layout transforms ------------------------------------------------


def _as_np(t) -> Array:
    """A tensor (bfloat16 through float32, which is exact) or array as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _transpose(axes) -> Layout:
    back = tuple(int(i) for i in np.argsort(axes))
    return Layout(lambda w: w.transpose(axes), lambda w: w.transpose(back))


_identity = Layout(lambda w: w, lambda w: w)
# torch Linear (out, in) -> flax Dense (in, out) (a 4-D tensor reverses).
_dense = Layout(lambda w: w.T, lambda w: w.T)
# torch OIHW -> flax HWIO.
_conv2d = _transpose((2, 3, 1, 0))
# torch OIDHW -> flax DHWIO.
_conv3d = _transpose((2, 3, 4, 1, 0))
# torch Conv1d(k=1) channel mixer (O, I, 1) -> Dense (I, O).
_conv1d_dense = Layout(lambda w: w[:, :, 0].T, lambda w: w.T[:, :, None])
# A gain-only norm's `g` ((C, 1) in the reference's ChanLayerNorm) -> (C,).
_flat_gain = Layout(lambda w: w.reshape(-1), lambda w: w.reshape(-1, 1))
# DyT's alpha: torch shape (1,) -> flax scalar ().
_scalar = Layout(lambda w: w.reshape(()), lambda w: w.reshape(1))


def _dyt_resolve(torch_base: str, leaf: str):
    """DynamicTanhNorm leaves (reference layers/norm.py:219-230):
    alpha is torch shape (1,) vs our scalar (); gamma/beta map 1:1."""
    tf = _scalar if leaf == "alpha" else _identity
    return (f"{torch_base}.{leaf}", tf)


def _qkv_deinterleave(parts: int, num_heads: int) -> Callable[[Array], Array]:
    """De-interleave a fused qkv/kv projection from per-head (q,k,v)
    grouping (reference QKVAttention layout) to per-part grouping (ours).

    Accepts Conv1d weight (parts*C, I, 1), Linear weight (parts*C, I), or
    bias (parts*C,). Returns the flax-layout array (Dense kernel (I, O)
    for weights, (O,) for biases).
    """

    def tf(w: Array) -> Array:
        out = w.shape[0]
        ch = out // (parts * num_heads)
        if w.ndim == 3:  # conv1d weight
            w2 = w[:, :, 0]
        elif w.ndim == 2:
            w2 = w
        else:  # bias
            return w.reshape(num_heads, parts, ch).transpose(1, 0, 2).reshape(out)
        cin = w2.shape[1]
        w2 = w2.reshape(num_heads, parts, ch, cin).transpose(1, 0, 2, 3).reshape(out, cin)
        return w2.T

    return tf


def _qkv_interleave(parts: int, num_heads: int, conv1d: bool) -> Callable[[Array], Array]:
    """The inverse of `_qkv_deinterleave`: per-part (q of every head, k, v)
    rows -> the reference's per-head (q, k, v) rows, a Dense kernel (I, O)
    as a Conv1d (O, I, 1) or Linear (O, I) weight, a bias (O,) as (O,)."""

    def tf(w: Array) -> Array:
        if w.ndim == 2:  # Dense kernel (I, O)
            w2 = w.T
            out, cin = w2.shape
            ch = out // (parts * num_heads)
            w2 = w2.reshape(parts, num_heads, ch, cin).transpose(1, 0, 2, 3).reshape(out, cin)
            return w2[:, :, None] if conv1d else w2
        out = w.shape[0]
        ch = out // (parts * num_heads)
        return w.reshape(parts, num_heads, ch).transpose(1, 0, 2).reshape(out)

    return tf


def _qkv_layout(parts: int, attn_heads: Callable[[int], int]) -> Layout:
    """A fused qkv (parts 3) or kv (parts 2) Conv1d of the reference's
    QKVAttention, its head count `attn_heads(channels)` of one part's
    width."""

    def fwd(w: Array) -> Array:
        return _qkv_deinterleave(parts, attn_heads(w.shape[0] // parts))(w)

    def inv(w: Array) -> Array:
        out = w.shape[-1] if w.ndim == 2 else w.shape[0]
        return _qkv_interleave(parts, attn_heads(out // parts), conv1d=True)(w)

    return Layout(fwd, inv)


def _patch_kernel(dense: nn.Module, patch: Tuple[int, ...]) -> Tuple[int, ...]:
    """(C, pt, ph, pw) of a patch-embedding Dense over `patch` (pt, ph, pw)."""
    return (dense.weight.shape[1] // int(np.prod(patch)),) + tuple(patch)


def _patch_dense(kernel: Tuple[int, ...]) -> Layout:
    """A patch-embedding Conv3d (O, C, pt, ph, pw) with kernel == stride ->
    the Dense (C*pt*ph*pw, O) over the flattened (c, pt, ph, pw) patch;
    `kernel` is (C, pt, ph, pw)."""
    return Layout(lambda w: w.reshape(w.shape[0], -1).T,
                  lambda w: w.T.reshape((w.shape[1],) + tuple(kernel)))


# -- checkpoint reading ------------------------------------------------------


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference `.pt`/`.pth` checkpoint into {key: tensor}.

    Accepts a raw state_dict, the reference trainer's {"model_state_dict":
    ...} wrapper, or a module nested one level more under "state_dict";
    strips DDP "module." prefixes (reference training/video/train.py:147-161
    does the same). Tensors and primitives only (`weights_only`).
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: unrecognized checkpoint structure {type(obj)}")
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in obj.items()}


def strip_prefix(sd: Dict[str, Array], prefix: str) -> Dict[str, Array]:
    """Narrow a whole-model state_dict to one submodule, e.g.
    `strip_prefix(sd, "_score_network.")` for the reference
    GaussianDiffusion_DDPM wrapper."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# -- generic application -----------------------------------------------------


def _apply_mapping(
    module: nn.Module,
    sd: Dict[str, Array],
    resolve: Callable[[Tuple[str, ...]], Optional[Tuple[Any, Any]]],
    strict: bool = True,
) -> nn.Module:
    """Load the tensors of `sd` into `module` in place and return it.

    `resolve(path)` returns (torch_key, Layout) for a parameter's flax path
    (`weights.flax_paths`, split at "/"), or None to keep the parameter's
    value (paths with no reference counterpart). The special form (MULTI,
    Gather) computes the tensor from the whole state dict. The flax-layout
    array is cast to float32, as the JAX import casts it to the flax
    parameter's dtype, then laid out as weights.py's bridge lays it out.
    Not `strict`, a parameter whose key `sd` lacks keeps its value (the JAX
    import drops the leaf)."""
    target = module.state_dict()
    new = {}
    missing = []
    for name, path in flax_paths(module).items():
        found = resolve(tuple(path.split("/")))
        if found is None:
            continue
        key, tf = found
        if key is MULTI:
            t = tf(sd)
        elif key not in sd:
            missing.append((path, key))
            continue
        else:
            t = tf(_as_np(sd[key]))
        t = np.asarray(t, dtype=np.float32)
        if (name.rpartition(".")[2] == "weight" and path.endswith("kernel")
                and t.ndim in KERNEL_AXES):
            t = t.transpose(KERNEL_AXES[t.ndim])
        want = tuple(target[name].shape)
        if t.shape != want:
            source = "assembling" if key is MULTI else f"importing {key} ->"
            raise ValueError(f"shape mismatch {source} {path}: {t.shape} vs {want}")
        new[name] = torch.from_numpy(t.copy()).to(target[name].dtype)  # C order, 0-d kept
    if missing and strict:
        lines = [f"  {p} <- {k}" for p, k in missing]
        raise KeyError("torch state_dict is missing keys for flax params:\n" + "\n".join(lines))
    module.load_state_dict(new, strict=False)
    return module




# -- UNet (reference score_networks/unet.py:35) ------------------------------

# Sub-module leaf tables: flax child name -> (torch suffix base, transform
# for the weight/kernel leaf). Norm scale/bias handled uniformly.
_BIGGAN_RES = {
    "norm1": ("in_layers.0", None),
    "conv1": ("in_layers.2", _conv2d),
    "emb_proj": ("emb_layers.1", _dense),
    "norm2": ("out_layers.0", None),
    "conv2": ("out_layers.3", _conv2d),
    "skip": ("skip_connection", _conv2d),
}
_DDPM_RES = {
    "norm1": ("block1.0", None),
    "conv1": ("block1.2", _conv2d),
    "emb_proj": ("timestep_proj.1", _dense),
    "norm2": ("block2.0", None),
    "conv2": ("block2.3", _conv2d),
    "skip": ("residual_proj", _dense),
}

_STAGE_RE = re.compile(r"^_(downs|ups)_(\d+)_(\d+)_1$")
_MIDDLE_RE = re.compile(r"^_middle_(\d+)_1$")
_PROJ_RE = re.compile(r"^_projections_(\w+)$")


def _leaf_name(torch_base: str, flax_leaf: str) -> str:
    if flax_leaf in ("scale", "kernel", "weight", "embedding"):
        return torch_base + ".weight"
    return torch_base + "." + flax_leaf


_ST_LN_RE = re.compile(r"^ln([123])_(\d+)$")
_ST_ATTN_RE = re.compile(r"^(self|cross)_(\d+)_(q|k|v|out)$")
_ST_FF_RE = re.compile(r"^ff_(geglu|out)_(\d+)$")


# torch Conv2d(k=1) channel mixer (O, I, 1, 1) -> Dense (I, O).
_conv2d_1x1_dense = Layout(lambda w: w[:, :, 0, 0].T, lambda w: w.T[:, :, None, None])


def _spatial_transformer_leaf(base: str, sub: Tuple[str, ...]):
    """Leaves of our flax SpatialTransformer (layers/transformer.py) ->
    the reference SpatialTransformer module tree: norm / proj_in /
    transformer_blocks.{i}.(norm1..3, attn1/attn2 to_q/k/v/out,
    ff.net.0.proj GEGLU, ff.net.2) / proj_out."""
    child, leaf = sub[0], sub[-1]
    if child == "norm":
        return (_leaf_name(f"{base}.norm", leaf), _identity)
    if child in ("proj_in", "proj_out"):
        if leaf == "kernel":
            return (f"{base}.{child}.weight", _conv2d_1x1_dense)
        return (f"{base}.{child}.bias", _identity)
    m = _ST_LN_RE.match(child)
    if m:
        tb = f"{base}.transformer_blocks.{m.group(2)}.norm{m.group(1)}"
        return (_leaf_name(tb, leaf), _identity)
    m = _ST_ATTN_RE.match(child)
    if m:
        attn = "attn1" if m.group(1) == "self" else "attn2"
        proj = "to_out" if m.group(3) == "out" else f"to_{m.group(3)}"
        tb = f"{base}.transformer_blocks.{m.group(2)}.{attn}.{proj}"
        return (
            _leaf_name(tb, leaf), _dense if leaf == "kernel" else _identity
        )
    m = _ST_FF_RE.match(child)
    if m:
        net = "net.0.proj" if m.group(1) == "geglu" else "net.2"
        tb = f"{base}.transformer_blocks.{m.group(2)}.ff.{net}"
        return (
            _leaf_name(tb, leaf), _dense if leaf == "kernel" else _identity
        )
    return None


def _make_unet_resolve(
    sd: Dict[str, Array], heads: int, dim_head: int
) -> Callable[[Tuple[str, ...]], Optional[Tuple[str, Transform]]]:
    """The image-UNet leaf resolver (reference score_networks/unet.py:35),
    reusable by the video wrappers whose spatial tree shares the exact
    same names (VideoLDMUnet / AnimateDiffUnet subclass Unet)."""

    def attn_heads(channels: int) -> int:
        return heads if dim_head == -1 else channels // dim_head

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]

        m = _PROJ_RE.match(top)
        if m:
            name = m.group(1)
            base = f"_projections.{name}"
            if path[1] == "fc1":
                return (_leaf_name(f"{base}._projection.1", leaf), _dense)
            if path[1] == "fc2":
                return (_leaf_name(f"{base}._projection.3", leaf), _dense)
            if path[1] in ("embed", "table"):
                # TextTokenProjection stores its Embedding as
                # `embedding_table` in some reference variants and as
                # `_projection` in others (layers/embedding.py).
                key = (
                    f"{base}.embedding_table.weight"
                    if f"{base}.embedding_table.weight" in sd
                    else f"{base}._projection.weight"
                )
                return (key, _identity)
        if top == "_label_projection":
            return ("_label_projection.weight", _identity)
        if top == "initial_conv":
            return ("_initial_convolution.weight", _conv2d)
        if top == "final_norm":
            return (_leaf_name("final_projection.0", leaf), _identity)
        if top == "final_conv":
            return ("final_projection.2.weight", _conv2d)

        m = _STAGE_RE.match(top) or _MIDDLE_RE.match(top)
        if m is None:
            return None
        if m.re is _MIDDLE_RE:
            base = f"middle.{m.group(1)}"
            pyramid = "middle"
        else:
            pyramid, i, j = m.group(1), m.group(2), m.group(3)
            base = f"{pyramid}.{i}.{j}"

        child = path[1]
        # SpatialTransformer attention sites (LDM cross-attention,
        # reference layers/transformer.py:103-246) — distinguished from
        # the plain attention block by the transformer_blocks subtree.
        if f"{base}.transformer_blocks.0.norm1.weight" in sd:
            st = _spatial_transformer_leaf(base, path[1:])
            if st is not None:
                return st

        # Residual blocks — two torch dialects (BigGAN vs DDPM naming).
        table = (
            _BIGGAN_RES
            if f"{base}.in_layers.0.weight" in sd
            else _DDPM_RES
        )
        if child in table:
            suffix, tf = table[child]
            if leaf in ("scale", "bias") and tf is None:
                return (_leaf_name(f"{base}.{suffix}", leaf), _identity)
            if leaf == "kernel":
                return (f"{base}.{suffix}.weight", tf)
            return (f"{base}.{suffix}.bias", _identity)
        # Attention block leaves.
        if child == "norm":
            return (_leaf_name(f"{base}._norm", leaf), _identity)
        if child in ("qkv", "encoder_kv"):
            parts = 3 if child == "qkv" else 2
            torch_key = f"{base}._{child.lstrip('_')}"
            # The head count from one part's width, of the tensor itself.
            return (_leaf_name(torch_key, leaf), _qkv_layout(parts, attn_heads))
        if child == "proj_out":
            if leaf == "kernel":
                return (f"{base}._proj_out.weight", _conv1d_dense)
            return (f"{base}._proj_out.bias", _identity)
        if child == "context_norm":
            return (f"{base}._context_layer_norm.g", _flat_gain)
        # Explicit resampling modules: ours are named "conv"; torch names
        # the conv "op" in Downsample, "conv" in Upsample (layers/
        # resnet.py:459,490).
        if child == "conv":
            op = "op" if pyramid == "downs" else "conv"
            if leaf == "kernel":
                return (f"{base}.{op}.weight", _conv2d)
            return (f"{base}.{op}.bias", _identity)
        return None

    return resolve


def import_unet_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    heads: int = 8,
    dim_head: int = 64,
    strict: bool = True,
) -> nn.Module:
    """Import a reference UNet state_dict (score_networks/unet.py:35) into
    our `score_networks.unet.Unet` param tree.

    heads/dim_head mirror the config's context_transformer_layer params —
    needed to de-interleave the fused qkv rows per attention site.
    """
    return _apply_mapping(
        module, sd, _make_unet_resolve(sd, heads, dim_head),
        strict=strict,
    )


# -- UNet3D (reference score_networks/unet_3d.py:27) -------------------------

def _conv3d_spatial_fwd(w: Array) -> Array:
    assert w.shape[2] == 1, f"temporal extent {w.shape[2]} != 1"
    return w[:, :, 0].transpose(2, 3, 1, 0)


# torch Conv3d with unit temporal extent (O, I, 1, kh, kw) -> flax 2D
# per-frame Conv (kh, kw, I, O). The video UNet's convs are all (1,3,3) or
# 1x1x1 (reference resnet_3d.py / unet_3d.py), i.e. exactly a 2D conv run
# per frame, which is how the network executes them.
_conv3d_spatial = Layout(_conv3d_spatial_fwd, lambda w: w.transpose(3, 2, 0, 1)[:, :, None])


_BIGGAN3D_RES = {
    "norm1": ("in_layers.0", None),
    "conv1": ("in_layers.2", _conv3d_spatial),
    "norm2": ("out_layers.0", None),
    "conv2": ("out_layers.3", _conv3d_spatial),
    "skip": ("skip_connection", _conv3d_spatial),
}
_DDPM3D_RES = {
    "norm1": ("block1.0", None),
    "conv1": ("block1.2", _conv3d_spatial),
    "norm2": ("block2.0", None),
    "conv2": ("block2.3", _conv3d_spatial),
    "skip": ("residual_proj", _dense),
}

_EMB_MLP_RE = re.compile(r"^emb_mlp(\d+)_fc(\d)$")


def import_unet3d_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    heads: int = 8,
    dim_head: int = 64,
    strict: bool = True,
) -> nn.Module:
    """Import a reference video UNet state_dict (score_networks/
    unet_3d.py:27) into our `score_networks.unet_3d.Unet` param tree.

    Layout notes beyond the 2D importer: every torch conv is a Conv3d with
    unit temporal extent -> per-frame 2D conv here; the emb projection is
    an Mlp stack (`emb_layers.{i}.fc{1,2}` / `timestep_proj.{i}.fc{1,2}`);
    temporal attention carries t2t relative-position embedding tables
    (`_attention._{k,v}_embeddings_table`, reference attention.py:516-549).
    """

    def attn_heads(channels: int) -> int:
        return heads if dim_head == -1 else channels // dim_head

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]

        m = _PROJ_RE.match(top)
        if m:
            name = m.group(1)
            base = f"_projections.{name}"
            if path[1] == "fc1":
                return (_leaf_name(f"{base}._projection.1", leaf), _dense)
            if path[1] == "fc2":
                return (_leaf_name(f"{base}._projection.3", leaf), _dense)
            if path[1] in ("embed", "table"):
                return (f"{base}.embedding_table.weight", _identity)
        if top == "_label_projection":
            return ("_label_projection.weight", _identity)
        if top == "initial_conv":
            return ("_initial_convolution.weight", _conv3d_spatial)
        if top == "final_norm":
            return (_leaf_name("final_projection.0", leaf), _identity)
        if top == "final_conv":
            return ("final_projection.2.weight", _conv3d_spatial)

        m = _STAGE_RE.match(top) or _MIDDLE_RE.match(top)
        if m is None:
            return None
        if m.re is _MIDDLE_RE:
            base = f"middle.{m.group(1)}"
            pyramid = "middle"
        else:
            pyramid, i, j = m.group(1), m.group(2), m.group(3)
            base = f"{pyramid}.{i}.{j}"

        child = path[1]
        is_biggan = f"{base}.in_layers.0.weight" in sd
        table = _BIGGAN3D_RES if is_biggan else _DDPM3D_RES
        em = _EMB_MLP_RE.match(child)
        if em:
            stack = "emb_layers" if is_biggan else "timestep_proj"
            torch_base = f"{base}.{stack}.{em.group(1)}.fc{em.group(2)}"
            return (_leaf_name(torch_base, leaf), _dense)
        if child in table:
            suffix, tf = table[child]
            if leaf in ("scale", "bias") and tf is None:
                return (_leaf_name(f"{base}.{suffix}", leaf), _identity)
            if leaf == "kernel":
                return (f"{base}.{suffix}.weight", tf)
            return (f"{base}.{suffix}.bias", _identity)
        # Attention layers sit inside an EinopsToAndFrom wrapper in the
        # torch tree (reference unet_3d.py:141-165 -> layers/utils.py:292),
        # adding a ".fn" segment.
        if child == "norm":
            return (_leaf_name(f"{base}.fn._norm", leaf), _identity)
        if child in ("qkv", "encoder_kv"):
            parts = 3 if child == "qkv" else 2
            torch_key = f"{base}.fn._{child}"
            return (_leaf_name(torch_key, leaf), _qkv_layout(parts, attn_heads))
        if child == "proj_out":
            if leaf == "kernel":
                return (f"{base}.fn._proj_out.weight", _conv1d_dense)
            return (f"{base}.fn._proj_out.bias", _identity)
        if child in ("rel_k_embeddings", "rel_v_embeddings"):
            which = "k" if child == "rel_k_embeddings" else "v"
            return (
                f"{base}.fn._attention._{which}_embeddings_table",
                _identity,
            )
        if child == "context_norm":
            return (
                f"{base}.fn._context_layer_norm.g", _flat_gain
            )
        if child == "conv":
            op = "op" if pyramid == "downs" else "conv"
            if leaf == "kernel":
                return (f"{base}.{op}.weight", _conv3d_spatial)
            return (f"{base}.{op}.bias", _identity)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- DiT (reference score_networks/dit.py:77) --------------------------------

_DIT_BLOCK_RE = re.compile(r"^_blocks_(\d+)$")


def import_dit_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference DiT state_dict into our `score_networks.dit.DiT`
    param tree. DiT's fused qkv Linear already groups rows (q, k, v) with
    head-major order inside each part, matching our Dense — plain
    transposes throughout."""

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        if top == "patch_embed":
            return (_leaf_name("x_embedder.proj", leaf), _conv2d if leaf == "kernel" else _identity)
        m = _PROJ_RE.match(top)
        if m:
            name = m.group(1)
            if path[1] == "fc1":
                return (_leaf_name(f"_projections.{name}.mlp.0", leaf), _dense)
            if path[1] == "fc2":
                return (_leaf_name(f"_projections.{name}.mlp.2", leaf), _dense)
            if path[1] in ("embed", "table"):
                return (f"_projections.{name}.embedding_table.weight", _identity)
        if top == "_final":
            if path[1] == "proj":
                return (_leaf_name("final_layer.linear", leaf), _dense if leaf == "kernel" else _identity)
            if path[1] == "adaLN_modulation":
                return (
                    _leaf_name("final_layer.adaLN_modulation.1", leaf),
                    _dense if leaf == "kernel" else _identity,
                )
        m = _DIT_BLOCK_RE.match(top)
        if m:
            base = f"blocks.{m.group(1)}"
            child = path[1]
            tf = _dense if leaf == "kernel" else _identity
            if child == "attn":
                return (_leaf_name(f"{base}.attn.{path[2]}", leaf), tf)
            if child == "adaLN_modulation":
                return (_leaf_name(f"{base}.adaLN_modulation.1", leaf), tf)
            if child == "mlp_fc1":
                return (_leaf_name(f"{base}.mlp.fc1", leaf), tf)
            if child == "mlp_fc2":
                return (_leaf_name(f"{base}.mlp.fc2", leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- PixArt-alpha (reference score_networks/pixart.py:123) -------------------

_PIXART_BLOCK_RE = re.compile(r"^_blocks_(\d+)$")
_CTX_HEAD_RE = re.compile(r"^_context_heads_(\d+)$")


def import_pixart_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference PixArtAlpha state_dict into our
    `score_networks.pixart.PixArtAlpha` param tree.

    Layout notes (reference score_networks/pixart.py:24-120):
    - blocks.{i}.attn is a fused-qkv MultiHeadSelfAttention whose rows
      group (q, k, v) part-major — plain transposes map to our Dense.
    - blocks.{i}.cross_attn is LastChannelCrossAttention with separate
      bias-free to_k/to_v — concatenated into our fused `kv` Dense.
    - ContextProjection heads live in the torch `_context_transformers`
      ModuleList; ours keep positional order, so the k-th parameterized
      flax head maps to the k-th `.y_proj` group in torch index order.
    """
    # Positional pairing of ContextProjection heads (see docstring).
    ctx_torch_idx = sorted(
        {
            int(m.group(1))
            for k in sd
            for m in [re.match(r"^_context_transformers\.(\d+)\.y_proj\.", k)]
            if m
        }
    )
    ctx_flax_idx = sorted(
        {
            int(m.group(1))
            for path in flax_paths(module).values()
            for m in [_CTX_HEAD_RE.match(path.split("/")[0])]
            if m
        }
    )
    head_map = dict(zip(ctx_flax_idx, ctx_torch_idx))

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]

        if top == "patch_embed":
            return (
                _leaf_name("x_embedder.proj", leaf),
                _conv2d if leaf == "kernel" else _identity,
            )
        m = _PROJ_RE.match(top)
        if m:
            name = m.group(1)
            base = f"_projections.{name}"
            if len(path) > 1 and path[1] == "fc1":
                return (_leaf_name(f"{base}.mlp.0", leaf), _dense)
            if len(path) > 1 and path[1] == "fc2":
                return (_leaf_name(f"{base}.mlp.2", leaf), _dense)
            if len(path) > 1 and path[1] in ("embed", "table"):
                # DiTLabelEmbedding / TextTokenProjection tables.
                key = (
                    f"{base}.embedding_table.weight"
                    if f"{base}.embedding_table.weight" in sd
                    else f"{base}._projection.weight"
                )
                return (key, _identity)
        m = _CTX_HEAD_RE.match(top)
        if m:
            ti = head_map.get(int(m.group(1)))
            if ti is None:
                return None
            base = f"_context_transformers.{ti}.y_proj"
            child = path[1]
            if child in ("fc1", "fc2"):
                return (_leaf_name(f"{base}.{child}", leaf), _dense)
        if top == "t_block":
            return (_leaf_name("t_block.1", leaf), _dense if leaf == "kernel" else _identity)
        if top == "final_scale_shift_table":
            return ("final_layer.scale_shift_table", _identity)
        if top == "final_norm":
            # DyT variant only (reference dyt.py:110 DyTFinalLayer).
            return _dyt_resolve("final_layer.norm_final", leaf)
        if top == "final_proj":
            return (_leaf_name("final_layer.linear", leaf), _dense if leaf == "kernel" else _identity)

        m = _PIXART_BLOCK_RE.match(top)
        if m:
            base = f"blocks.{m.group(1)}"
            child = path[1]
            tf = _dense if leaf == "kernel" else _identity
            if child == "scale_shift_table" or leaf == "scale_shift_table":
                return (f"{base}.scale_shift_table", _identity)
            if child in ("norm1", "norm2"):
                # DyT variant only (reference dyt.py:44,57 — the vanilla
                # PixArt norms are parameterless LayerNorms).
                return _dyt_resolve(f"{base}.{child}", leaf)
            if child == "attn":
                return (_leaf_name(f"{base}.attn.{path[2]}", leaf), tf)
            if child == "cross_attn":
                sub = path[2]
                if sub == "q":
                    return (f"{base}.cross_attn.to_q.weight", _dense)
                if sub == "kv":
                    keys = [f"{base}.cross_attn.to_k", f"{base}.cross_attn.to_v"]
                    return (MULTI, _concat_dense(keys))
                if sub == "proj":
                    return (_leaf_name(f"{base}.cross_attn.to_out", leaf), tf)
            if child in ("mlp_fc1", "mlp_fc2"):
                torch_child = "fc1" if child == "mlp_fc1" else "fc2"
                return (_leaf_name(f"{base}.mlp.{torch_child}", leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- SD3 MMDiT (reference score_networks/sd3.py:11) --------------------------

_SD3_BLOCK_RE = re.compile(r"^block_(\d+)$")


def _concat_dense(keys, bias=False) -> Gather:
    """MULTI transform: concat several torch Linears of equal width along
    the output dim into one fused flax Dense (kernel (I, sum O) or bias
    (sum O,))."""
    suffix = ".bias" if bias else ".weight"

    def fwd(sd):
        w = np.concatenate([_as_np(sd[k + suffix]) for k in keys], axis=0)
        return w if bias else w.T

    def inv(value, out):
        for k, part in zip(keys, np.split(value if bias else value.T, len(keys), axis=0)):
            out[k + suffix] = part

    return Gather(fwd, inv)


def _fused_rows(key: str, first: bool, dual_marker: str) -> Gather:
    """SD3.5's fused 9*d modulation Linear `key` (.weight or .bias): the
    first 6*d rows (`first`; all rows of a block without `dual_marker`'s
    tensor) or the last 3*d, as a Dense kernel or bias."""
    kernel = key.endswith(".weight")

    def fwd(sd):
        w = _as_np(sd[key])
        if first:
            if dual_marker in sd:  # dual: 9*d fused
                w = w[: (w.shape[0] // 9) * 6]
        else:
            w = w[(w.shape[0] // 9) * 6:]
        return w.T if kernel else w

    def inv(value, out):
        w = value.T if kernel else value
        if key in out:
            w = np.concatenate([w, out[key]] if first else [out[key], w], axis=0)
        out[key] = w

    return Gather(fwd, inv)


def import_sd3_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference SD3Transformer2DModel state_dict into our
    `score_networks.sd3.SD3Transformer2DModel` param tree.

    The reference attention keeps separate to_q/to_k/to_v (image stream)
    and add_{q,k,v}_proj (text stream) Linears (reference layers/
    sd3.py:252-283); ours fuse each stream's qkv into one Dense, so the
    three weights concatenate row-wise before the transpose.
    """

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        if top == "pos_embed":  # our PatchEmbed is named pos_embed too
            return (
                _leaf_name("pos_embed.proj", leaf),
                _conv2d if leaf == "kernel" else _identity,
            )
        if top == "time_text_embed":
            sub = path[1]
            tmap = {
                "t_fc1": "timestep_embedder.linear_1",
                "t_fc2": "timestep_embedder.linear_2",
                "p_fc1": "text_embedder.linear_1",
                "p_fc2": "text_embedder.linear_2",
            }
            if sub in tmap:
                return (_leaf_name(f"time_text_embed.{tmap[sub]}", leaf), tf)
        if top == "context_embedder":
            return (_leaf_name("context_embedder", leaf), tf)
        if top == "final_mod":
            return (_leaf_name("norm_out.linear", leaf), tf)
        if top == "final_proj":
            return (_leaf_name("proj_out", leaf), tf)

        m = _SD3_BLOCK_RE.match(top)
        if m:
            base = f"transformer_blocks.{m.group(1)}"
            child = path[1]
            if child == "mod_x":
                # SD3.5 dual-attention blocks fuse 9*d modulation signals
                # in ONE norm1.linear (SD35AdaLayerNormZeroX, reference
                # layers/sd35.py:188-236); our tree keeps mod_x (first
                # 6*d) and mod_x2attn (last 3*d) separate.
                key = f"{base}.norm1.linear" + (".weight" if leaf == "kernel" else ".bias")
                return (MULTI, _fused_rows(key, True, f"{base}.attn2.to_q.weight"))
            if child == "mod_x2attn":
                key = f"{base}.norm1.linear" + (".weight" if leaf == "kernel" else ".bias")
                return (MULTI, _fused_rows(key, False, f"{base}.attn2.to_q.weight"))
            if child == "mod_c":
                return (_leaf_name(f"{base}.norm1_context.linear", leaf), tf)
            if child == "qkv_x":
                keys = [f"{base}.attn.to_q", f"{base}.attn.to_k", f"{base}.attn.to_v"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "qkv_c":
                keys = [
                    f"{base}.attn.add_q_proj",
                    f"{base}.attn.add_k_proj",
                    f"{base}.attn.add_v_proj",
                ]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "qkv_x2":
                keys = [
                    f"{base}.attn2.to_q",
                    f"{base}.attn2.to_k",
                    f"{base}.attn2.to_v",
                ]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "proj_x":
                return (_leaf_name(f"{base}.attn.to_out.0", leaf), tf)
            if child == "proj_x2":
                return (_leaf_name(f"{base}.attn2.to_out.0", leaf), tf)
            if child == "proj_c":
                return (_leaf_name(f"{base}.attn.to_add_out", leaf), tf)
            norms = {
                "q_norm": f"{base}.attn.norm_q.weight",
                "k_norm": f"{base}.attn.norm_k.weight",
                "c_q_norm": f"{base}.attn.norm_added_q.weight",
                "c_k_norm": f"{base}.attn.norm_added_k.weight",
                "q2_norm": f"{base}.attn2.norm_q.weight",
                "k2_norm": f"{base}.attn2.norm_k.weight",
            }
            if child in norms:
                return (norms[child], _identity)
            ff = {
                "mlp_x1": f"{base}.ff.net.0.proj",
                "mlp_x2": f"{base}.ff.net.2",
                "mlp_c1": f"{base}.ff_context.net.0.proj",
                "mlp_c2": f"{base}.ff_context.net.2",
            }
            if child in ff:
                return (_leaf_name(ff[child], leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- Make-A-Video pseudo-3D UNet (reference unet_pseudo3d.py:27) -------------

_PSEUDO3D_RES = {
    "norm1": ("in_layers.0", None),
    "conv1": ("in_layers.2", _conv2d),
    "t_conv1": ("in_layers_temporal", _conv1d_dense),
    "emb_proj": ("emb_layers.1", _dense),
    "norm2": ("out_layers.0", None),
    "conv2": ("out_layers.3", _conv2d),
    "t_conv2": ("out_layers_temporal", _conv1d_dense),
    "skip": ("skip_connection", _conv2d),
    "t_skip": ("skip_connection_temporal", _conv1d_dense),
}


def import_unet_pseudo3d_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    heads: int = 8,
    dim_head: int = 64,
    strict: bool = True,
) -> nn.Module:
    """Import a reference Make-A-Video pseudo-3D UNet state_dict
    (score_networks/unet_pseudo3d.py:27) into our
    `score_networks.unet_pseudo3d.Unet` tree: per-conv pointwise
    temporal mixers (Conv1d k=1 -> Dense) and fused spatial+temporal
    attention sites."""

    def attn_heads(channels: int) -> int:
        return heads if dim_head == -1 else channels // dim_head

    def qkv_tf(parts):
        return _qkv_layout(parts, attn_heads)

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]

        m = _PROJ_RE.match(top)
        if m:
            name = m.group(1)
            base = f"_projections.{name}"
            if path[1] == "fc1":
                return (_leaf_name(f"{base}._projection.1", leaf), _dense)
            if path[1] == "fc2":
                return (_leaf_name(f"{base}._projection.3", leaf), _dense)
            if path[1] in ("embed", "table"):
                key = (
                    f"{base}.embedding_table.weight"
                    if f"{base}.embedding_table.weight" in sd
                    else f"{base}._projection.weight"
                )
                return (key, _identity)
        if top == "_label_projection":
            return ("_label_projection.weight", _identity)
        if top == "initial_conv":
            return ("_initial_convolution.weight", _conv2d)
        if top == "initial_temporal":
            return ("_initial_temporal_convolution.weight", _conv1d_dense)
        if top == "final_norm":
            return (_leaf_name("final_projection.0", leaf), _identity)
        if top == "final_conv":
            return ("final_projection.2.weight", _conv2d)
        if top == "final_temporal":
            return ("final_projection_temporal.weight", _conv1d_dense)

        m = _STAGE_RE.match(top) or _MIDDLE_RE.match(top)
        if m is None:
            return None
        if m.re is _MIDDLE_RE:
            base = f"middle.{m.group(1)}"
            pyramid = "middle"
        else:
            pyramid, i, j = m.group(1), m.group(2), m.group(3)
            base = f"{pyramid}.{i}.{j}"
        child = path[1]

        if child in _PSEUDO3D_RES:
            suffix, tf = _PSEUDO3D_RES[child]
            if leaf in ("scale", "bias") and tf is None:
                return (_leaf_name(f"{base}.{suffix}", leaf), _identity)
            if leaf == "kernel":
                return (f"{base}.{suffix}.weight", tf)
            return (f"{base}.{suffix}.bias", _identity)
        if child == "spatial":
            sub = path[2]
            if sub == "norm":
                return (_leaf_name(f"{base}._norm", leaf), _identity)
            if sub == "qkv":
                return (_leaf_name(f"{base}._qkv", leaf), qkv_tf(3))
            if sub == "encoder_kv":
                return (_leaf_name(f"{base}._encoder_kv", leaf), qkv_tf(2))
            if sub == "proj_out":
                if leaf == "kernel":
                    return (f"{base}._proj_out.weight", _conv1d_dense)
                return (f"{base}._proj_out.bias", _identity)
            if sub == "context_norm":
                return (f"{base}._context_layer_norm.g",
                        _flat_gain)
        if child == "temporal":
            sub = path[2]
            if sub == "norm":
                return (_leaf_name(f"{base}._norm_temporal", leaf), _identity)
            if sub == "qkv":
                return (_leaf_name(f"{base}._qkv_temporal", leaf), qkv_tf(3))
            if sub == "proj_out":
                if leaf == "kernel":
                    return (f"{base}._proj_out_temporal.weight", _conv1d_dense)
                return (f"{base}._proj_out_temporal.bias", _identity)
            if sub in ("rel_k_embeddings", "rel_v_embeddings"):
                which = "k" if sub == "rel_k_embeddings" else "v"
                return (
                    f"{base}._attention_temporal._{which}_embeddings_table",
                    _identity,
                )
        if child == "conv":
            op = "op" if pyramid == "downs" else "conv"
            if leaf == "kernel":
                return (f"{base}.{op}.weight", _conv3d_spatial)
            return (f"{base}.{op}.bias", _identity)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- FDM factorized-3D UNet (reference unet_factorized3d.py:197) -------------


def import_fdm_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    strict: bool = True,
) -> nn.Module:
    """Import a reference FDM UNet state_dict
    (score_networks/unet_factorized3d.py:197, layers/attention.py:910-1090)
    into our `score_networks.unet_factorized3d.UNet` tree. The reference's
    context-transformer projection params (`_projections.*`,
    `_context_transformers.*`) are dead weights — forward re-embeds the
    timestep itself (:450) — and have no flax counterpart."""

    def rpe_resolve(base: str, path: Tuple[str, ...], leaf: str):
        tf = _dense if leaf == "kernel" else _identity
        child = path[0]
        if child == "norm":
            return (_leaf_name(f"{base}.norm", leaf), _identity)
        if child in ("qkv", "proj_out"):
            return (_leaf_name(f"{base}.{child}", leaf), tf)
        if child in ("rpe_q", "rpe_k", "rpe_v"):
            # RPENet leaves (reference attention.py:910-938).
            return (
                _leaf_name(f"{base}.{child}.rpe_net.{path[1]}", leaf), tf
            )
        return None

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        conv_tf = _conv2d if leaf == "kernel" else _identity
        dense_tf = _dense if leaf == "kernel" else _identity
        if top == "initial_conv":
            return (_leaf_name("input_blocks.0.0", leaf), conv_tf)
        if top == "time_fc1":
            return (_leaf_name("time_embed.0", leaf), dense_tf)
        if top == "time_fc2":
            return (_leaf_name("time_embed.2", leaf), dense_tf)
        if top == "final_norm":
            return (_leaf_name("out.0", leaf), _identity)
        if top == "final_conv":
            return (_leaf_name("out.2", leaf), conv_tf)

        m = _STAGE_RE.match(top) or _MIDDLE_RE.match(top)
        if m is None:
            return None
        if m.re is _MIDDLE_RE:
            base = f"middle_block.{m.group(1)}"
            pyramid = "middle"
        else:
            pyramid, i, j = m.group(1), m.group(2), m.group(3)
            coll = "input_blocks" if pyramid == "downs" else "output_blocks"
            # input_blocks.0 is the initial conv: down stages shift by 1.
            idx = int(i) + 1 if pyramid == "downs" else int(i)
            base = f"{coll}.{idx}.{j}"

        child = path[1]
        if child in _BIGGAN_RES:
            suffix, tf = _BIGGAN_RES[child]
            if leaf in ("scale", "bias") and tf is None:
                return (_leaf_name(f"{base}.{suffix}", leaf), _identity)
            if leaf == "kernel":
                return (f"{base}.{suffix}.weight", tf)
            return (f"{base}.{suffix}.bias", _identity)
        if child in ("temporal_attention", "spatial_attention"):
            return rpe_resolve(f"{base}.{child}", path[2:], leaf)
        if child == "conv":
            op = "op" if pyramid == "downs" else "conv"
            if leaf == "kernel":
                return (f"{base}.{op}.weight", _conv2d)
            return (f"{base}.{op}.bias", _identity)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- Video wrappers: AnimateDiff + Video-LDM ---------------------------------

_MOTION_RE = re.compile(r"^motion_(down|up|middle)(?:_(\d+))?$")
_TT_BLOCK_RE = re.compile(r"^block_(\d+)$")
_TT_NORM_RE = re.compile(r"^norm_(\d+)$")
_TT_ATTN_RE = re.compile(r"^attn_(\d+)$")
_VLDM_RE = re.compile(r"^temporal_(downs|ups|middle)_(\d+)_(conv(\d+)|attn)$")


# torch Conv3d k=(3,1,1) (O, I, 3, 1, 1) -> flax 1D temporal Conv (3, I, O).
_conv3d_temporal = Layout(lambda w: w[:, :, :, 0, 0].transpose(2, 1, 0),
                          lambda w: w.transpose(2, 1, 0)[:, :, :, None, None])


def import_animate_diff_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    heads: int = 8,
    dim_head: int = 64,
    strict: bool = True,
) -> nn.Module:
    """Import a reference AnimateDiffUnet state_dict
    (score_networks/animate_diff.py:201) into our
    `score_networks.animate_diff.Unet` tree: the spatial subtree shares
    the plain image-UNet mapping; motion modules map TemporalTransformer
    leaves (the sequential slot index inside each
    motion_modules_down/up entry is recovered from the state_dict —
    index 1 when the stage has a spatial attention, else 0)."""
    unet_resolve = _make_unet_resolve(sd, heads, dim_head)

    def tt_resolve(base: str, path: Tuple[str, ...], leaf: str):
        tf = _dense if leaf == "kernel" else _identity
        child = path[0]
        if child == "norm":
            return (_leaf_name(f"{base}.norm", leaf), _identity)
        if child in ("proj_in", "proj_out"):
            return (_leaf_name(f"{base}.{child}", leaf), tf)
        m = _TT_BLOCK_RE.match(child)
        if m:
            tb = f"{base}.transformer_blocks.{m.group(1)}"
            sub = path[1]
            m2 = _TT_NORM_RE.match(sub)
            if m2:
                return (
                    _leaf_name(f"{tb}.norms.{m2.group(1)}", leaf), _identity
                )
            m2 = _TT_ATTN_RE.match(sub)
            if m2:
                ab = f"{tb}.attention_blocks.{m2.group(1)}"
                if leaf == "alpha":
                    return (f"{ab}.alpha", _identity)
                return (_leaf_name(f"{ab}.{path[2]}", leaf), _dense)
            if sub == "ff_norm":
                return (_leaf_name(f"{tb}.ff_norm", leaf), _identity)
            if sub == "ff_in":
                return (_leaf_name(f"{tb}.ff.net.0.proj", leaf), tf)
            if sub == "ff_out":
                return (_leaf_name(f"{tb}.ff.net.2", leaf), tf)
        return None

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        m = _MOTION_RE.match(top)
        if m:
            sec, idx = m.group(1), m.group(2)
            if sec == "middle":
                base = "motion_modules_middle.1"
            else:
                coll = f"motion_modules_{sec}"
                k = 1 if f"{coll}.{idx}.1.norm.weight" in sd else 0
                base = f"{coll}.{idx}.{k}"
            return tt_resolve(base, path[1:], leaf)
        return unet_resolve(path)

    return _apply_mapping(module, sd, resolve, strict=strict)


def import_video_ldm_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    heads: int = 8,
    dim_head: int = 64,
    strict: bool = True,
) -> nn.Module:
    """Import a reference VideoLDMUnet state_dict
    (score_networks/video_ldm.py:138) into our
    `score_networks.video_ldm.Unet` tree: spatial subtree via the plain
    image-UNet mapping; Conv3DLayer adapters keep the spatial element
    index (== the reference temporal-sequential slot), temporal
    attention always sits at slot 1."""
    unet_resolve = _make_unet_resolve(sd, heads, dim_head)

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        m = _VLDM_RE.match(top)
        if m is None:
            return unet_resolve(path)
        sec, i, kind, conv_idx = m.groups()
        coll = "temporal_middle" if sec == "middle" else f"temporal_{sec}"
        if sec == "middle":
            slot = "1" if kind == "attn" else conv_idx
            base = f"{coll}.{slot}"
        else:
            slot = "1" if kind == "attn" else conv_idx
            base = f"{coll}.{i}.{slot}"
        if kind == "attn":
            if leaf == "alpha":
                return (f"{base}.alpha", _identity)
            return (_leaf_name(f"{base}.{path[1]}", leaf), _dense)
        # Conv3DLayer
        child = path[1]
        if leaf == "alpha":
            return (f"{base}.alpha", _identity)
        blk = {"block1": "block1", "block2": "block2"}[child.split("_")[0]]
        if child.endswith("_norm"):
            return (_leaf_name(f"{base}.{blk}.0", leaf), _identity)
        if child.endswith("_conv"):
            if leaf == "kernel":
                return (f"{base}.{blk}.2.weight", _conv3d_temporal)
            return (f"{base}.{blk}.2.bias", _identity)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- DiffuSSM (reference score_networks/diffussm.py:16) ----------------------

_DIFFUSSM_LAYER_RE = re.compile(r"^layer_(\d+)$")

# Flax child name -> (torch suffix, MLPEmbedder?) within one block.
_DIFFUSSM_MLP = {
    "condition_embedder": "_condition_embedder",
    "hourglass_mlp": "_hourglass.1",
    "mlp_left": "_mlp_left",
    "mlp_right": "_mlp_right",
    "mlp_final": "_mlp_final",
}
_DIFFUSSM_SEQ_CONV = {
    "hourglass_down": "_hourglass.0",
    "hourglass_up": "_hourglass.2",
    "down_left": "_downscale_left",
    "down_right": "_downscale_right",
    "upscale_final": "_upscale_final",
}


def import_diffussm_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    strict: bool = True,
) -> nn.Module:
    """Import a reference DiffuSSM state_dict
    (score_networks/diffussm.py:16-128, layers/s4d.py:11-113,
    layers/sequence.py:20-145) into our `score_networks.diffussm.
    DiffusionSSM` tree: sequence-axis k=1 Conv1d -> Dense, S4D kernel
    parameters 1:1 (C keeps the torch view_as_real (H, N/2, 2) layout),
    and the GLU output Conv1d -> Dense."""

    def s4d_resolve(base: str, path: Tuple[str, ...], leaf: str):
        # path like ("layer"|"reverse_layer", ...) under the ssm block.
        tower = path[0]
        if leaf in ("log_dt", "log_A_real", "A_imag", "C"):
            return (f"{base}.{tower}.kernel.{leaf}", _identity)
        if leaf == "D":
            return (f"{base}.{tower}.D", _identity)
        if path[1] == "out_proj":
            if leaf == "kernel":
                return (f"{base}.{tower}.output_linear.0.weight",
                        _conv1d_dense)
            return (f"{base}.{tower}.output_linear.0.bias", _identity)
        return None

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        if top == "input_proj":
            return (_leaf_name("_input_proj", leaf), _dense)
        if top == "output_proj":
            return (_leaf_name("_output_proj", leaf), _dense)
        m = _DIFFUSSM_LAYER_RE.match(top)
        if m is None:
            return None
        base = f"_layers.{m.group(1)}"
        child = path[1]
        tf = _dense if leaf == "kernel" else _identity
        if child == "modulation":
            return (_leaf_name(f"{base}._input_modulation.lin", leaf), tf)
        if child in _DIFFUSSM_MLP:
            return (
                _leaf_name(
                    f"{base}.{_DIFFUSSM_MLP[child]}.{path[2]}", leaf
                ),
                tf,
            )
        if child in _DIFFUSSM_SEQ_CONV:
            if leaf == "kernel":
                return (f"{base}.{_DIFFUSSM_SEQ_CONV[child]}.weight",
                        _conv1d_dense)
            return (f"{base}.{_DIFFUSSM_SEQ_CONV[child]}.bias", _identity)
        if child == "ssm":
            sub = path[2]
            if sub == "norm":
                # Normalization wrapper around a LayerNorm
                # (reference layers/utils.py:439-456).
                return (_leaf_name(f"{base}._ssm.norm.norm", leaf),
                        _identity)
            if sub == "bidirectional_linear":
                return (
                    _leaf_name(f"{base}._ssm.bidirectional_linear", leaf),
                    tf,
                )
            if sub in ("layer", "reverse_layer"):
                return s4d_resolve(f"{base}._ssm", path[2:], leaf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- Sora STDiT3 (reference score_networks/sora.py:182) ----------------------

_SORA_BLOCK_RE = re.compile(r"^(spatial|temporal)_(\d+)$")


def import_sora_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference Sora (OpenSora STDiT3) state_dict into our
    `score_networks.sora.Sora` param tree.

    PatchEmbed3D's Conv3d (kernel == stride == patch) becomes our Dense
    over the flattened (c, pt, ph, pw) patch features; everything else is
    Linear->Dense transposes plus the per-block scale_shift_table params.
    The torch tree's rope.freqs / fps_embedder / y_embedding buffers have
    no flax counterpart (we compute rope deterministically and don't ship
    the fps conditioner) and are left unread.
    """
    patch = _patch_dense(_patch_kernel(module.x_embedder, module._patch))

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        if top == "x_embedder":
            if leaf == "kernel":
                return ("x_embedder.proj.weight", patch)
            return ("x_embedder.proj.bias", _identity)
        if top == "t_fc1":
            return (_leaf_name("t_embedder.mlp.0", leaf), tf)
        if top == "t_fc2":
            return (_leaf_name("t_embedder.mlp.2", leaf), tf)
        if top == "t_block":
            return (_leaf_name("t_block.1", leaf), tf)
        if top == "y_fc1":
            return (_leaf_name("y_embedder.y_proj.fc1", leaf), tf)
        if top == "y_fc2":
            return (_leaf_name("y_embedder.y_proj.fc2", leaf), tf)
        if top == "final_proj":
            return (_leaf_name("final_layer.linear", leaf), tf)
        if top == "final_scale_shift_table":
            return ("final_layer.scale_shift_table", _identity)

        m = _SORA_BLOCK_RE.match(top)
        if m:
            base = f"{m.group(1)}_blocks.{m.group(2)}"
            child = path[1]
            if child == "scale_shift_table":
                return (f"{base}.scale_shift_table", _identity)
            if child == "attn":
                sub = path[2]
                if sub in ("q_norm", "k_norm"):
                    return (f"{base}.attn.{sub}.weight", _identity)
                return (_leaf_name(f"{base}.attn.{sub}", leaf), tf)
            if child == "cross_attn":
                sub = path[2]
                smap = {"q": "q_linear", "kv": "kv_linear", "proj": "proj"}
                if sub in smap:
                    return (
                        _leaf_name(f"{base}.cross_attn.{smap[sub]}", leaf), tf
                    )
            if child == "mlp1":
                return (_leaf_name(f"{base}.mlp.fc1", leaf), tf)
            if child == "mlp2":
                return (_leaf_name(f"{base}.mlp.fc2", leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- LTX-Video (reference score_networks/ltx_video.py:56) --------------------

_LTX_BLOCK_RE = re.compile(r"^block_(\d+)$")


def import_ltx_video_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference LTXVideoTransformer state_dict into our
    `score_networks.ltx_video.LTXVideoTransformer` param tree. Separate
    to_q/to_k/to_v (and cross to_k/to_v) Linears concatenate into our
    fused Dense kernels; qk RMSNorm weights map 1:1."""

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        tops = {
            "proj_in": "patchify_proj",
            "t_fc1": "adaln_single.emb.timestep_embedder.linear_1",
            "t_fc2": "adaln_single.emb.timestep_embedder.linear_2",
            "t_block": "adaln_single.linear",
            "caption_fc1": "caption_projection.linear_1",
            "caption_fc2": "caption_projection.linear_2",
            "proj_out": "proj_out",
        }
        if top in tops:
            return (_leaf_name(tops[top], leaf), tf)
        if top == "scale_shift_table":
            return ("scale_shift_table", _identity)

        m = _LTX_BLOCK_RE.match(top)
        if m:
            base = f"transformer_blocks.{m.group(1)}"
            child = path[1]
            if child == "scale_shift_table":
                return (f"{base}.scale_shift_table", _identity)
            if child == "qkv":
                keys = [f"{base}.attn1.to_q", f"{base}.attn1.to_k",
                        f"{base}.attn1.to_v"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "cross_kv":
                keys = [f"{base}.attn2.to_k", f"{base}.attn2.to_v"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            sub = {
                "q_norm": (f"{base}.attn1.q_norm.weight", _identity),
                "k_norm": (f"{base}.attn1.k_norm.weight", _identity),
                "cross_q_norm": (f"{base}.attn2.q_norm.weight", _identity),
                "cross_k_norm": (f"{base}.attn2.k_norm.weight", _identity),
            }
            if child in sub:
                return sub[child]
            lin = {
                "attn_proj": f"{base}.attn1.to_out.0",
                "cross_q": f"{base}.attn2.to_q",
                "cross_proj": f"{base}.attn2.to_out.0",
                "ff1": f"{base}.ff.net.0.proj",
                "ff2": f"{base}.ff.net.2",
            }
            if child in lin:
                return (_leaf_name(lin[child], leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- Flux (reference score_networks/flux.py:41) ------------------------------


def import_flux_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference Flux state_dict into our
    `score_networks.flux.Flux` param tree (double/single stream blocks,
    QKNorm rms weights, MLPEmbedders, LastLayer)."""

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        if top in ("img_in", "txt_in"):
            return (_leaf_name(top, leaf), tf)
        if top in ("time_in", "vector_in", "guidance_in"):
            sub = {"in_layer": f"{top}.in_layer", "out_layer": f"{top}.out_layer"}
            return (_leaf_name(sub[path[1]], leaf), tf)
        if top == "final":
            if path[1] == "mod":
                return (_leaf_name("final_layer.adaLN_modulation.1", leaf), tf)
            if path[1] == "proj":
                return (_leaf_name("final_layer.linear", leaf), tf)
            if path[1] == "norm":
                # DyT variant only (reference layers/flux_dyt.py:318).
                return _dyt_resolve("final_layer.norm_final", leaf)

        m = _HY_DOUBLE_RE.match(top)
        if m:
            base = f"double_blocks.{m.group(1)}"
            child = path[1]
            if child in ("img_mod", "txt_mod"):
                return (_leaf_name(f"{base}.{child}.lin", leaf), tf)
            qk = {
                "img_q_norm": f"{base}.img_attn.norm.query_norm",
                "img_k_norm": f"{base}.img_attn.norm.key_norm",
                "txt_q_norm": f"{base}.txt_attn.norm.query_norm",
                "txt_k_norm": f"{base}.txt_attn.norm.key_norm",
            }
            if child in qk:
                if leaf == "scale":  # vanilla Flux RMSNorm
                    return (f"{qk[child]}.scale", _identity)
                return _dyt_resolve(qk[child], leaf)  # flux_dyt
            if child in ("img_norm1", "img_norm2", "txt_norm1", "txt_norm2"):
                # DyT variant only (reference layers/flux_dyt.py:163-181;
                # vanilla Flux block norms are parameterless LayerNorms).
                return _dyt_resolve(f"{base}.{child}", leaf)
            lin = {
                "img_qkv": f"{base}.img_attn.qkv",
                "img_proj": f"{base}.img_attn.proj",
                "img_mlp1": f"{base}.img_mlp.0",
                "img_mlp2": f"{base}.img_mlp.2",
                "txt_qkv": f"{base}.txt_attn.qkv",
                "txt_proj": f"{base}.txt_attn.proj",
                "txt_mlp1": f"{base}.txt_mlp.0",
                "txt_mlp2": f"{base}.txt_mlp.2",
            }
            if child in lin:
                return (_leaf_name(lin[child], leaf), tf)
        m = _HY_SINGLE_RE.match(top)
        if m:
            base = f"single_blocks.{m.group(1)}"
            child = path[1]
            if child == "modulation":
                return (_leaf_name(f"{base}.modulation.lin", leaf), tf)
            if child in ("q_norm", "k_norm"):
                which = "query_norm" if child == "q_norm" else "key_norm"
                if leaf == "scale":  # vanilla Flux RMSNorm
                    return (f"{base}.norm.{which}.scale", _identity)
                return _dyt_resolve(f"{base}.norm.{which}", leaf)  # flux_dyt
            if child == "pre_norm":
                # DyT variant only (reference layers/flux_dyt.py:282).
                return _dyt_resolve(f"{base}.pre_norm", leaf)
            if child in ("linear1", "linear2"):
                return (_leaf_name(f"{base}.{child}", leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- WideFormer (reference score_networks/wideformer.py:55) ------------------

_WF_BLOCK_RE = re.compile(r"^layer(\d+)_block(\d+)$")
# torch Conv1d (O, I, 3) -> flax (3, I, O).
_conv1d = _transpose((2, 1, 0))


def import_wideformer_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference WideFormer state_dict into our
    `score_networks.wideformer.WideFormer` tree: width x depth flux
    double-stream blocks + Conv1d token mixers."""

    def _double_block(base: str, path: Tuple[str, ...], leaf: str):
        """Map one flux DoubleStreamBlock child (shared with
        import_flux_params' table)."""
        tf = _dense if leaf == "kernel" else _identity
        child = path[0]
        if child in ("img_mod", "txt_mod"):
            return (_leaf_name(f"{base}.{child}.lin", leaf), tf)
        norms = {
            "img_q_norm": f"{base}.img_attn.norm.query_norm.scale",
            "img_k_norm": f"{base}.img_attn.norm.key_norm.scale",
            "txt_q_norm": f"{base}.txt_attn.norm.query_norm.scale",
            "txt_k_norm": f"{base}.txt_attn.norm.key_norm.scale",
        }
        if child in norms:
            return (norms[child], _identity)
        lin = {
            "img_qkv": f"{base}.img_attn.qkv",
            "img_proj": f"{base}.img_attn.proj",
            "img_mlp1": f"{base}.img_mlp.0",
            "img_mlp2": f"{base}.img_mlp.2",
            "txt_qkv": f"{base}.txt_attn.qkv",
            "txt_proj": f"{base}.txt_attn.proj",
            "txt_mlp1": f"{base}.txt_mlp.0",
            "txt_mlp2": f"{base}.txt_mlp.2",
        }
        if child in lin:
            return (_leaf_name(lin[child], leaf), tf)
        return None

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        if top in ("img_in", "txt_in"):
            return (_leaf_name(top, leaf), tf)
        if top in ("time_in", "vector_in", "guidance_in"):
            sub = {"in_layer": f"{top}.in_layer", "out_layer": f"{top}.out_layer"}
            return (_leaf_name(sub[path[1]], leaf), tf)
        if top == "final":
            if path[1] == "mod":
                return (_leaf_name("final_layer.adaLN_modulation.1", leaf), tf)
            if path[1] == "proj":
                return (_leaf_name("final_layer.linear", leaf), tf)

        m = _WF_BLOCK_RE.match(top)
        base = None
        if m:
            base = f"transformer_channels.{m.group(1)}.{m.group(2)}"
        elif top == "final_block":
            base = "transformer_final"
        if base is None:
            return None
        if path[1] == "token_mixer":
            if leaf == "kernel":
                return (f"{base}._token_mixer.weight", _conv1d)
            return (f"{base}._token_mixer.bias", _identity)
        if path[1] == "block":
            return _double_block(f"{base}._transformer_block", path[2:], leaf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- Chewie (reference score_networks/chewie.py:38) --------------------------


def import_chewie_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference Chewie state_dict into our
    `score_networks.chewie.Chewie` tree: PoolFormer double-stream blocks
    (no qkv — modulations, per-stream projections and MLPs only) plus the
    Flux skeleton."""

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        if top in ("img_in", "txt_in"):
            return (_leaf_name(top, leaf), tf)
        if top in ("time_in", "vector_in", "guidance_in"):
            sub = {"in_layer": f"{top}.in_layer", "out_layer": f"{top}.out_layer"}
            return (_leaf_name(sub[path[1]], leaf), tf)
        if top == "final":
            if path[1] == "mod":
                return (_leaf_name("final_layer.adaLN_modulation.1", leaf), tf)
            if path[1] == "proj":
                return (_leaf_name("final_layer.linear", leaf), tf)

        m = _HY_DOUBLE_RE.match(top)
        if m:
            base = f"double_blocks.{m.group(1)}"
            child = path[1]
            if child in ("img_mod", "txt_mod"):
                return (_leaf_name(f"{base}.{child}.lin", leaf), tf)
            lin = {
                "img_proj": f"{base}.img_proj",
                "img_mlp1": f"{base}.img_mlp.0",
                "img_mlp2": f"{base}.img_mlp.2",
                "txt_proj": f"{base}.txt_proj",
                "txt_mlp1": f"{base}.txt_mlp.0",
                "txt_mlp2": f"{base}.txt_mlp.2",
            }
            if child in lin:
                return (_leaf_name(lin[child], leaf), tf)
        m = _HY_SINGLE_RE.match(top)
        if m:
            base = f"single_blocks.{m.group(1)}"
            child = path[1]
            if child == "modulation":
                return (_leaf_name(f"{base}.modulation.lin", leaf), tf)
            if child == "q_norm":
                return (f"{base}.norm.query_norm.scale", _identity)
            if child == "k_norm":
                return (f"{base}.norm.key_norm.scale", _identity)
            if child in ("linear1", "linear2"):
                return (_leaf_name(f"{base}.{child}", leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- HunyuanVideo (reference score_networks/hunyuan_video.py:404) ------------

_HY_DOUBLE_RE = re.compile(r"^double_(\d+)$")
_HY_SINGLE_RE = re.compile(r"^single_(\d+)$")
_HY_REFINER_IDX_RE = re.compile(r"^(adaLN|norm1|qkv|proj|norm2|mlp1|mlp2)_(\d+)$")


def import_hunyuan_video_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference HYVideoDiffusionTransformer state_dict into our
    `score_networks.hunyuan_video.HYVideoDiffusionTransformer` tree —
    covering the SingleTokenRefiner, MM double/single stream blocks
    (which our implementation shares with Flux), and the final layer."""
    patch = _patch_dense(_patch_kernel(module.img_in, module._patch))

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        if top == "img_in":
            if leaf == "kernel":
                return ("img_in.proj.weight", patch)
            return ("img_in.proj.bias", _identity)
        if top == "time_in":
            sub = {"in_layer": "time_in.mlp.0", "out_layer": "time_in.mlp.2"}
            return (_leaf_name(sub[path[1]], leaf), tf)
        if top == "vector_in":
            sub = {"in_layer": "vector_in.in_layer",
                   "out_layer": "vector_in.out_layer"}
            return (_leaf_name(sub[path[1]], leaf), tf)
        if top == "txt_refiner":
            child = path[1]
            fixed = {
                "t_fc1": "txt_in.t_embedder.mlp.0",
                "t_fc2": "txt_in.t_embedder.mlp.2",
                "c_fc1": "txt_in.c_embedder.linear_1",
                "c_fc2": "txt_in.c_embedder.linear_2",
                "input_embedder": "txt_in.input_embedder",
            }
            if child in fixed:
                return (_leaf_name(fixed[child], leaf), tf)
            m = _HY_REFINER_IDX_RE.match(child)
            if m:
                kind, i = m.group(1), m.group(2)
                base = f"txt_in.individual_token_refiner.blocks.{i}"
                kmap = {
                    "adaLN": f"{base}.adaLN_modulation.1",
                    "norm1": f"{base}.norm1",
                    "qkv": f"{base}.self_attn_qkv",
                    "proj": f"{base}.self_attn_proj",
                    "norm2": f"{base}.norm2",
                    "mlp1": f"{base}.mlp.fc1",
                    "mlp2": f"{base}.mlp.fc2",
                }
                return (_leaf_name(kmap[kind], leaf), tf)
        if top == "final":
            if path[1] == "mod":
                return (_leaf_name("final_layer.adaLN_modulation.1", leaf), tf)
            if path[1] == "proj":
                return (_leaf_name("final_layer.linear", leaf), tf)

        m = _HY_DOUBLE_RE.match(top)
        if m:
            base = f"double_blocks.{m.group(1)}"
            child = path[1]
            if child in ("img_mod", "txt_mod"):
                return (_leaf_name(f"{base}.{child}.linear", leaf), tf)
            norms = {
                "img_q_norm": f"{base}.img_attn_q_norm.weight",
                "img_k_norm": f"{base}.img_attn_k_norm.weight",
                "txt_q_norm": f"{base}.txt_attn_q_norm.weight",
                "txt_k_norm": f"{base}.txt_attn_k_norm.weight",
            }
            if child in norms:
                return (norms[child], _identity)
            lin = {
                "img_qkv": f"{base}.img_attn_qkv",
                "img_proj": f"{base}.img_attn_proj",
                "img_mlp1": f"{base}.img_mlp.fc1",
                "img_mlp2": f"{base}.img_mlp.fc2",
                "txt_qkv": f"{base}.txt_attn_qkv",
                "txt_proj": f"{base}.txt_attn_proj",
                "txt_mlp1": f"{base}.txt_mlp.fc1",
                "txt_mlp2": f"{base}.txt_mlp.fc2",
            }
            if child in lin:
                return (_leaf_name(lin[child], leaf), tf)
        m = _HY_SINGLE_RE.match(top)
        if m:
            base = f"single_blocks.{m.group(1)}"
            child = path[1]
            if child == "modulation":
                return (_leaf_name(f"{base}.modulation.linear", leaf), tf)
            if child in ("q_norm", "k_norm"):
                return (f"{base}.{child}.weight", _identity)
            if child in ("linear1", "linear2"):
                return (_leaf_name(f"{base}.{child}", leaf), tf)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- Sana (reference score_networks/sana.py:222) -----------------------------

_SANA_BLOCK_RE = re.compile(r"^block_(\d+)$")


def import_sana_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference SanaScoreNetwork state_dict into our
    `score_networks.sana.SanaScoreNetwork` tree: linear-attention blocks
    with GLUMBConv Mix-FFN, AdaLayerNormSingle conditioning, PixArt-style
    caption projection + rms caption norm."""

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        if top == "patch_embed":
            return (
                _leaf_name("patch_embed.proj", leaf),
                _conv2d if leaf == "kernel" else _identity,
            )
        if top == "t_embed":
            sub = {
                "fc1": "time_embed.emb.timestep_embedder.linear_1",
                "fc2": "time_embed.emb.timestep_embedder.linear_2",
            }
            return (_leaf_name(sub[path[1]], leaf), tf)
        if top == "t_block":
            return (_leaf_name("time_embed.linear", leaf), tf)
        if top == "caption_fc1":
            return (_leaf_name("caption_projection.linear_1", leaf), tf)
        if top == "caption_fc2":
            return (_leaf_name("caption_projection.linear_2", leaf), tf)
        if top == "caption_norm":
            return ("caption_norm.weight", _identity)
        if top == "final_scale_shift_table":
            return ("scale_shift_table", _identity)
        if top == "final_proj":
            return (_leaf_name("proj_out", leaf), tf)

        m = _SANA_BLOCK_RE.match(top)
        if m:
            base = f"transformer_blocks.{m.group(1)}"
            child = path[1]
            if child == "scale_shift_table":
                return (f"{base}.scale_shift_table", _identity)
            if child == "qkv":
                keys = [f"{base}.attn1.to_q", f"{base}.attn1.to_k",
                        f"{base}.attn1.to_v"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "cross_kv":
                keys = [f"{base}.cross_attn.to_k", f"{base}.cross_attn.to_v"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            lin = {
                "attn_proj": f"{base}.attn1.to_out.0",
                "cross_q": f"{base}.cross_attn.to_q",
                "cross_proj": f"{base}.cross_attn.to_out.0",
            }
            if child in lin:
                return (_leaf_name(lin[child], leaf), tf)
            if child == "mix_ffn":
                conv = path[2]
                key = f"{base}.ff.{conv}"
                if leaf == "kernel":
                    return (f"{key}.weight", _conv2d)
                return (f"{key}.bias", _identity)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- AuraFlow (reference score_networks/auraflow.py:18) ----------------------

_AF_MMDIT_RE = re.compile(r"^mmdit_(\d+)$")
_AF_SINGLE_RE = re.compile(r"^single_(\d+)$")


def import_auraflow_params(
    module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import a reference AuraFlow state_dict into our
    `score_networks.auraflow.AuraFlow` tree (bias-free joint/single
    blocks, SwiGLU FFs, learned positional table, register tokens)."""

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        tf = _dense if leaf == "kernel" else _identity

        tops = {
            "patch_proj": "pos_embed.proj",
            "context_embedder": "context_embedder",
            "t_fc1": "time_step_proj.linear_1",
            "t_fc2": "time_step_proj.linear_2",
            "final_mod": "norm_out.linear",
            "final_proj": "proj_out",
        }
        if top in tops:
            return (_leaf_name(tops[top], leaf), tf)
        if top == "pos_embed":
            return ("pos_embed.pos_embed", _identity)
        if top == "register_tokens":
            return ("register_tokens", _identity)

        def ff_map(flax_ff, torch_ff, sub):
            names = {"linear_1", "linear_2", "out_projection"}
            if sub in names:
                return (_leaf_name(f"{torch_ff}.{sub}", leaf), tf)
            return None

        m = _AF_MMDIT_RE.match(top)
        if m:
            base = f"joint_transformer_blocks.{m.group(1)}"
            child = path[1]
            if child == "mod_x":
                return (_leaf_name(f"{base}.norm1.linear", leaf), tf)
            if child == "mod_c":
                return (_leaf_name(f"{base}.norm1_context.linear", leaf), tf)
            if child == "qkv_x":
                keys = [f"{base}.attn.to_q", f"{base}.attn.to_k",
                        f"{base}.attn.to_v"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "qkv_c":
                keys = [f"{base}.attn.add_q_proj", f"{base}.attn.add_k_proj",
                        f"{base}.attn.add_v_proj"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "proj_x":
                return (_leaf_name(f"{base}.attn.to_out.0", leaf), tf)
            if child == "proj_c":
                return (_leaf_name(f"{base}.attn.to_add_out", leaf), tf)
            if child == "ff_x":
                return ff_map(child, f"{base}.ff", path[2])
            if child == "ff_c":
                return ff_map(child, f"{base}.ff_context", path[2])
        m = _AF_SINGLE_RE.match(top)
        if m:
            base = f"single_transformer_blocks.{m.group(1)}"
            child = path[1]
            if child == "mod":
                return (_leaf_name(f"{base}.norm1.linear", leaf), tf)
            if child == "qkv":
                keys = [f"{base}.attn.to_q", f"{base}.attn.to_k",
                        f"{base}.attn.to_v"]
                return (MULTI, _concat_dense(keys, bias=leaf == "bias"))
            if child == "proj":
                return (_leaf_name(f"{base}.attn.to_out.0", leaf), tf)
            if child == "ff":
                return ff_map(child, f"{base}.ff", path[2])
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- Efficient UNet (reference score_networks/efficient_unet.py:35) ----------

_EFF_DOWN_RE = re.compile(r"^down_(\d+)$")
_EFF_UP_RE = re.compile(r"^up_(\d+)$")
_EFF_RES_RE = re.compile(r"^res_(\d+)$")


def import_efficient_unet_params(
    module: nn.Module,
    sd: Dict[str, Array],
    *,
    heads: int = 8,
    dim_head: int = 64,
    n_levels: int,
    strict: bool = True,
) -> nn.Module:
    """Import a reference Imagen Efficient UNet state_dict into our
    `score_networks.efficient_unet.Unet` tree: per-level DBlock/UBlock
    (down-first/up-last), scaled-skip residual blocks, per-level
    attention. Our up blocks are named by LEVEL while the torch ups list
    is in reverse-level order — `n_levels` maps between them."""

    def attn_heads(channels: int) -> int:
        return heads if dim_head == -1 else channels // dim_head

    _RES_TABLE = {
        "norm1": "_resnet_path.0",
        "conv1": "_resnet_path.2",
        "norm2": "_resnet_path.3",
        "conv2": "_resnet_path.6",
        "skip": "_skip_connection",
    }

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]

        m = _PROJ_RE.match(top)
        if m:
            name = m.group(1)
            base = f"_projections.{name}"
            if path[1] == "fc1":
                return (_leaf_name(f"{base}._projection.1", leaf), _dense)
            if path[1] == "fc2":
                return (_leaf_name(f"{base}._projection.3", leaf), _dense)
            if path[1] in ("embed", "table"):
                key = (
                    f"{base}.embedding_table.weight"
                    if f"{base}.embedding_table.weight" in sd
                    else f"{base}._projection.weight"
                )
                return (key, _identity)
        if top == "_label_projection":
            return ("_label_projection.weight", _identity)
        if top == "initial_conv":
            return ("_initial_convolution.weight", _conv2d)
        if top == "final_norm":
            return (_leaf_name("final_projection.0", leaf), _identity)
        if top == "final_conv":
            return ("final_projection.2.weight", _conv2d)

        m = _EFF_DOWN_RE.match(top)
        base = None
        if m:
            base = f"downs.{m.group(1)}"
        else:
            m = _EFF_UP_RE.match(top)
            if m:
                base = f"ups.{n_levels - 1 - int(m.group(1))}"
        if base is None:
            return None
        child = path[1]
        if child == "down_conv":
            return (
                _leaf_name(f"{base}._downsampling_convolution", leaf), _conv2d
                if leaf == "kernel" else _identity,
            )
        if child == "up_conv":
            return (
                _leaf_name(f"{base}._upsample.conv", leaf),
                _conv2d if leaf == "kernel" else _identity,
            )
        if child == "emb_proj":
            return (
                _leaf_name(f"{base}._embedding_layers.1", leaf),
                _dense if leaf == "kernel" else _identity,
            )
        rm = _EFF_RES_RE.match(child)
        if rm:
            sub = _RES_TABLE[path[2]]
            key = f"{base}._resnet_blocks.{rm.group(1)}.{sub}"
            if leaf == "kernel":
                return (f"{key}.weight", _conv2d)
            return (_leaf_name(key, leaf), _identity)
        if child == "attn":
            abase = f"{base}._attention"
            sub = path[2]
            if sub == "norm":
                return (_leaf_name(f"{abase}._norm", leaf), _identity)
            if sub in ("qkv", "encoder_kv"):
                parts = 3 if sub == "qkv" else 2
                return (_leaf_name(f"{abase}._{sub}", leaf), _qkv_layout(parts, attn_heads))
            if sub == "proj_out":
                if leaf == "kernel":
                    return (f"{abase}._proj_out.weight", _conv1d_dense)
                return (f"{abase}._proj_out.bias", _identity)
            if sub == "context_norm":
                # ChanLayerNorm: gain-only param `g` of shape (C, 1).
                return (
                    f"{abase}._context_layer_norm.g",
                    _flat_gain,
                )
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- dispatch ----------------------------------------------------------------


def import_score_network_params(
    config: Any, module: nn.Module, sd: Dict[str, Array], *, strict: bool = True
) -> nn.Module:
    """Import `sd` into `module`, the port's score network named by
    `config.diffusion.score_network.target` (reference dotted path), in
    place; returns it."""
    target = config.diffusion.score_network.target
    if target.endswith("efficient_unet.Unet"):
        p = config.diffusion.score_network.params
        layer = p.conditioning.context_transformer_layer.get("params", {})
        return import_efficient_unet_params(
            module,
            sd,
            heads=int(layer.get("heads", 8)),
            dim_head=int(layer.get("dim_head", 64)),
            n_levels=len(list(p.channel_multipliers)),
            strict=strict,
        )
    if target.endswith("unet_pseudo3d.Unet"):
        cond = config.diffusion.score_network.params.conditioning
        p = cond.spatial_and_temporal_context_transformer_layer.get(
            "params", {}
        )
        return import_unet_pseudo3d_params(
            module,
            sd,
            heads=int(p.get("heads", 8)),
            dim_head=int(p.get("dim_head", 64)),
            strict=strict,
        )
    if target.endswith("diffussm.DiffusionSSM"):
        return import_diffussm_params(module, sd, strict=strict)
    if target.endswith("unet_factorized3d.UNet"):
        return import_fdm_params(module, sd, strict=strict)
    if target.endswith(("animate_diff.AnimateDiffUnet", "animate_diff.Unet",
                        "video_ldm.VideoLDMUnet", "video_ldm.Unet")):
        scfg = config.diffusion.score_network.params.spatial_score_network
        p = scfg.conditioning.context_transformer_layer.get("params", {})
        fn = (
            import_animate_diff_params
            if "animate_diff" in target
            else import_video_ldm_params
        )
        return fn(
            module,
            sd,
            heads=int(p.get("heads", 8)),
            dim_head=int(p.get("dim_head", 64)),
            strict=strict,
        )
    if target.endswith("unet_3d.Unet"):
        cond = config.diffusion.score_network.params.conditioning
        p = cond.spatial_context_transformer_layer.get("params", {})
        return import_unet3d_params(
            module,
            sd,
            heads=int(p.get("heads", 8)),
            dim_head=int(p.get("dim_head", 64)),
            strict=strict,
        )
    if target.endswith(".Unet") and "unet" in target:
        layer = config.diffusion.score_network.params.conditioning.context_transformer_layer
        p = layer.get("params", {})
        return import_unet_params(
            module,
            sd,
            heads=int(p.get("heads", 8)),
            dim_head=int(p.get("dim_head", 64)),
            strict=strict,
        )
    if target.endswith(".DiT"):
        return import_dit_params(module, sd, strict=strict)
    if target.endswith(".PixArtAlpha") or target.endswith(".DyTScoreNetwork"):
        return import_pixart_params(module, sd, strict=strict)
    if target.endswith(".SD3Transformer2DModel") or target.endswith(
        ".SD35Transformer2DModel"
    ):
        return import_sd3_params(module, sd, strict=strict)
    if target.endswith("sora.Sora"):
        return import_sora_params(module, sd, strict=strict)
    if target.endswith("flux.Flux") or target.endswith("flux_dyt.Flux"):
        return import_flux_params(module, sd, strict=strict)
    if target.endswith("chewie.Chewie"):
        return import_chewie_params(module, sd, strict=strict)
    if target.endswith(".WideFormer"):
        return import_wideformer_params(module, sd, strict=strict)
    if target.endswith(".SanaScoreNetwork"):
        return import_sana_params(module, sd, strict=strict)
    if target.endswith(".AuraFlow"):
        return import_auraflow_params(module, sd, strict=strict)
    if target.endswith(".LTXVideoTransformer"):
        return import_ltx_video_params(module, sd, strict=strict)
    if target.endswith(".HYVideoDiffusionTransformer"):
        return import_hunyuan_video_params(module, sd, strict=strict)
    if target.endswith("Precond"):
        # EDM preconditioner wrappers hold the backbone under `.model`
        # (reference score_networks/edm.py:402-697).
        inner = config.diffusion.score_network.params.model.target
        sub = strip_prefix(sd, "model.") or sd
        from xdiffusion_tpu_torch.importers.edm import import_edm_unet_params

        arch = "adm" if inner.endswith("DhariwalUNet") else "song"
        import_edm_unet_params(module.model, sub, arch=arch, strict=strict)
        return module
    raise NotImplementedError(f"no torch importer for {target}")
