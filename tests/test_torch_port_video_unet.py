"""The video UNets' layers and networks in the port against the JAX package
on the CPU, with the same seeded weights (flax shapes from `jax.eval_shape`,
`random_flax_params`, the bridge) and the same inputs, made with numpy from
a seed:

- `interleaved_frame_position_encoding`; `FastGroupNorm` with shared-frame
  statistics in its three forms (its coefficients also against JAX's
  `group_norm_coefficients` on the unfolded view); `ResnetBlockBigGAN` with
  the Mlp conditioning stack and shared-frame statistics (scale-shift
  through K4's plain version, additive through the unfused conv2), its
  resampling forms, and `ResnetBlockDDPM`; image and video UNets with DDPM
  blocks and resblock_updown;
- `TemporalSelfAttention` on both position branches (arange and explicit
  frame indices) with F different from the head dim and offsets clipped,
  `SpatialAndTemporalCrossAttention` with a caption, Video-LDM's
  `Conv3DLayer` and `TemporalAttentionLayer` (cross and self),
  AnimateDiff's `MotionSelfAttention` (K5's plain version);
- the four video networks' forwards on their fixtures
  (tests/fixtures/{video_trajectory,make_a_video,video_ldm,animate_diff}
  _parity.yaml), the loss and every gradient of `unet_3d` and
  `animate_diff` with injected timesteps and noise against jitted
  `jax.value_and_grad` (the unused `rel_v_embeddings` take no gradient in
  the port and a zero one in JAX); K5's dispatch in chunks beyond its
  grid's batch limit.

Tolerances: fp32 throughout, sums in other orders; layers 1e-5 of the
output's scale, networks 2e-5, gradients `GRAD_TOL` (1e-4 of each
gradient's largest magnitude, floored at 1e-3 of the network's; one below
that floor, which vanishes in exact arithmetic, to 1e-3 of the floor)."""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import GRAD_TOL, _flat, _grad_errors, _tree

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
VIDEO = os.path.join(REPO, "configs", "video", "moving_mnist")
NETWORKS = {  # fixture -> (spatial size, takes text tokens)
    "video_trajectory_parity": (8, False),
    "make_a_video_parity": (16, True),
    "video_ldm_parity": (16, True),
    "animate_diff_parity": (16, True),
}


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, np.abs(want).max()), rtol=0)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    def conv(v):
        t = torch.from_numpy(np.asarray(v))
        return t.long() if t.dtype == torch.int32 else t
    return jax.tree_util.tree_map(conv, tree)


def _shared(jmod, pmod, *args, seed=0, jax_kwargs=None):
    """(JAX output, port output) of a flax module and its port counterpart
    on the same seeded weights and numpy inputs `args` (dicts allowed)."""
    jax_kwargs = jax_kwargs or {}
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *_jnp(args), **jax_kwargs)
    drawn = random_flax_params(_flat(shapes["params"]), seed=seed)
    want = jax.jit(functools.partial(jmod.apply, **jax_kwargs))(
        {"params": _tree(drawn)}, *_jnp(args))
    load_flax_params(pmod, drawn)
    pmod.eval()
    with torch.no_grad():
        got = pmod(*_torch(args))
    return want, got


# ---- small pieces ------------------------------------------------------------------


@pytest.mark.parametrize("length,dim", [(16, 64), (4, 32), (7, 10)])
def test_interleaved_frame_position_encoding_matches_jax(length, dim):
    from xdiffusion_tpu.layers.embedding import interleaved_frame_position_encoding as jax_pe

    from xdiffusion_tpu_torch.layers.embedding import interleaved_frame_position_encoding

    got = interleaved_frame_position_encoding(length, dim)
    assert got.dtype == torch.float32
    _close(got, jax_pe(length, dim), 1e-6)


@pytest.mark.parametrize("form", ["plain", "scale_shift", "coefficients"])
def test_fast_group_norm_with_shared_frame_statistics_matches_jax(form):
    """FastGroupNorm(stat_frames=4) on a folded (2*4, 6, 6, 64) map: the
    plain form with SiLU, the scale-shift form (per-frame conditioning) and
    the coefficients; and the coefficients equal JAX's
    `group_norm_coefficients` of the unfolded (2, 4, 6, 6, 64) view, each
    repeated over the frames. 1e-5."""
    from xdiffusion_tpu.layers.resnet import FastGroupNorm as JaxNorm
    from xdiffusion_tpu.ops.norm import group_norm_coefficients

    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm

    rng = np.random.default_rng(1)
    x = _normal(rng, 8, 6, 6, 64) * 2 + 0.5
    args = (x,)
    kwargs = {}
    if form == "scale_shift":
        kwargs = dict(t_scale=_normal(rng, 8, 1, 1, 64) * 0.3, t_shift=_normal(rng, 8, 1, 1, 64))
    if form == "coefficients":
        kwargs["return_coefficients"] = True
    jmod = JaxNorm(num_groups=32, silu=True, stat_frames=4)
    pmod = FastGroupNorm(64, 32, silu=True, stat_frames=4)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    drawn = random_flax_params(_flat(shapes["params"]), seed=2)
    want = jmod.apply({"params": _tree(drawn)}, *_jnp(args), **_jnp(kwargs))
    load_flax_params(pmod, drawn)
    with torch.no_grad():
        got = pmod(*_torch(args), **_torch(kwargs))
    if form == "coefficients":
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
        a, off = group_norm_coefficients(jnp.asarray(x.reshape(2, 4, 6, 6, 64)),
                                         jnp.asarray(drawn["scale"]), jnp.asarray(drawn["bias"]),
                                         32)
        _close(got[0], np.repeat(np.asarray(a), 4, axis=0), 1e-5)
        _close(got[1], np.repeat(np.asarray(off), 4, axis=0), 1e-5)
    else:
        _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="channel_shift"):
        pmod(torch.from_numpy(x), channel_shift=torch.zeros(8, 64), return_coefficients=True)


def _block_context(rng, b, emb):
    return {"timestep_embedding": _normal(rng, b, emb)}


@pytest.mark.parametrize("case", ["video_ss", "video_additive", "image_mlp", "up", "down",
                                  "video_down", "ddpm", "ddpm_video", "ddpm_video_ss"])
def test_residual_blocks_match_jax(case):
    """ResnetBlockBigGAN with the 2-layer Mlp stack and stat_frames 4 (the
    video configs' block) under scale-shift (K4 on shared-frame
    coefficients) and additive conditioning (the unfused conv2), the image
    block with the stack, the resampling blocks (K3, resample, conv1), and
    ResnetBlockDDPM (Dense skip, conv2 not zero-initialised) per frame and
    with shared frames: 1e-5 of the scale."""
    from xdiffusion_tpu.layers import resnet as jax_resnet

    from xdiffusion_tpu_torch.layers.resnet import ResnetBlockBigGAN, ResnetBlockDDPM

    rng = np.random.default_rng(len(case))
    ddpm = case.startswith("ddpm")
    frames = 4 if "video" in case else 1
    use_ss = case not in ("video_additive", "ddpm", "ddpm_video")
    resample = dict(up=case == "up", down=case in ("down", "video_down"))
    mlp = 2 if ("video" in case or case == "image_mlp") else 0
    x = _normal(rng, 8, 8, 8, 32)
    kw = dict(use_scale_shift_norm=use_ss, emb_mlp_layers=mlp, stat_frames=frames)
    if ddpm:
        jmod = jax_resnet.ResnetBlockDDPM(dim_out=64, **kw)
        pmod = ResnetBlockDDPM(32, 64, 48, **kw)
    else:
        jmod = jax_resnet.ResnetBlockBigGAN(dim_out=64, **resample, **kw)
        pmod = ResnetBlockBigGAN(32, 64, 48, **resample, **kw)
    want, got = _shared(jmod, pmod, x, _block_context(rng, 8, 48), seed=4)
    assert np.abs(np.asarray(want)).max() > 1e-2
    _close(got, want, 1e-5)


# ---- attention -----------------------------------------------------------------------


@pytest.mark.parametrize("branch", ["arange", "frame_indices"])
def test_temporal_self_attention_matches_jax(branch):
    """TemporalSelfAttention on (2, 6, 3, 5, 64): 4 heads of 16 (F = 6 is
    not the head dim, so the reshape without a permute scrambles frames and
    channels as JAX's does), max_relative_position 4 (offsets clipped at
    +-3), positions from arange(F) or from explicit, gapped frame indices:
    1e-5 of the scale."""
    from xdiffusion_tpu.layers.attention import TemporalSelfAttention as JaxTSA

    from xdiffusion_tpu_torch.layers.attention import TemporalSelfAttention

    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 6, 3, 5, 64)
    ctx = {}
    if branch == "frame_indices":
        ctx["frame_indices"] = np.stack([np.sort(rng.choice(20, 7, replace=False))
                                         for _ in range(2)]).astype(np.int32)
    kw = dict(temporal_sequence_length=6, max_relative_position=4, heads=2, dim_head=16)
    want, got = _shared(JaxTSA(in_channels=64, **kw), TemporalSelfAttention(64, **kw), x, ctx,
                        seed=5)
    assert np.abs(np.asarray(want) - x).max() > 1e-2
    _close(got, want, 1e-5)


def test_spatial_and_temporal_cross_attention_matches_jax():
    """Make-A-Video's fused block on a folded (2*4, 4, 4, 64) map against 5
    caption tokens of width 24 (2 heads of 32 spatially and temporally):
    1e-5 of the scale."""
    from xdiffusion_tpu.layers.attention import SpatialAndTemporalCrossAttention as JaxST

    from xdiffusion_tpu_torch.layers.attention import SpatialAndTemporalCrossAttention

    rng = np.random.default_rng(4)
    x = _normal(rng, 8, 4, 4, 64)
    ctx = {"text_embeddings": _normal(rng, 8, 5, 24)}
    kw = dict(temporal_sequence_length=4, max_relative_position=4, context_dim=24, heads=2,
              dim_head=32, context_adapter={"target": "xdiffusion.context.TextEmbeddingsAdapter",
                                            "params": {"swap_context_channels": True}})
    want, got = _shared(JaxST(in_channels=64, **kw), SpatialAndTemporalCrossAttention(64, **kw),
                        x, ctx, seed=6)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("layer", ["conv3d", "temporal_attention_text",
                                   "temporal_attention_self", "motion_self_attention"])
def test_video_adapter_layers_match_jax(layer):
    """Video-LDM's Conv3DLayer (shared-frame GroupNorm + SiLU, the frame
    convolution, the gate) and TemporalAttentionLayer against strided
    caption embeddings and on itself, and AnimateDiff's MotionSelfAttention
    (K5's plain version) on (2, 9, 4, 64): 1e-5 of the scale. The drawn
    gates lie inside (0, 1), so both branches count."""
    from xdiffusion_tpu.score_networks import animate_diff as jax_ad
    from xdiffusion_tpu.score_networks import video_ldm as jax_ldm

    from xdiffusion_tpu_torch.score_networks import animate_diff, video_ldm

    rng = np.random.default_rng(5)
    x = _normal(rng, 8, 3, 3, 64)
    if layer == "conv3d":
        want, got = _shared(jax_ldm.Conv3DLayer(out_dim=64, num_frames=4),
                            video_ldm.Conv3DLayer(64, 4), x, seed=7)
    elif layer.startswith("temporal_attention"):
        ctx = {"text_embeddings": np.repeat(_normal(rng, 2, 5, 24), 4, axis=0)}
        if layer.endswith("self"):
            ctx = {}
        kv = 24 if ctx else -1
        want, got = _shared(jax_ldm.TemporalAttentionLayer(num_frames=4, heads=2, kv_dim=kv),
                            video_ldm.TemporalAttentionLayer(64, 4, 2, kv), x, ctx, seed=8)
    else:
        x = _normal(rng, 2, 9, 4, 64)
        want, got = _shared(jax_ad.MotionSelfAttention(num_frames=4, heads=2),
                            animate_diff.MotionSelfAttention(64, 4, 2), x, seed=9)
    assert np.abs(np.asarray(want) - x).max() > 1e-2
    _close(got, want, 1e-5)


# ---- the networks ------------------------------------------------------------------


def _net_classes(target: str):
    module, _, name = target.replace("xdiffusion.", "xdiffusion_tpu.", 1).rpartition(".")
    from xdiffusion_tpu_torch.config import get_obj_from_str

    return getattr(importlib.import_module(module), name), get_obj_from_str(target)


def _network_inputs(size, text, seed=0):
    rng = np.random.default_rng(seed)
    x = _normal(rng, 2, 4, size, size, 1)
    ctx = {"logsnr_t": np.float32([0.7, -3.0])}
    if text:
        ctx["text_tokens"] = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    return x, ctx


def _check_network(params_cfg, size, text, tol=2e-5):
    from xdiffusion_tpu.config import DotConfig as JaxDot

    from xdiffusion_tpu_torch.config import DotConfig

    jcls, pcls = _net_classes(params_cfg["target"])
    jnet = jcls(config=JaxDot(params_cfg["params"]))
    pnet = pcls(config=DotConfig(params_cfg["params"]))
    x, ctx = _network_inputs(size, text)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x), _jnp(ctx))
    drawn = random_flax_params(_flat(shapes["params"]), seed=3)
    load_flax_params(pnet, drawn)
    want = np.asarray(jax.jit(jnet.apply)({"params": _tree(drawn)}, jnp.asarray(x), _jnp(ctx)))
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), _torch(ctx))
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 1e-1  # no zero-initialised layer left
    _close(got, want, tol)


def _fixture(name):
    with open(os.path.join(FIXTURES, name + ".yaml")) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_video_network_forward_matches_jax(name):
    """The fixture's network (unet_3d, unet_pseudo3d, Video-LDM, AnimateDiff
    at 4 frames) on 2 videos with text tokens where it takes them: 2e-5 of
    the scale."""
    size, text = NETWORKS[name]
    _check_network(_fixture(name)["diffusion"]["score_network"], size, text)


@pytest.mark.parametrize("variant", ["ddpm_blocks", "resblock_updown"])
@pytest.mark.parametrize("video", [False, True])
def test_unets_with_ddpm_blocks_or_resampling_blocks_match_jax(variant, video):
    """The image UNet (the flagship's layout at num_features 32) and the
    video unet_3d fixture with `resnet_block_type: ddpm` (a DDPM block
    ignores the resampling request, as JAX's does) or `resblock_updown`: 2e-5
    of the scale."""
    if video:
        cfg = _fixture("video_trajectory_parity")["diffusion"]["score_network"]
        size = 8
    else:
        with open(os.path.join(REPO, "configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml")) as f:
            cfg = yaml.safe_load(f)["diffusion"]["score_network"]
        p = cfg["params"]
        p.update(num_features=32, channel_multipliers=[1, 2], input_spatial_size=8)
        p["attention"]["attention_resolutions"] = [4]
        p["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
        size = 8
    if variant == "ddpm_blocks":
        cfg["params"].update(resnet_block_type="ddpm", resblock_updown=True)
    else:
        cfg["params"]["resblock_updown"] = True
    if video:
        _check_network(cfg, size, False)
        return
    from xdiffusion_tpu.config import DotConfig as JaxDot

    from xdiffusion_tpu_torch.config import DotConfig

    jcls, pcls = _net_classes(cfg["target"])
    jnet, pnet = jcls(config=JaxDot(cfg["params"])), pcls(config=DotConfig(cfg["params"]))
    rng = np.random.default_rng(8)
    x, t = _normal(rng, 2, 8, 8, 1), np.int32([10, 900])
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            {"timestep": jnp.asarray(t)})
    drawn = random_flax_params(_flat(shapes["params"]), seed=3)
    load_flax_params(pnet, drawn)
    want = jax.jit(jnet.apply)({"params": _tree(drawn)}, jnp.asarray(x),
                               {"timestep": jnp.asarray(t)})
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), {"timestep": torch.from_numpy(t).long()})
    _close(got, want, 2e-5)


# ---- loss and gradients -------------------------------------------------------------


def video_config(fixture: str, directory, **sampler) -> str:
    """`video_diffusion_models.yaml`'s process (v target, 1024-scale cosine
    logSNR, ancestral sampler with reconstruction guidance, no guidance
    drop) around the fixture's network, its sizes; written to `directory`."""
    with open(os.path.join(VIDEO, "video_diffusion_models.yaml")) as f:
        cfg = yaml.safe_load(f)
    net = _fixture(fixture)["diffusion"]["score_network"]
    p = net["params"]
    size = p.get("input_spatial_size")
    cfg["diffusion"]["score_network"] = net
    cfg["diffusion"]["sampling"].update(output_spatial_size=size,
                                        output_frames=p["input_number_of_frames"])
    cfg["diffusion"]["sampling"]["params"].update(sampler)
    cfg["data"].update(image_size=size, input_number_of_frames=p["input_number_of_frames"])
    path = os.path.join(str(directory), fixture + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def build_process(path: str, seed: int = 7, text: bool = False):
    """(JAX process, flax params, port process on the CPU) on shared seeded
    weights; `text`: the network takes 6 text tokens."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    jmodel = JaxDDPM(jax_load_yaml(path))
    x, ctx = jmodel.example_batch(2)
    if text:
        ctx["text_tokens"] = jnp.zeros((2, 6), jnp.int32)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    drawn = random_flax_params(_flat(shapes["params"]), seed=seed)
    pmodel = GaussianDiffusion_DDPM(load_yaml(path), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, {"params": _tree(drawn)}, pmodel


@pytest.mark.parametrize("fixture", ["video_trajectory_parity", "animate_diff_parity"])
def test_video_loss_and_every_gradient_match_jax(fixture, tmp_path):
    """loss_on_batch of unet_3d and AnimateDiff (its motion attention
    through K5/K6's plain versions) on 2 videos of 4 frames, with text
    tokens for AnimateDiff, injected times and noise, no dropout, against
    jitted jax.value_and_grad: the loss and per-example losses to 1e-5
    relative, every gradient to GRAD_TOL, a vanishing one (below the floor) to 1e-3
    of the floor in absolute terms (`vanishing_aware_grad_errors`)."""
    size, text = NETWORKS[fixture]
    jmodel, params, pmodel = build_process(video_config(fixture, tmp_path), text=text)
    rng = np.random.default_rng(11)
    images = rng.random((2, 4, size, size, 1)).astype(np.float32)
    noise = _normal(rng, *images.shape)
    t = np.float32([0.15, 0.8])
    ctx = {"text_tokens": rng.integers(0, 50, size=(2, 6)).astype(np.int32)} if text else {}

    def jax_loss(p):
        return jmodel.loss_on_batch(p, jax.random.PRNGKey(1), jnp.asarray(images), _jnp(ctx),
                                    timesteps=jnp.asarray(t), noise=jnp.asarray(noise),
                                    deterministic=True)

    (want, want_m), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    net = pmodel.score_network()
    net.zero_grad(set_to_none=True)
    got, got_m = pmodel.loss_on_batch(torch.from_numpy(images), _torch(ctx),
                                      timesteps=torch.from_numpy(t), noise=torch.from_numpy(noise),
                                      deterministic=True)
    got.backward()
    for name, p in net.named_parameters():
        if p.grad is None:  # the allocated, unused relative-position value tables
            assert name.endswith("rel_v_embeddings"), name
            p.grad = torch.zeros_like(p)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["loss_per_example"].numpy(),
                               np.asarray(want_m["loss_per_example"]), rtol=1e-5)
    errors = vanishing_aware_grad_errors(grads, net)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_TOL, f"{worst}: {errors[worst]:.2e}"


def vanishing_aware_grad_errors(grads, net):
    """`_grad_errors`, except for a gradient below the floor (1e-3 of the
    network's largest): one that vanishes in exact arithmetic, as a conv
    bias before a GroupNorm of one channel a group does, where only rounding
    is left. Its error is its largest |port - JAX| over 10x the floor, so it
    is held to 1e-3 of the floor in absolute terms."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    errors = _grad_errors(grads, net)
    want = flax_to_state_dict({k: np.asarray(v) for k, v in _flat(grads["params"]).items()}, net)
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    for name, p in net.named_parameters():
        if want[name].abs().max().item() < floor:
            errors[name] = (p.grad - want[name]).abs().max().item() / (10 * floor)
    return errors


def test_dot_product_attention_chunks_batches_beyond_the_grid(monkeypatch):
    """A batch above FLASH_MAX_BATCH (K5's and K6's grid holds the batch on
    z, at most 65535 blocks) goes to K5 in chunks: with the limit set to 3,
    a batch of 8 gives the same output and gradients bit for bit."""
    from xdiffusion_tpu_torch.ops import attention

    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(_normal(rng, 8, 2, 5, 16)).requires_grad_() for _ in range(3))
    whole = attention.dot_product_attention(q, k, v)
    grads = torch.autograd.grad(whole.square().sum(), (q, k, v))
    monkeypatch.setattr(attention, "FLASH_MAX_BATCH", 3)
    chunked = attention.dot_product_attention(q, k, v)
    assert torch.equal(chunked, whole)
    for g, w in zip(torch.autograd.grad(chunked.square().sum(), (q, k, v)), grads):
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [1, 2])
def test_temporal_self_attention_hands_k3_a_contiguous_map(batch, monkeypatch):
    """K3 refuses strided input on the card. At batch 1 the (B*H*W, F, C)
    view of a (B, F, H, W, C) video is a strided view, not a copy: its
    GroupNorm hands K3 a contiguous map all the same."""
    from xdiffusion_tpu_torch.layers import resnet
    from xdiffusion_tpu_torch.layers.attention import TemporalSelfAttention

    seen, k3 = [], resnet.group_norm_silu

    def spy(x, *args, **kwargs):
        seen.append(x.is_contiguous())
        return k3(x, *args, **kwargs)

    monkeypatch.setattr(resnet, "group_norm_silu", spy)
    layer = TemporalSelfAttention(64, temporal_sequence_length=4, max_relative_position=4,
                                  heads=2, dim_head=16)
    with torch.no_grad():
        layer(torch.randn(batch, 4, 3, 5, 64))
    assert seen == [True]
