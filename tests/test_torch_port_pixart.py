"""The PixArt-alpha family in the port against the JAX package on the CPU:
cross-attention to a caption (16 queries against 77 and ragged key counts,
fp32 and bf16; K5's plain version on the port's side), K5 and K6 at head
dim 256 against the Pallas kernels in interpret mode, the block with and
without a caption, DyT, and the four PixArt configs (`pixart_alpha`, its
class-conditional and DyT variants, `wideformer_pixart_deep`) at depth 2,
hidden 128 with 2 heads of 64: forward, loss with prompts (and the
guidance drop), a 10-step guided trajectory; `wideformer_pixart` at depth
1, hidden 512 over 2 heads (head dim 256, as shipped): forward and guided
trajectory; each config built at full width; and a tiny PixArt trained
through the training CLI."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_text import (
    _shared,
    build,
    check_forward,
    check_loss,
    check_trajectory,
    config_path,
    spatial,
)

TEXT_PIXART = ["mnist/pixart_alpha", "mnist/pixart_alpha_dyt", "mnist/wideformer_pixart_deep"]
CLASS_PIXART = "mnist/pixart_alpha_class_conditional"
ALL_PIXART = TEXT_PIXART + [CLASS_PIXART, "mnist/wideformer_pixart"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sk", [77, 5, 130])
def test_cross_attention_matches_jax(sk, dtype):
    """16 queries (a 4x4 patch grid) against a caption of 77 keys (the T5
    length), 5 and 130: fp32 3e-5; bf16 3e-2 of the output's scale."""
    from xdiffusion_tpu.score_networks.pixart import CrossAttention as JaxCross

    from xdiffusion_tpu_torch.score_networks.pixart import CrossAttention

    jdt, pdt = DTYPES[dtype]
    rng = np.random.default_rng(sk)
    x = rng.standard_normal((3, 16, 128)).astype(np.float32)
    y = rng.standard_normal((3, sk, 128)).astype(np.float32)
    jmod = JaxCross(num_heads=2, dtype=jdt)
    port = CrossAttention(128, 2, dtype=pdt)
    params = _shared(jmod, port, jnp.asarray(x), jnp.asarray(y))
    assert port.q.bias is None and port.kv.bias is None and port.proj.bias is not None
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(y)), dtype=np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == pdt and got.shape == (3, 16, 128)
    tol = 3e-5 if dtype == "float32" else 3e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("norm_cls", ["layer", "dyt"])
@pytest.mark.parametrize("with_caption", [True, False])
def test_pixart_block_matches_jax(with_caption, norm_cls):
    """One block on 16 tokens with the shared modulation, with a 77-token
    caption or none (the class-conditional configs), LayerNorm or DyT:
    fp32 3e-5."""
    from xdiffusion_tpu.score_networks.pixart import PixArtBlock as JaxBlock

    from xdiffusion_tpu_torch.score_networks.pixart import PixArtBlock

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    y = rng.standard_normal((2, 77, 128)).astype(np.float32) if with_caption else None
    mod = (0.3 * rng.standard_normal((2, 6, 128))).astype(np.float32)
    jmod = JaxBlock(hidden_size=128, num_heads=2, mlp_ratio=4.0, drop_path=0.1,
                    norm_cls=norm_cls)
    port = PixArtBlock(128, 2, mlp_ratio=4.0, drop_path=0.1, norm_cls=norm_cls,
                       cross_attention=with_caption).eval()
    jy = None if y is None else jnp.asarray(y)
    params = _shared(jmod, port, jnp.asarray(x), jy, jnp.asarray(mod))
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jy, jnp.asarray(mod)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if y is None else torch.from_numpy(y),
                   torch.from_numpy(mod))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_at_head_dim_256_matches_pallas(b):
    """K5 and K6 at WideFormer's cross-attention shape, 2 heads of 256, 16
    queries against 77 caption keys: the plain versions (the CPU side of
    the D-256 wide kernels) against `_flash_forward` and `_flash_bwd` in
    interpret mode, o, lse, dq, dk and dv, on the same q, k, v, g and
    Pallas's o and lse: 1e-5 of each output's scale (fp32 sums in other
    orders)."""
    from xdiffusion_tpu.ops.flash_attention import _flash_bwd, _flash_forward

    from xdiffusion_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_plan,
    )

    rng = np.random.default_rng(b)
    q, g = (rng.standard_normal((b, 2, 16, 256)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, 2, 77, 256)).astype(np.float32) for _ in range(2))
    scale = 256 ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = _flash_forward(jq, jk, jv, scale)
        want = _flash_bwd(scale, (jq, jk, jv, want_o, want_lse), jnp.asarray(g))
    o, lse = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert flash_plan(b, 2, 16, 77, 256, torch.float32).variant == "wide"
    for got, ref in ((o, want_o), (lse, want_lse)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   rtol=0)
    got = flash_attention_bwd(*(torch.from_numpy(np.array(a)) for a in
                                (q, k, v, want_o, want_lse, g)), scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5 * max(1.0, np.abs(y).max()), rtol=0,
                                   err_msg=name)


def test_dynamic_tanh_norm_matches_flax():
    """DyT's parameters (scalar alpha, initially 0.5; gamma; beta) and its
    output on carried weights: 1e-6."""
    from xdiffusion_tpu.layers.norm import DynamicTanhNorm as JaxDyT

    from xdiffusion_tpu_torch.layers.norm import DynamicTanhNorm

    port = DynamicTanhNorm(64)
    assert port.alpha.shape == () and port.alpha.item() == 0.5
    assert torch.equal(port.gamma, torch.ones(64)) and torch.equal(port.beta, torch.zeros(64))
    x = (3 * np.random.default_rng(2).standard_normal((3, 5, 64))).astype(np.float32)
    jmod = JaxDyT(dim=64)
    params = _shared(jmod, port, jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", TEXT_PIXART)
def test_text_pixart_forward_matches_jax(name):
    """With prompts through the host-side T5 tokens: fp32 2e-5 of the
    output's scale, as `check_forward` holds the UNets."""
    check_forward(name)


def _class_loss(drop: float):
    """The class-conditional config's loss_on_batch with digit labels,
    injected steps and noise, dropout off, the guidance drop (to the null
    class) at probability `drop`: 1e-5 relative."""
    jmodel, params, pmodel = build(CLASS_PIXART)
    size, ch = spatial(pmodel)
    rng = np.random.default_rng(3)
    images = rng.random((2, size, size, ch)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    t, classes = np.int32([17, 802]), np.int32([3, 7])
    saved = jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability
    jmodel._unconditional_guidance_probability = pmodel._unconditional_guidance_probability = drop
    try:
        want, _ = jax.jit(jmodel.loss_on_batch, static_argnames=("deterministic",))(
            params, jax.random.PRNGKey(1), jnp.asarray(images), {"classes": jnp.asarray(classes)},
            timesteps=jnp.asarray(t), noise=jnp.asarray(noise), deterministic=True)
        got, _ = pmodel.loss_on_batch(
            torch.from_numpy(images), {"classes": torch.from_numpy(classes)},
            timesteps=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
            deterministic=True)
    finally:
        jmodel._unconditional_guidance_probability, pmodel._unconditional_guidance_probability = saved
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    return got.item()


def test_class_conditional_forward_matches_jax():
    """No cross-attention (context_key: null); the label embedding joins
    the timestep's in the shared modulation: fp32 2e-5 of the output's
    scale."""
    jmodel, params, pmodel = build(CLASS_PIXART)
    assert all(block.cross_attn is None for block in pmodel.score_network()._blocks)
    size, ch = spatial(pmodel)
    x = np.random.default_rng(0).standard_normal((2, size, size, ch)).astype(np.float32)
    t, classes = np.int32([5, 640]), np.int32([1, 10])  # 10: the null class
    want = np.asarray(jax.jit(jmodel.predict_score)(
        params, jnp.asarray(x), {"timestep": jnp.asarray(t), "classes": jnp.asarray(classes)}))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), {"timestep": torch.from_numpy(t).long(),
                                                         "classes": torch.from_numpy(classes)})
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("name", TEXT_PIXART)
def test_text_pixart_loss_matches_jax(name):
    check_loss(name)


def test_guidance_drop_matches_jax():
    """With the drop at probability 1 every example trains unconditionally:
    pixart_alpha's T5 tokens are zeroed (and stay integers), the class-
    conditional config's labels go to the null class, as in the JAX loss;
    each loss moves."""
    assert check_loss("mnist/pixart_alpha", drop=1.0) != check_loss("mnist/pixart_alpha")
    assert _class_loss(1.0) != _class_loss(0.0)


def test_pixart_guided_trajectory_matches_jax():
    """10 ancestral steps of pixart_alpha with prompts, guidance 1.0 (one
    forward on the doubled batch), dynamic thresholding and injected noise:
    1e-3 on samples in [0, 1]."""
    check_trajectory("mnist/pixart_alpha")


# wideformer_pixart.yaml's head dim (2048 / 8 = 256) at a width the CPU
# runs quickly: depth 1, hidden 512 over 2 heads.
WIDE_256 = dict(depth=1, hidden=512)


def test_head_dim_256_pixart_forward_matches_jax():
    """wideformer_pixart with 2 heads of 256 (self-attention on K1's wide
    variant, the caption's cross-attention on K5's, on the card): the
    forward with prompts, fp32 2e-5 of the output's scale."""
    _, _, pmodel = build("mnist/wideformer_pixart", **WIDE_256)
    sn = pmodel.config().diffusion.score_network.params
    assert sn.hidden_size // sn.num_heads == 256
    check_forward("mnist/wideformer_pixart", **WIDE_256)


def test_head_dim_256_pixart_guided_trajectory_matches_jax():
    """10 guided ancestral steps of the same network with prompts, dynamic
    thresholding and injected noise: 1e-3 on samples in [0, 1]."""
    check_trajectory("mnist/wideformer_pixart", **WIDE_256)


@pytest.mark.parametrize("name", ALL_PIXART)
def test_config_builds_at_full_width_on_the_cpu(name):
    """Each config as shipped builds with the port, every parameter fp32 on
    the CPU, the host-side prompt projection left out of the module and the
    context heads numbered as the flax tree numbers them. wideformer_pixart
    (head dim 2048 / 8 = 256) builds too; on the card K1's and K5's wide
    variants take its head dim."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    model = GaussianDiffusion_DDPM(load_yaml(config_path(name)), device="cpu")
    net = model.score_network()
    sn = model.config().diffusion.score_network.params
    assert len(net._blocks) == sn.depth and net.t_block.out_features == 6 * sn.hidden_size
    names = {n.split(".")[0] for n, _ in net.named_parameters()}
    assert "_projections_text_prompts" not in names
    if name == CLASS_PIXART:
        assert "_projections_classes" in names and not any(n.startswith("_context_heads") for n in names)
    else:
        assert {"_projections_text_tokens", "_context_heads_2"} <= names
        assert (model._host_prompt_projection is not None
                and sn.hidden_size // sn.num_heads == (256 if name.endswith("pixart") else 64))
    dyt = name.endswith("dyt")
    assert (net.final_norm is not None) == dyt and (net._blocks[0].norm1 is not None) == dyt
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in net.parameters())


def _tiny_pixart(path) -> str:
    """pixart_alpha cut to 16x16 (patch 4: 16 tokens), hidden 64 over 2
    heads of 32, depth 2 and 8 noise scales, so the trainer's 8-step grids
    stay quick."""
    with open(config_path("mnist/pixart_alpha")) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["noise_scheduler"]["params"]["num_scales"] = 8
    diff["noise_scheduler"]["params"]["importance_sampler"]["params"]["num_timesteps"] = 8
    diff["sampling"]["output_spatial_size"] = 16
    sn = diff["score_network"]["params"]
    sn.update(input_spatial_size=16, patch_size=4, hidden_size=64, depth=2, num_heads=2)
    sn["conditioning"]["projections"]["timestep"]["params"]["hidden_size"] = 64
    sn["conditioning"]["projections"]["text_tokens"]["params"]["d_model"] = 32
    sn["conditioning"]["context_transformer_head"][-1]["params"].update(
        in_features=32, hidden_features=64, out_features=64)
    cfg["data"]["image_size"] = 16
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_train_cli_feeds_prompts_and_takes_mixed_precision(tmp_path):
    """`python -m xdiffusion_tpu_torch.train --mixed_precision bf16 ...
    --device cpu` trains the tiny PixArt: the flag is taken and not read,
    as in the JAX trainer; the prompts reach the network through its
    host-side T5 tokens (the config's context preprocessor is the ignore
    adapter); the metrics, the guided grid and the checkpoint are written."""
    from xdiffusion_tpu_torch import train as cli

    config = _tiny_pixart(tmp_path / "tiny_pixart.yaml")
    out = cli.main(["--config_path", config, "--num_training_steps", "2", "--batch_size", "4",
                    "--mixed_precision", "bf16", "--num_samples", "4", "--sample_with_guidance",
                    "--output_path", str(tmp_path / "run"), "--device", "cpu"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1] and all(np.isfinite(r["loss"]) for r in records)
    for name in ("sample-2.png", "checkpoints/2.pt"):
        assert os.path.getsize(os.path.join(out, name)) > 0
