"""The class-conditional DiT path, dense and mixture-of-experts: the port
against the JAX package on the CPU.

The layers (2-D sin-cos table, patch, timestep and label embeddings, the
self-attention), the MoE routing and expert MLP, the tiny DiT's forward in
fp32 and bf16, `loss_on_batch` and every parameter's gradient, a 10-step
guided ancestral trajectory, the chunked MoE sampling forward, one
optimizer step, and the training and sampling CLIs. The tiny DiT is the
JAX package's test network (tests/test_dit.py): 16x16 input, patch 4,
hidden 64, depth 2, 2 heads of 32, MLP ratio 2, 4 experts for MoE. Inputs,
noise and weights come from numpy seeds; weights cross through the bridge
(weights.py).
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
import yaml
from flax import traverse_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIT = os.path.join(REPO, "configs/image/mnist/dit.yaml")

# fp32 on both sides; sums in other orders.
OPS_TOL = 1e-5
# Each parameter's gradient, relative to its own largest magnitude.
GRAD_TOL = 1e-4


def tiny_config(experts: int = 0, dtype: str = "float32", dropout: float = 0.0,
                num_scales: int = 10) -> dict:
    """dit.yaml (or, with experts, its MoE variant) cut to the tiny DiT, with
    a num_scales-step cosine schedule (a linear one's betas pass 1 when it is
    this short)."""
    with open(DIT) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["sampling"]["output_spatial_size"] = 16
    diff["noise_scheduler"]["params"].update(num_scales=num_scales, schedule_type="cosine")
    diff["noise_scheduler"]["params"]["importance_sampler"]["params"]["num_timesteps"] = \
        num_scales
    sn = diff["score_network"]["params"]
    sn.update(input_spatial_size=16, patch_size=4, hidden_size=64, depth=2, num_heads=2,
              mlp_ratio=2.0, dropout=dropout, dtype=dtype)
    if experts:
        sn.update(num_experts=experts, moe_top_k=1, moe_capacity_factor=1.25,
                  moe_aux_loss_weight=0.01)
    proj = sn["conditioning"]["projections"]
    proj["timestep"]["params"].update(hidden_size=64, frequency_embedding_size=32)
    proj["classes"]["params"]["hidden_size"] = 64
    cfg["data"]["image_size"] = 16
    return cfg


def _flat(tree):
    return {"/".join(k): v for k, v in traverse_util.flatten_dict(tree).items()}


def _tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def build(cfg: dict, seed: int = 7):
    """(JAX process, its params, port process on the CPU, the drawn flat
    weights), both with the same seeded weights."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxDDPM(JaxDotConfig(cfg))
    x = jnp.zeros((2, 16, 16, 1))
    ctx = {"timestep": jnp.zeros((2,), jnp.int32), "classes": jnp.zeros((2,), jnp.int32)}
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    drawn = random_flax_params(_flat(shapes["params"]), seed=seed)
    pmodel = GaussianDiffusion_DDPM(DotConfig(cfg), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, {"params": _tree(drawn)}, pmodel, drawn


@pytest.fixture(scope="module")
def dense():
    return build(tiny_config())


@pytest.fixture(scope="module")
def moe():
    return build(tiny_config(experts=4))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---- layers -----------------------------------------------------------------


@pytest.mark.parametrize("dim,gh,gw,base", [(64, 4, 4, 16), (384, 4, 4, 16), (32, 3, 5, None)])
def test_sincos_position_embedding_2d_equals_jax(dim, gh, gw, base):
    """Both build the table in float64 numpy and round it to fp32: bit-equal."""
    from xdiffusion_tpu.layers.embedding import sincos_position_embedding_2d as jax_table

    from xdiffusion_tpu_torch.layers.embedding import sincos_position_embedding_2d

    got = sincos_position_embedding_2d(dim, gh, gw, base_size=base)
    want = np.asarray(jax_table(dim, gh, gw, base_size=base))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _apply_layer(jax_module, port_module, args, port_args=None, seed=0):
    """Outputs of a flax module and its port counterpart with the same
    seeded weights (flax init shapes, `random_flax_params`, the bridge)."""
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in args))
    drawn = random_flax_params(_flat(shapes["params"]), seed=seed)
    want = jax_module.apply({"params": _tree(drawn)}, *(jnp.asarray(a) for a in args))
    load_flax_params(port_module, drawn)
    port_module.eval()
    with torch.no_grad():
        got = port_module(*(torch.from_numpy(np.asarray(a))
                            for a in (port_args if port_args is not None else args)))
    return got, want


@pytest.mark.parametrize("layer", ["patch_embed", "timestep", "label", "label_null",
                                   "self_attention"])
def test_dit_layers_match_jax(layer):
    """Each layer with shared weights against flax, fp32: 1e-5."""
    from xdiffusion_tpu.layers import attention as jattn
    from xdiffusion_tpu.layers import embedding as jemb

    from xdiffusion_tpu_torch.layers import attention, embedding

    rng = np.random.default_rng(1)
    if layer == "patch_embed":
        jm, pm = jemb.PatchEmbed(patch_size=4, embed_dim=64), embedding.PatchEmbed(1, 4, 64)
        args = (_normal(rng, 2, 16, 16, 1),)
    elif layer == "timestep":
        jm = jemb.DiTTimestepEmbedding(hidden_size=64, frequency_embedding_size=32)
        pm = embedding.DiTTimestepEmbedding(64, frequency_embedding_size=32)
        args = (np.array([0, 7, 500, 999], dtype=np.int32),)
    elif layer in ("label", "label_null"):
        override = layer == "label_null"
        jm = jemb.DiTLabelEmbedding(num_classes=10, hidden_size=64,
                                    unconditional_override=override)
        pm = embedding.DiTLabelEmbedding(10, 64, unconditional_override=override)
        args = (np.array([3, 10, 0, 9], dtype=np.int32),)  # 10: the null row
    else:
        jm, pm = jattn.MultiHeadSelfAttention(num_heads=2), attention.MultiHeadSelfAttention(64, 2)
        args = (_normal(rng, 2, 16, 64),)
    got, want = _apply_layer(jm, pm, args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OPS_TOL, rtol=OPS_TOL)


def test_combine_embeddings_and_classes_adapter():
    from xdiffusion_tpu_torch.context import UnconditionalClassesAdapter
    from xdiffusion_tpu_torch.layers.embedding import DiTCombineEmbeddings, DiTCombineEmbeddngs

    assert DiTCombineEmbeddngs is DiTCombineEmbeddings
    ctx = {"a": torch.ones(2, 3), "b": torch.full((2, 3), 2.0), "classes": torch.tensor([1, 4])}
    out = DiTCombineEmbeddings("c", ["a", "b"])(ctx)
    assert torch.equal(out["c"], torch.full((2, 3), 3.0))
    uncond = UnconditionalClassesAdapter(num_classes=10)(ctx)
    assert torch.equal(uncond["classes"], torch.tensor([10, 10]))
    assert torch.equal(ctx["classes"], torch.tensor([1, 4]))  # the input is left alone


# ---- mixture of experts -------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
def test_top_k_routing_matches_jax(top_k):
    """32 tokens over 4 experts at capacity 5, so tokens drop: the dispatch
    tensor exactly, combine and the aux loss to 1e-6."""
    from xdiffusion_tpu.layers.moe import top_k_routing as jax_routing

    from xdiffusion_tpu_torch.layers.moe import top_k_routing

    rng = np.random.default_rng(2)
    logits = _normal(rng, 32, 4) * 2.0
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = jax_routing(jnp.asarray(gates), 5, top_k)
    got = top_k_routing(torch.from_numpy(gates.copy()), 5, top_k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].sum() < 32 * top_k  # some tokens were dropped
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2].item(), float(want[2]), atol=1e-6, rtol=0)


def test_moe_mlp_matches_jax():
    """MoEMlp (4 experts, top-1, capacity factor 1.25) with shared weights,
    fp32: output 1e-5, its recorded aux loss 1e-6."""
    from xdiffusion_tpu.layers.moe import MoEMlp as JaxMoE

    from xdiffusion_tpu_torch.layers.moe import MoEMlp

    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 16, 64)
    jm = JaxMoE(hidden_size=64, mlp_dim=128, num_experts=4)
    pm = MoEMlp(64, 128, 4)
    got, _ = _apply_layer(jm, pm, (x,))
    from xdiffusion_tpu_torch.weights import random_flax_params

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": _tree(random_flax_params(_flat(shapes["params"]), seed=0))}
    want, mods = jax.jit(functools.partial(jm.apply, mutable=["intermediates"]))(
        params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OPS_TOL, rtol=OPS_TOL)
    aux = float(mods["intermediates"]["moe_aux_loss"][0])
    np.testing.assert_allclose(pm.aux_loss.item(), aux, atol=1e-6, rtol=0)


# ---- the network ----------------------------------------------------------------


def _forward_inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    return (_normal(rng, n, 16, 16, 1), rng.integers(0, 10, size=n).astype(np.int32),
            rng.integers(0, 11, size=n).astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_tiny_dit_forward_matches_jax(experts, dtype):
    """fp32: 1e-5 of the output's scale. bf16: both sides run the patch
    embedding and the blocks' Dense layers in bf16 and round at different
    points (flax's bf16 GELU and LayerNorm against PyTorch's, which compute
    in fp32 and round once); each side lies within about 1.1% of the output's
    scale of the fp32 network, the two within 0.9%: 2% of the scale. The
    head stays fp32 in both (`FinalLayer` is built without the network's
    dtype)."""
    jmodel, params, pmodel, _ = build(tiny_config(experts=experts, dtype=dtype))
    net = pmodel.score_network()
    assert net._final.proj.compute_dtype == torch.float32
    assert net._blocks[0].attn.qkv.compute_dtype == getattr(torch, dtype)
    x, t, classes = _forward_inputs(4)
    want = np.asarray(jax.jit(jmodel.predict_score)(
        params, jnp.asarray(x), {"timestep": jnp.asarray(t), "classes": jnp.asarray(classes)}))
    with torch.no_grad():
        got = pmodel.predict_score(torch.from_numpy(x), {"timestep": torch.from_numpy(t).long(),
                                                         "classes": torch.from_numpy(classes)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 16, 16, 1)
    scale = np.abs(want).max()
    tol = OPS_TOL * max(1.0, scale) if dtype == "float32" else 2e-2 * scale
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def _fixed_cfg_mask(monkeypatch, mask):
    """Both processes' classifier-free-guidance drop mask becomes `mask`."""
    import xdiffusion_tpu.diffusion.ddpm as jax_ddpm

    import xdiffusion_tpu_torch.diffusion.ddpm as port_ddpm

    monkeypatch.setattr(jax_ddpm, "prob_mask_like", lambda rng, shape, prob: jnp.asarray(mask))
    monkeypatch.setattr(port_ddpm, "prob_mask_like",
                        lambda shape, prob, generator, device: torch.from_numpy(mask))


def _grad_errors(grads, net):
    """{port parameter name: max |port - JAX| over max |JAX|}, each scale
    floored at 1e-3 of the network's largest gradient."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    want = {k: v.numpy() for k, v in
            flax_to_state_dict({k: np.asarray(v) for k, v in _flat(grads["params"]).items()},
                               net).items()}
    named = dict(net.named_parameters())
    assert set(named) == set(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    out = {}
    for name, p in named.items():
        assert p.grad is not None, f"{name} received no gradient"
        out[name] = np.abs(p.grad.numpy() - want[name]).max() / max(np.abs(want[name]).max(),
                                                                      floor)
    return out


@pytest.mark.parametrize("case", ["dense", "dense_cfg_drop", "moe_cfg_drop"])
def test_tiny_dit_loss_and_every_gradient_match_jax(case, dense, moe, monkeypatch):
    """loss_on_batch and every parameter's gradient against
    jax.value_and_grad of the JAX package's loss_on_batch: injected
    timesteps and noise, dropout off, and a fixed guidance drop mask (none,
    or samples 1 and 3 sent to the null class). The MoE objective adds 0.01
    times the blocks' mean load-balance loss, reported as moe_aux_loss.
    fp32: the loss to 1e-5 relative, aux to 1e-6, each gradient to 1e-4 of
    its own largest magnitude (floored at 1e-3 of the network's largest)."""
    jmodel, params, pmodel, drawn = moe if case.startswith("moe") else dense
    from xdiffusion_tpu_torch.weights import load_flax_params

    net = pmodel.score_network()
    load_flax_params(net, drawn)
    net.zero_grad(set_to_none=True)
    rng = np.random.default_rng(5)
    images = rng.random((4, 16, 16, 1)).astype(np.float32)
    t = rng.integers(0, 10, size=4).astype(np.int32)
    noise = _normal(rng, 4, 16, 16, 1)
    classes = np.array([3, 7, 0, 9], dtype=np.int32)
    mask = np.array([False, "drop" in case, False, "drop" in case])
    _fixed_cfg_mask(monkeypatch, mask)

    def jax_loss(p):
        return jmodel.loss_on_batch(p, jax.random.PRNGKey(1), jnp.asarray(images),
                                    {"classes": jnp.asarray(classes)},
                                    timesteps=jnp.asarray(t), noise=jnp.asarray(noise),
                                    deterministic=True)

    (want_loss, want_metrics), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    seen = {}
    forward = net.forward

    def spy(x, context):
        seen["classes"] = context["classes"].clone()
        return forward(x, context)

    monkeypatch.setattr(net, "forward", spy)
    loss, metrics = pmodel.loss_on_batch(
        torch.from_numpy(images), {"classes": torch.from_numpy(classes)},
        timesteps=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
        deterministic=True, generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.equal(seen["classes"], torch.from_numpy(np.where(mask, 10, classes)))
    assert set(metrics) == set(want_metrics)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    if case.startswith("moe"):
        np.testing.assert_allclose(metrics["moe_aux_loss"].item(),
                                   float(want_metrics["moe_aux_loss"]), atol=1e-6, rtol=0)
        assert metrics["loss"].item() == loss.item()
    errors = _grad_errors(grads, net)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_TOL, f"{worst}: {errors[worst]:.2e}"


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_ten_step_guided_trajectory_matches_jax(guidance, dense):
    """10 ancestral steps of the tiny dense DiT with classes 0-3, guidance
    through UnconditionalClassesAdapter (one forward on the doubled batch),
    dynamic thresholding on, injected initial and per-step noise. fp32:
    1e-4 on samples in [0, 1] (the forward's 1e-5 carried through 10 steps
    and the thresholds' quantiles)."""
    jmodel, params, pmodel, drawn = dense
    from xdiffusion_tpu_torch.weights import load_flax_params

    load_flax_params(pmodel.score_network(), drawn)
    steps, n = 10, 4
    rng = np.random.default_rng(6)
    init = _normal(rng, n, 16, 16, 1)
    noise = _normal(rng, steps, n, 16, 16, 1)
    classes = np.arange(n, dtype=np.int32) % 10
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=n, num_sampling_steps=steps,
        classifier_free_guidance=guidance, initial_noise=jnp.asarray(init),
        context={"classes": jnp.asarray(classes), "sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=n, num_sampling_steps=steps,
                        classifier_free_guidance=guidance, initial_noise=torch.from_numpy(init),
                        context={"classes": torch.from_numpy(classes),
                                 "sampling_noise": torch.from_numpy(noise)})
    assert got.shape == (n, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_moe_guided_forward_is_chunked_as_jax(moe):
    """The guided forward of a batch of 64 runs 128 samples (the conditional
    half, then the null-class half). The JAX package evaluates it as two
    chunks of 64, and each expert's capacity is reckoned per chunk; the
    port's predict_score chunks an MoE network's forward the same way and
    agrees to 1e-5 of the output's scale. The same network on the 128
    samples in one call drops other tokens and differs, which is what the
    chunking guards."""
    jmodel, params, pmodel, drawn = moe
    from xdiffusion_tpu_torch.weights import load_flax_params

    net = pmodel.score_network()
    load_flax_params(net, drawn)
    rng = np.random.default_rng(7)
    x = _normal(rng, 64, 16, 16, 1)
    x = np.concatenate([x, x])
    classes = np.concatenate([np.arange(64) % 10, np.full(64, 10)]).astype(np.int32)
    t = np.full(128, 6, dtype=np.int32)
    want = np.asarray(jax.jit(jmodel.predict_score)(
        params, jnp.asarray(x), {"timestep": jnp.asarray(t), "classes": jnp.asarray(classes)}))
    ctx = {"timestep": torch.from_numpy(t).long(), "classes": torch.from_numpy(classes)}
    with torch.no_grad():
        got = pmodel.predict_score(torch.from_numpy(x), ctx).numpy()
        whole = net(torch.from_numpy(x), ctx).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=OPS_TOL * max(1.0, scale), rtol=0)
    assert np.abs(whole - want).max() > 100 * OPS_TOL * max(1.0, scale)


def test_moe_no_grad_loss_at_batch_128_runs_whole_as_jax(moe, monkeypatch):
    """An MoE loss_on_batch under torch.no_grad at batch 128 (larger than a
    sampling chunk, and divisible by it) runs the network whole, as the JAX
    package's loss does (its with_intermediates path bypasses the chunking):
    the capacity and the aux loss are the whole batch's. fp32: the loss to
    1e-5 relative, moe_aux_loss to 1e-6."""
    jmodel, params, pmodel, drawn = moe
    from xdiffusion_tpu_torch.weights import load_flax_params

    load_flax_params(pmodel.score_network(), drawn)
    rng = np.random.default_rng(8)
    n = 128
    images = rng.random((n, 16, 16, 1)).astype(np.float32)
    t = rng.integers(0, 10, size=n).astype(np.int32)
    noise = _normal(rng, n, 16, 16, 1)
    classes = (np.arange(n) % 10).astype(np.int32)
    _fixed_cfg_mask(monkeypatch, np.zeros(n, dtype=bool))
    want_loss, want_metrics = jax.jit(functools.partial(jmodel.loss_on_batch, deterministic=True))(
        params, jax.random.PRNGKey(1), jnp.asarray(images), {"classes": jnp.asarray(classes)},
        timesteps=jnp.asarray(t), noise=jnp.asarray(noise))
    with torch.no_grad():
        loss, metrics = pmodel.loss_on_batch(
            torch.from_numpy(images), {"classes": torch.from_numpy(classes)},
            timesteps=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
            deterministic=True, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["moe_aux_loss"].item(),
                               float(want_metrics["moe_aux_loss"]), atol=1e-6, rtol=0)


def test_one_train_step_matches_jax(dense, monkeypatch):
    """One step of make_train_step (loss, backward, global-norm clip, Adam
    at the defaults) against the JAX package's from the same weights and
    batch (images, classes, timesteps), noise injected, dropout off and no
    guidance drop on both sides: the loss and gradient norm to 1e-5
    relative, every parameter after the step within the bound that the
    gradients' 1e-4 agreement puts on Adam's first update (as the LTX step
    test derives it: lr * dg * eps / ((|g| - dg)+ + eps)^2, at most 2 lr,
    plus 1e-5 of lr and two fp32 ulps of the parameter)."""
    from xdiffusion_tpu.parallel.train_step import create_train_state as jax_state
    from xdiffusion_tpu.parallel.train_step import make_train_step as jax_step
    from xdiffusion_tpu.training.image.train import build_optimizer as jax_optimizer

    from xdiffusion_tpu_torch.optim import DEFAULT_LR
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import build_optimizer
    from xdiffusion_tpu_torch.weights import flax_to_state_dict, load_flax_params

    jmodel, params, pmodel, drawn = dense
    net = pmodel.score_network()
    load_flax_params(net, drawn)
    _fixed_cfg_mask(monkeypatch, np.zeros(4, dtype=bool))
    rng = np.random.default_rng(8)
    batch = {"images": rng.random((4, 16, 16, 1)).astype(np.float32),
             "classes": np.array([1, 2, 3, 4], dtype=np.int32),
             "timesteps": rng.integers(0, 10, size=4).astype(np.int32)}
    noise = _normal(rng, 4, 16, 16, 1)
    monkeypatch.setattr(jmodel, "loss_on_batch", functools.partial(
        type(jmodel).loss_on_batch, jmodel, noise=jnp.asarray(noise), deterministic=True))
    monkeypatch.setattr(pmodel, "loss_on_batch", functools.partial(
        type(pmodel).loss_on_batch, pmodel, noise=torch.from_numpy(noise), deterministic=True))

    tx = jax_optimizer(jmodel.config())
    state = jax_state(jax.tree_util.tree_map(jnp.copy, params), tx)
    state, want = jax_step(jmodel, tx)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.PRNGKey(2))
    pstate = create_train_state(pmodel, build_optimizer(pmodel.config(), net.parameters()))
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pbatch["timesteps"] = pbatch["timesteps"].long()
    got = make_train_step(pmodel)(pstate, pbatch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-5)
    after = flax_to_state_dict({k: np.asarray(v) for k, v in
                                _flat(state.params["params"]).items()}, net)
    before = flax_to_state_dict(drawn, net)
    moved = 0.0
    for name, p in net.named_parameters():
        g = p.grad.abs()
        dg = GRAD_TOL * g.max()
        bound = DEFAULT_LR * torch.clamp(
            dg * 1e-8 / (torch.clamp(g - dg, min=0) + 1e-8) ** 2, max=2.0)
        bound = bound + 1e-5 * DEFAULT_LR + 2.0 ** -22 * after[name].abs()
        err = (p.detach() - after[name]).abs()
        assert bool((err <= bound).all()), f"{name}: {err.max().item():.3e}"
        moved = max(moved, (after[name] - before[name]).abs().max().item())
    assert moved > 1e-4
    load_flax_params(net, drawn)


# ---- the CLIs -------------------------------------------------------------------


def _config_file(tmp_path, **kwargs) -> str:
    path = tmp_path / "tiny_dit.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(tiny_config(**kwargs), f)
    return str(path)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_train_and_sample_clis_on_cpu(tmp_path, monkeypatch):
    """`python -m xdiffusion_tpu_torch.train --device cpu` on the tiny DiT
    (dropout 0.1, guidance drop 0.2) for 3 steps at batch 4 on the synthetic
    digits with their labels: metrics.jsonl, checkpoints and a guided grid
    of the digits 0-9. A resume from the step-2 checkpoint repeats step 3's
    loss bit for bit. `python -m xdiffusion_tpu_torch.sample --device cpu`
    on that checkpoint writes a grid, classes arange(n) % 10. Without a card
    and without --device cpu both raise."""
    from PIL import Image

    from xdiffusion_tpu_torch import sample as sample_cli
    from xdiffusion_tpu_torch import train as train_cli

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = _config_file(tmp_path, dropout=0.1)
    common = ["--config_path", config, "--batch_size", "4", "--save_and_sample_every_n", "2",
              "--num_samples", "4", "--sample_with_guidance", "--device", "cpu"]
    run = train_cli.main(common + ["--num_training_steps", "3", "--output_path",
                                   str(tmp_path / "run")])
    metrics = _metrics(run)
    assert sorted(metrics) == [0, 2]  # every 50th step and the last
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in metrics.values())
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2.pt", "3.pt"]
    grid = np.asarray(Image.open(os.path.join(run, "sample-3.png")))
    assert grid.shape == (32, 32)

    resumed = train_cli.main(common + ["--num_training_steps", "3", "--output_path",
                                       str(tmp_path / "resumed"), "--resume_from",
                                       os.path.join(run, "checkpoints", "2.pt")])
    assert _metrics(resumed)[2]["loss"] == metrics[2]["loss"]

    seen = {}
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    sample = GaussianDiffusion_DDPM.sample

    def spy(self, **kwargs):
        seen["classes"] = kwargs["context"]["classes"].clone()
        return sample(self, **kwargs)

    monkeypatch.setattr(GaussianDiffusion_DDPM, "sample", spy)
    samples = sample_cli.main(["--config_path", config, "--checkpoint",
                               os.path.join(run, "checkpoints", "3.pt"), "--num_samples", "12",
                               "--sampling_steps", "3", "--guidance", "3.0",
                               "--output_path", str(tmp_path / "samples"), "--device", "cpu"])
    assert tuple(samples.shape) == (12, 16, 16, 1) and bool(torch.isfinite(samples).all())
    assert torch.equal(seen["classes"], torch.arange(12) % 10)
    assert os.path.getsize(tmp_path / "samples" / "sample-step3.png") > 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config_path", config, "--output_path", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_cli.main(["--config_path", config, "--checkpoint", "unused.pt"])


def test_moe_training_reports_the_aux_loss(tmp_path, monkeypatch):
    """train() on the tiny MoE DiT: every logged step carries a finite,
    positive moe_aux_loss, and its loss is the mse plus 0.01 times it."""
    from xdiffusion_tpu_torch.training.image.train import train

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    run = train(_config_file(tmp_path, experts=4, dropout=0.1), num_training_steps=2,
                batch_size=4, output_path=str(tmp_path / "run"), save_and_sample_every_n=2,
                num_samples=2, device="cpu", log_every=1)
    metrics = _metrics(run)
    assert sorted(metrics) == [0, 1]
    for m in metrics.values():
        assert math.isfinite(m["moe_aux_loss"]) and m["moe_aux_loss"] > 0.0
        assert m["loss"] == pytest.approx(m["mse_loss"] + 0.01 * m["moe_aux_loss"], rel=1e-6)
