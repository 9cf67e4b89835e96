"""The LTX-Video training path: port against the JAX package on the CPU.

K6's plain version against the Pallas backward kernels in interpret mode (as
tests/test_ops.py runs them), the gradients of the port's `flash_attention`
Function and of the attention dispatch, the loss and every parameter's
gradient of a tiny LTX transformer (2 layers, 2 heads x 64, 4 frames of 4x4,
8 text tokens of width 32), one optimizer step, the host pipeline (Moving-
MNIST synthesis, batches, frame crops, masks) and the video training CLI.
fp32, inputs and weights from numpy seeds. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
import yaml
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_ltx import _load_small, _no_pretrained_t5  # noqa: F401 (autouse)

# fp32 on both sides; the ops differ by summation order only.
OPS_TOL = 1e-5
# Gradients through two blocks, each held to its own largest magnitude.
GRAD_TOL = 1e-4


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _no_guidance_drop(cfg):
    cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    return cfg


# ---- K6 and the attention gradients ----------------------------------------------


@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 128)], ids=["self", "cross"])
def test_flash_attention_bwd_plain_matches_pallas(sq, sk):
    """K6's plain version against `_flash_bwd` (the dq and dk/dv kernels) in
    interpret mode; both sides take the same q, k, v, g and the o and lse of
    one Pallas forward. Tolerance 1e-5 (fp32 sums in other orders)."""
    from xdiffusion_tpu.ops.flash_attention import _flash_bwd, _flash_forward

    from xdiffusion_tpu_torch.ops.flash_attention import flash_attention_bwd

    rng = np.random.default_rng(10)
    q, g = _normal(rng, 1, 2, sq, 64), _normal(rng, 1, 2, sq, 64)
    k, v = _normal(rng, 1, 2, sk, 64), _normal(rng, 1, 2, sk, 64)
    scale = 64 ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    with pltpu.force_tpu_interpret_mode():
        o, lse = _flash_forward(jq, jk, jv, scale)
        want = _flash_bwd(scale, (jq, jk, jv, o, lse), jnp.asarray(g))
    got = flash_attention_bwd(*(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, g)),
                              scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=OPS_TOL, rtol=OPS_TOL,
                                   err_msg=name)


def test_flash_attention_bwd_plain_rounds_as_the_tpu_kernels_in_bf16():
    """In bf16 the plain backward rounds ds to q's dtype and the dv-side p to
    g's, as `_flash_dq_kernel` and `_flash_dkv_kernel` do: the results agree
    to 2 bf16 ulps at each reference's largest value."""
    from xdiffusion_tpu.ops.flash_attention import _flash_bwd, _flash_forward

    from xdiffusion_tpu_torch.ops.flash_attention import flash_attention_bwd

    rng = np.random.default_rng(11)
    arrays = [_normal(rng, 1, 2, 256, 64) for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        o, lse = _flash_forward(jq, jk, jv, 0.125)
        want = _flash_bwd(0.125, (jq, jk, jv, o, lse), jg)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
    got = flash_attention_bwd(*(to_t(a).bfloat16() for a in (jq, jk, jv, o)),
                              to_t(lse), to_t(jg).bfloat16(), 0.125)
    for x, y in zip(got, want):
        y = np.asarray(y.astype(jnp.float32))
        assert x.dtype == torch.bfloat16
        tol = 2 * 2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7)
        np.testing.assert_allclose(x.float().numpy(), y, rtol=0, atol=tol)


def test_flash_attention_gradcheck():
    """The Function's backward (K6's plain version on the CPU) against finite
    differences, float64."""
    from xdiffusion_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 1, 8, 64), generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    o, lse = flash_attention(q, k, v, 0.125)
    assert not lse.requires_grad
    assert torch.autograd.gradcheck(lambda q, k, v: flash_attention(q, k, v, 0.125)[0],
                                    (q, k, v))


@pytest.mark.parametrize("sk", [40, 24], ids=["self", "cross"])
def test_dot_product_attention_gradients_match_jax(sk):
    """dq, dk and dv through the port's dispatch (K5 and K6's plain
    versions) against jax.grad of the JAX package's dot_product_attention,
    for a fixed cotangent. Tolerance 1e-5 (fp32)."""
    from xdiffusion_tpu.ops.attention import dot_product_attention as jax_dpa

    from xdiffusion_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(12)
    q, w = _normal(rng, 2, 3, 40, 64), _normal(rng, 2, 3, 40, 64)
    k, v = _normal(rng, 2, 3, sk, 64), _normal(rng, 2, 3, sk, 64)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_dpa(q, k, v) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (dot_product_attention(*leaves) * torch.from_numpy(w)).sum().backward()
    for name, leaf, y in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(y), atol=OPS_TOL,
                                   rtol=OPS_TOL, err_msg=f"d{name}")


# ---- the loss, its gradients and one optimizer step ------------------------------


@pytest.fixture(scope="module")
def ltx_train_pair():
    """(jax model, flax params, port model, drawn flat weights) of the small
    LTX config with the guidance drop off, sharing seeded weights."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxDDPM(JaxDotConfig(_no_guidance_drop(_load_small())))
    # Only the tree's shapes are needed: trace the init, compile nothing.
    init = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}
    drawn = random_flax_params(flat, seed=13)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    pmodel = GaussianDiffusion_DDPM(DotConfig(_no_guidance_drop(_load_small())), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, params, pmodel, drawn


def _video_batch(seed, mask):
    """images (2, 4, 4, 4, 1) in [0, 1], float times, noise, text
    embeddings (2, 8, 32) and a (2, 4) video mask."""
    rng = np.random.default_rng(seed)
    return {"images": rng.random((2, 4, 4, 4, 1)).astype(np.float32),
            "timesteps": np.array([0.2, 0.7], dtype=np.float32),
            "noise": _normal(rng, 2, 4, 4, 4, 1),
            "text_embeddings": _normal(rng, 2, 8, 32),
            "video_mask": np.array(mask, dtype=bool)}


def _grad_errors(grads, net):
    """{port parameter name: max |port grad - JAX grad| / max |JAX grad|}."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(grads["params"]).items()}
    want = {k: v.numpy() for k, v in flax_to_state_dict(flat, net).items()}
    named = dict(net.named_parameters())
    assert set(named) == set(want)
    out = {}
    for name, p in named.items():
        assert p.grad is not None, f"{name} received no gradient"
        scale = max(np.abs(want[name]).max(), 1e-30)
        out[name] = np.abs(p.grad.numpy() - want[name]).max() / scale
    return out


@pytest.mark.parametrize("mask", [[[True] * 4] * 2, [[False, True, True, False],
                                                     [True, False, True, True]]],
                         ids=["all frames", "partial mask"])
def test_ltx_loss_and_every_gradient_match_jax(ltx_train_pair, mask):
    """loss_on_batch and the gradient of every parameter of the tiny LTX
    against jax.value_and_grad of the JAX package's loss_on_batch: shared
    weights, the same text embeddings and video mask, injected times and
    noise, deterministic, no guidance drop. The partial mask keeps the
    frames it marks False at their clean values on both sides. Tolerance:
    the loss 1e-5 relative; each gradient 1e-4 of its own largest magnitude
    (fp32 sums through two blocks in other orders; 1.4e-5 seen, t_fc1)."""
    jmodel, params, pmodel, _ = ltx_train_pair
    batch = _video_batch(14, mask)
    ctx_keys = ("text_embeddings", "video_mask")

    def jax_loss(p, b):
        return jmodel.loss_on_batch(p, jax.random.PRNGKey(1), b["images"],
                                    {k: b[k] for k in ctx_keys}, timesteps=b["timesteps"],
                                    noise=b["noise"], deterministic=True)

    (want_loss, want_metrics), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    net = pmodel.score_network()
    net.zero_grad(set_to_none=True)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = pmodel.loss_on_batch(t["images"], {k: t[k] for k in ctx_keys},
                                         timesteps=t["timesteps"], noise=t["noise"],
                                         deterministic=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss_per_example"].numpy(),
                               np.asarray(want_metrics["loss_per_example"]), rtol=1e-5)
    errors = _grad_errors(grads, net)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_TOL, f"{worst}: max|dg|/max|g| = {errors[worst]:.2e}"


def test_video_mask_keeps_conditioning_frames_clean(ltx_train_pair, monkeypatch):
    """The network sees x_t where the mask is True and the clean frames
    (scaled to [-1, 1]) where it is False, and finds them in context["x0"]."""
    _, _, pmodel, _ = ltx_train_pair
    batch = _video_batch(15, [[False, True, True, False], [True, True, True, True]])
    seen = {}

    def spy(x, context):
        seen.update(x=x.detach().clone(), x0=context["x0"])
        return torch.zeros_like(x)

    monkeypatch.setattr(pmodel, "predict_score", spy)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    pmodel.loss_on_batch(t["images"], {"video_mask": t["video_mask"],
                                       "text_embeddings": t["text_embeddings"]},
                         timesteps=t["timesteps"], noise=t["noise"], deterministic=True)
    z0 = t["images"] * 2 - 1
    torch.testing.assert_close(seen["x0"], z0, atol=0, rtol=0)
    torch.testing.assert_close(seen["x"][0, [0, 3]], z0[0, [0, 3]], atol=0, rtol=0)
    assert (seen["x"][0, 1:3] - z0[0, 1:3]).abs().min() > 0
    assert (seen["x"][1] - z0[1]).abs().min() > 0


def test_one_train_step_matches_jax(ltx_train_pair, monkeypatch):
    """One step of the port's make_train_step (loss, backward, global-norm
    clip, Adam at the config's defaults) against the JAX package's
    make_train_step from the same weights and batch, with the noise injected
    and dropout off on both sides: the loss, the gradient norm and every
    parameter after the step. Tolerance: 1e-5 relative on loss and norm.
    Adam's first update is lr * g / (|g| + eps) (lr 2e-4, eps 1e-8), so two
    gradients that differ by dg (up to 1e-4 of their tensor's largest, as
    the gradient test holds them) give updates that differ by at most
    lr * dg * eps / ((|g| - dg)+ + eps)^2, and by at most 2 lr: each
    parameter is held to that bound at its own (clipped) gradient, plus
    1e-5 of lr (optax and torch round the bias corrections of the update
    differently: 1e-6 of lr seen) and two fp32 ulps of the parameter (the
    sum p + update)."""
    from xdiffusion_tpu.parallel.train_step import create_train_state as jax_state
    from xdiffusion_tpu.parallel.train_step import make_train_step as jax_step
    from xdiffusion_tpu.training.image.train import build_optimizer as jax_optimizer

    from xdiffusion_tpu_torch.optim import DEFAULT_LR
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import build_optimizer
    from xdiffusion_tpu_torch.weights import flax_to_state_dict, load_flax_params

    jmodel, params, pmodel, drawn = ltx_train_pair
    load_flax_params(pmodel.score_network(), drawn)  # undo earlier tests' in-place steps
    batch = _video_batch(16, [[True] * 4, [True, False, True, True]])
    noise = batch.pop("noise")
    monkeypatch.setattr(jmodel, "loss_on_batch", functools.partial(
        type(jmodel).loss_on_batch, jmodel, noise=jnp.asarray(noise), deterministic=True))
    monkeypatch.setattr(pmodel, "loss_on_batch", functools.partial(
        type(pmodel).loss_on_batch, pmodel, noise=torch.from_numpy(noise), deterministic=True))

    tx = jax_optimizer(jmodel.config())
    state = jax_state(jax.tree_util.tree_map(jnp.copy, params), tx)
    state, want = jax_step(jmodel, tx)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.PRNGKey(2))
    net = pmodel.score_network()
    pstate = create_train_state(pmodel, build_optimizer(pmodel.config(), net.parameters()))
    got = make_train_step(pmodel)(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert pstate.step == 1
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-5)
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(state.params["params"]).items()}
    after = flax_to_state_dict(flat, net)
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
    assert moved > 1e-4  # the step moved the parameters


# ---- the host pipeline ---------------------------------------------------------


def test_moving_mnist_synthesis_and_batches_equal_jax():
    """synthesize_moving_mnist and the first batches of the iterator
    (epoch order, gather, uint8 * float32(1/255)) equal the JAX package's
    bit for bit for the same seeds."""
    from xdiffusion_tpu.datasets import moving_mnist as jax_mm
    from xdiffusion_tpu.training.video.train import video_batch_iterator

    from xdiffusion_tpu_torch.datasets import moving_mnist
    from xdiffusion_tpu_torch.datasets.utils import batch_iterator

    videos, labels = moving_mnist.synthesize_moving_mnist(12, num_frames=6, image_size=8,
                                                          seed=3)
    want_v, want_l = jax_mm.synthesize_moving_mnist(12, num_frames=6, image_size=8, seed=3)
    assert videos.dtype == np.uint8 and videos.shape == (12, 6, 8, 8, 1) and videos.any()
    np.testing.assert_array_equal(videos, want_v)
    np.testing.assert_array_equal(labels, want_l)

    ds = moving_mnist.MovingMNIST.__new__(moving_mnist.MovingMNIST)
    ds.videos, ds.labels = videos, labels
    ours, theirs = batch_iterator(ds, 5, seed=4), video_batch_iterator(ds, 5, seed=4)
    for _ in range(4):  # crosses an epoch (12 // 5 = 2 batches each)
        got, (want_videos, want_labels) = next(ours), next(theirs)
        assert got["videos"].dtype == np.float32
        np.testing.assert_array_equal(got["videos"], want_videos)
        np.testing.assert_array_equal(got["classes"], want_labels)


@pytest.mark.parametrize("frames,image_batch", [(6, False), (3, False), (4, False), (6, True)],
                         ids=["crop", "tile", "as is", "image batch"])
def test_training_batch_preparation_equals_jax(frames, image_batch):
    """get_training_batch, then preprocess_training_videos with the mask
    generator (OpenSora masks with every mode), from generators with the same
    seed: the videos, frame indices and masks equal the JAX package's bit
    for bit, and both generators end in the same state."""
    from xdiffusion_tpu import masking as jax_masking
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.training_utils import get_training_batch as jax_get
    from xdiffusion_tpu.training_utils import preprocess_training_videos as jax_pre

    from xdiffusion_tpu_torch import masking
    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.training_utils import get_training_batch, preprocess_training_videos

    ratios = {name: 0.09 for name in masking.OpenSoraMaskGenerator.VALID if name != "identity"}
    videos = np.random.default_rng(5).random((6, frames, 4, 4, 1)).astype(np.float32)
    outs = []
    for pkg_get, pkg_pre, gen, cfg in (
            (get_training_batch, preprocess_training_videos,
             masking.OpenSoraMaskGenerator(ratios), DotConfig(_load_small())),
            (jax_get, jax_pre, jax_masking.OpenSoraMaskGenerator(ratios),
             JaxDotConfig(_load_small()))):
        rng = np.random.default_rng(6)
        v = pkg_get(videos, image_batch, rng=rng)
        v, ctx = pkg_pre(v, cfg, mask_generator=None if image_batch else gen, rng=rng)
        outs.append((v, ctx, rng.random()))
    (v, ctx, tail), (want_v, want_ctx, want_tail) = outs
    assert v.shape == (6, 4, 4, 4, 1)
    np.testing.assert_array_equal(v, want_v)
    assert set(ctx) == set(want_ctx) and tail == want_tail
    np.testing.assert_array_equal(ctx["frame_indices"], want_ctx["frame_indices"])
    if not image_batch:
        assert ctx["video_mask"].dtype == bool and ctx["x0"] is None
        np.testing.assert_array_equal(ctx["video_mask"], want_ctx["video_mask"])


@pytest.mark.parametrize("kind", ["base", "identity", "opensora"])
def test_mask_generators_equal_jax(kind):
    """The three mask generators against the JAX package's, 64 examples of
    16 frames from generators with the same seed (OpenSora: every mode, the
    rest identity)."""
    from xdiffusion_tpu import masking as jax_masking

    from xdiffusion_tpu_torch import masking

    if kind == "base":
        with pytest.raises(NotImplementedError):
            masking.MaskGenerator().get_masks((2, 4))
        return
    if kind == "identity":
        ours, theirs = masking.IdentityMaskGenerator(), jax_masking.IdentityMaskGenerator()
    else:
        ratios = {n: 0.08 for n in masking.OpenSoraMaskGenerator.VALID if n != "identity"}
        ours = masking.OpenSoraMaskGenerator(ratios)
        theirs = jax_masking.OpenSoraMaskGenerator(ratios)
    got = ours.get_masks((64, 16), rng=np.random.default_rng(7))
    want = theirs.get_masks((64, 16), rng=np.random.default_rng(7))
    assert got.shape == (64, 16) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    if kind == "opensora":
        assert 0 < (~got).sum() and got.all(axis=1).any()


def test_prompts_from_labels():
    """One surface form per digit, drawn from the generator given."""
    from xdiffusion_tpu_torch.datasets.moving_mnist import convert_labels_to_prompts

    labels = np.array([[3], [0], [7]], dtype=np.int32)
    a = convert_labels_to_prompts(labels, rng=np.random.default_rng(8))
    assert a == convert_labels_to_prompts(labels, rng=np.random.default_rng(8))
    assert all(p in (f, str(d)) for p, f, d in zip(a, ("three", "zero", "seven"), (3, 0, 7)))
    assert convert_labels_to_prompts(np.array([[1, 2]]), rng=np.random.default_rng(0))[0] in (
        "one and two", "one and 2", "1 and two", "1 and 2")


# ---- the video training CLI --------------------------------------------------------


def _tiny_config_file(tmp_path):
    cfg = _load_small()
    cfg["data"].update(image_size=4, input_number_of_frames=4)
    path = tmp_path / "ltx_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_train_video_cli_on_cpu_and_bit_exact_resume(tmp_path, monkeypatch):
    """3 steps at batch 2 of the tiny LTX on the synthetic Moving-MNIST
    write metrics.jsonl, checkpoints and frame strips; a resume from the
    step-2 checkpoint repeats the third step's loss bit for bit (host draws
    seeded by (seed, step), the device generator restored)."""
    from PIL import Image

    from xdiffusion_tpu_torch import train_video as cli

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = _tiny_config_file(tmp_path)
    common = ["--config_path", config, "--batch_size", "2", "--device", "cpu",
              "--save_and_sample_every_n", "2", "--sampling_steps", "2", "--num_samples", "3"]
    run = cli.main(common + ["--num_training_steps", "3",
                             "--output_path", str(tmp_path / "run")])
    metrics = _metrics(run)
    assert sorted(metrics) == [0, 2]  # every 50th step and the last
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in metrics.values())
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2.pt", "3.pt"]
    strip = np.asarray(Image.open(os.path.join(run, "sample-3.png")))
    assert strip.shape == (3 * 4, 4 * 4)  # a row per video, its 4 frames side by side

    resumed = cli.main(common + ["--num_training_steps", "3",
                                 "--output_path", str(tmp_path / "resumed"),
                                 "--resume_from", os.path.join(run, "checkpoints", "2.pt")])
    assert sorted(_metrics(resumed)) == [2]
    assert _metrics(resumed)[2]["loss"] == metrics[2]["loss"]


def test_train_video_needs_a_card_or_cpu_and_refuses_unported_options(tmp_path, monkeypatch):
    from xdiffusion_tpu_torch import train_video as cli

    config = _tiny_config_file(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config_path", config, "--output_path", str(tmp_path)])
    # The image-to-video warm start is ported (tests/test_torch_port_long_video.py):
    # temporal-only training needs a checkpoint to start from, as JAX
    # asserts, and a missing one is not found. A pixel-space config ignores
    # the VAE checkpoint, as the JAX trainer does (no step is run here; the
    # latent path is tests/test_torch_port_latent.py's).
    for flags, error in ((["--train_temporal_modules_only"], ValueError),
                         (["--load_vae_weights_from_checkpoint", "vae.pt",
                           "--num_training_steps", "0"], None),
                         (["--load_model_weights_from_checkpoint", "image.pt"],
                          FileNotFoundError)):
        args = ["--config_path", config, "--device", "cpu", "--output_path", str(tmp_path)] + flags
        if error is None:
            assert os.path.isdir(cli.main(args))
            continue
        with pytest.raises(error):
            cli.main(args)
