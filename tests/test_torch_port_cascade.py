"""Super-resolution and cascades in the port against the JAX package on the
CPU: `InputPreprocessor` (bilinear upsampling, Gaussian conditioning
augmentation at a random, a fixed and a given timestep) and the
augmentation head with JAX's own draws replayed from its keys and injected;
the resize against `jax.image.resize`; the Efficient UNet's forward and every
gradient at num_features 32; both cascades' loss (per stage, summed) and a
chained sample with every draw of JAX's key chain injected (initial noise,
per-step noise, per-step augmentation noise of the guided double batch);
the five configs built at full width with JAX's parameter counts; both
cascades through the training and sampling CLIs with a resume; an SR stage
trained alone failing as in JAX.

Tiny configs (`tiny_stage`): num_features 32 (the embeddings as shipped),
the first two levels (each keeps its attention), one residual block a level
(the Efficient UNet's [1, 2]), dropout and the guidance drop off, 100
scheduler steps (the linear schedule's betas, scaled by 1000 / steps, pass 1
at 10); the cascades point at those stage files.

The JAX package cannot sample a GCA stage with guidance at batch 2: its
guided merge concatenates every context value whose leading axis is the
batch, and the (2,) PRNG key `preprocessor_rng` is then one (test
`test_chained_sample_matches_jax_with_its_draws` samples 3)."""

import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import GRAD_TOL, _grad_errors

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "configs/image/mnist")
CASCADES = {"ddpm_cascade_8x8_to_32x32": ("ddpm_8x8_epsilon", "ddpm_sr3"),
            "imagen": ("imagen_base", "imagen_8x8_to_32x32")}
PROMPTS = ["3", "seven"]


def tiny_stage(name: str, directory, guidance_drop: float = 0.0, steps: int = 100) -> str:
    """The stage config at tiny size with `steps` scheduler steps, written
    to `directory`; its path."""
    with open(os.path.join(MNIST, name + ".yaml")) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    sn = diff["score_network"]["params"]
    sn.update(num_features=32, dropout=0.0, channel_multipliers=sn["channel_multipliers"][:2],
              num_resnet_blocks=[1, 2] if isinstance(sn["num_resnet_blocks"], list) else 1)
    sn["conditioning"]["context_transformer_layer"]["params"]["dropout"] = 0.0
    diff["classifier_free_guidance"]["unconditional_guidance_probability"] = guidance_drop
    sched = diff["noise_scheduler"]["params"]
    sched["num_scales"] = sched["importance_sampler"]["params"]["num_timesteps"] = steps
    path = os.path.join(str(directory), name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def tiny_cascade(name: str, directory, guidance_drop: float = 0.0, steps: int = 100) -> str:
    stages = [tiny_stage(s, directory, guidance_drop, steps) for s in CASCADES[name]]
    with open(os.path.join(MNIST, name + ".yaml")) as f:
        cfg = yaml.safe_load(f)
    for k, path in enumerate(stages):
        cfg["diffusion_cascade"][f"cascade_layer_{k + 1}"]["config"] = path
    path = os.path.join(str(directory), name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@contextlib.contextmanager
def no_transformers():
    """JAX's T5 prompt tokenizer looks for a cached `transformers` tokenizer
    when it is built (an import that costs some 10 s) and takes its BPE
    fallback when there is none, as here: with the import refused it takes
    the fallback at once."""
    saved = sys.modules.get("transformers")
    sys.modules["transformers"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved


def few_digits(monkeypatch, tmp_path, n: int = 512) -> None:
    """The trainer's synthetic digits (no MNIST files under the data
    directory) cut from 60,000 to n: their one-time resize to 32 pixels
    takes seconds at 60,000."""
    from xdiffusion_tpu_torch.datasets import synthetic

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    generate = synthetic.generate_digits
    monkeypatch.setattr(synthetic, "generate_digits", lambda count, seed: generate(n, seed=seed))


def offline_preprocessors(jmodel) -> None:
    from test_torch_port_mmdit import offline

    for layer in jmodel.models():
        offline(layer._context_preprocessors)
        for pre in layer._context_preprocessors:
            assert getattr(pre, "_tokenizer", None) is None  # the BPE fallback


_BUILT = {}


def build_cascade(name: str, tmp_path_factory):
    """(JAX cascade, its params {"stage_k": {"params": ...}}, the port
    cascade on the CPU) sharing seeded weights, built once."""
    if name not in _BUILT:
        from xdiffusion_tpu.config import load_yaml as jax_load_yaml
        from xdiffusion_tpu.diffusion.cascade import GaussianDiffusionCascade as JaxCascade

        from xdiffusion_tpu_torch.config import load_yaml
        from xdiffusion_tpu_torch.diffusion.cascade import GaussianDiffusionCascade

        path = tiny_cascade(name, tmp_path_factory.mktemp(name))
        with no_transformers():
            jmodel = JaxCascade(jax_load_yaml(path))
        offline_preprocessors(jmodel)
        shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
        flat = {}
        for stage, tree in shapes.items():
            for k, v in traverse_util.flatten_dict(tree["params"]).items():
                flat["/".join((stage,) + k)] = v
        drawn = random_flax_params(flat, seed=5)
        params = {}
        for key, value in drawn.items():
            stage, _, rest = key.partition("/")
            params.setdefault(stage, {})[tuple(rest.split("/"))] = jnp.asarray(value)
        params = {s: {"params": traverse_util.unflatten_dict(t)} for s, t in params.items()}
        pmodel = GaussianDiffusionCascade(load_yaml(path), device="cpu")
        load_flax_params(pmodel.score_network(), drawn)
        _BUILT[name] = jmodel, params, pmodel
    return _BUILT[name]


def _scaled_close(got, want, rel: float) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * max(1.0, np.abs(want).max()),
                               rtol=0)


# ---- resizing ------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(32, 8), (32, 16), (8, 32), (16, 32), (8, 8)])
def test_resize_matches_jax_image_resize(src, dst):
    """`resize_bilinear`, the cascade's and the input preprocessor's resize
    (antialiased when shrinking), against jax.image.resize(...,
    "bilinear") on random [0, 1] images: 2e-7."""
    from xdiffusion_tpu_torch.layers.super_resolution import resize_bilinear

    x = np.random.default_rng(src + dst).random((3, src, src, 2)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (3, dst, dst, 2), method="bilinear")
    got = resize_bilinear(torch.from_numpy(x), dst)
    assert tuple(got.shape) == (3, dst, dst, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-7, rtol=0)


# ---- the input preprocessor and the augmentation head ------------------------


def _sr3_schedulers():
    from xdiffusion_tpu.config import instantiate_from_config as jax_instantiate
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml

    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml

    path = os.path.join(MNIST, "ddpm_sr3.yaml")
    return (jax_instantiate(jax_load_yaml(path).diffusion.noise_scheduler.to_dict()),
            instantiate_from_config(load_yaml(path).diffusion.noise_scheduler.to_dict()))


@pytest.mark.parametrize("case", ["random", "level", "given"])
def test_input_preprocessor_matches_jax_with_its_draws(case):
    """The SR3 stage's preprocessor on 8x8 conditioning and a 32x32 x, with
    the shipped 1000-step cosine schedule: the augmentation timestep (JAX's
    randint from its key, int(1000 * f32(0.1)) = 100 for the fixed level,
    or the given one) and the concatenated input, JAX's normal draw of
    fold_in(preprocessor_rng, 1) injected: fp32, 1e-6."""
    from xdiffusion_tpu.layers.super_resolution import InputPreprocessor as JaxPre

    from xdiffusion_tpu_torch.layers.super_resolution import InputPreprocessor

    kw = dict(low_resolution_size=8, super_resolution_size=32,
              context_input_key="low_resolution_images",
              apply_gaussian_conditioning_augmentation=True)
    jsched, psched = _sr3_schedulers()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 32, 32, 1)).astype(np.float32)
    low = rng.random((3, 8, 8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jctx = {"low_resolution_images": jnp.asarray(low), "preprocessor_rng": key}
    pctx = {"low_resolution_images": torch.from_numpy(low)}
    if case == "level":
        jctx["augmentation_level"] = pctx["augmentation_level"] = 0.1
    if case == "given":
        given = np.int32([0, 500, 999])
        jctx["augmentation_timestep"] = jnp.asarray(given)
        pctx["augmentation_timestep"] = torch.from_numpy(given).long()
    want = JaxPre(**kw)(jnp.asarray(x), jctx, noise_scheduler=jsched)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (3, 32, 32, 1))
    pctx["augmentation_noise"] = torch.from_numpy(np.array(noise))
    if case == "random":  # JAX's draw: randint on the first half of its key's split
        pctx["augmentation_timestep"] = torch.from_numpy(np.asarray(
            jsched.sample_random_times(jax.random.split(key)[0], 3)[0])).long()
    got = InputPreprocessor(**kw)(torch.from_numpy(x), pctx, noise_scheduler=psched)
    assert tuple(got.shape) == (3, 32, 32, 2)
    np.testing.assert_array_equal(pctx["augmentation_timestep"].numpy(),
                                  np.asarray(jctx["augmentation_timestep"]))
    if case == "level":
        assert pctx["augmentation_timestep"].tolist() == [100, 100, 100]
    np.testing.assert_array_equal(got[..., :1].numpy(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_input_preprocessor_draws_from_its_generator_and_refuses_temporal():
    """Without an injection the augmentation draws its timesteps and noise
    from context["preprocessor_generator"]: the same seed repeats them,
    another changes them, timesteps in [0, 1000); without a generator it
    raises; GCA off leaves the upsampled conditioning clean, on images and
    on 5-D videos (the spatial branch resizes only the two trailing spatial
    axes of each frame); the temporal branch (frame repetition, 3 frames to
    6) equals JAX's without augmentation and draws its augmentation from the
    generator too. (Its name is older than the temporal branch's port.)"""
    from xdiffusion_tpu_torch.layers.super_resolution import InputPreprocessor, resize_bilinear

    _, sched = _sr3_schedulers()
    kw = dict(low_resolution_size=8, super_resolution_size=32,
              context_input_key="low_resolution_images")
    low = torch.rand(4, 8, 8, 1, generator=torch.Generator().manual_seed(0))
    x = torch.zeros(4, 32, 32, 1)

    def run(seed):
        ctx = {"low_resolution_images": low,
               "preprocessor_generator": torch.Generator().manual_seed(seed)}
        out = InputPreprocessor(apply_gaussian_conditioning_augmentation=True, **kw)(
            x, ctx, noise_scheduler=sched)
        return out, ctx["augmentation_timestep"]

    (a, ta), (b, tb), (c, tc) = run(1), run(1), run(2)
    assert torch.equal(a, b) and torch.equal(ta, tb) and not torch.equal(a, c)
    assert ta.dtype == torch.long and bool(((ta >= 0) & (ta < 1000)).all())
    with pytest.raises(ValueError, match="preprocessor_generator"):
        InputPreprocessor(apply_gaussian_conditioning_augmentation=True, **kw)(
            x, {"low_resolution_images": low}, noise_scheduler=sched)
    clean = InputPreprocessor(apply_gaussian_conditioning_augmentation=False, **kw)(
        x, {"low_resolution_images": low}, noise_scheduler=sched)
    assert torch.equal(clean[..., 1:], resize_bilinear(low, 32) * 2 - 1)
    frames = torch.rand(2, 3, 8, 8, 1, generator=torch.Generator().manual_seed(1))
    video = InputPreprocessor(apply_gaussian_conditioning_augmentation=False, **kw)(
        torch.zeros(2, 3, 32, 32, 1), {"low_resolution_images": frames})
    assert tuple(video.shape) == (2, 3, 32, 32, 2)
    for f in range(3):
        assert torch.equal(video[:, f, ..., 1:], resize_bilinear(frames[:, f], 32) * 2 - 1)
    from xdiffusion_tpu.layers.super_resolution import InputPreprocessor as JaxPre

    tkw = dict(low_resolution_size=3, super_resolution_size=6, is_spatial=False,
               is_temporal=True, context_input_key="low_resolution_images")
    x = torch.zeros(2, 6, 8, 8, 1)
    temporal = InputPreprocessor(apply_gaussian_conditioning_augmentation=False, **tkw)(
        x, {"low_resolution_images": frames})
    want = JaxPre(apply_gaussian_conditioning_augmentation=False, **tkw)(
        jnp.asarray(x.numpy()), {"low_resolution_images": jnp.asarray(frames.numpy())})
    assert tuple(temporal.shape) == (2, 6, 8, 8, 2)
    np.testing.assert_array_equal(temporal.numpy(), np.asarray(want))
    ctx = {"low_resolution_images": frames, "preprocessor_generator": torch.Generator()}
    augmented = InputPreprocessor(apply_gaussian_conditioning_augmentation=True, **tkw)(
        x, ctx, noise_scheduler=sched)
    assert ctx["augmentation_timestep"].shape == (2,)
    assert not torch.equal(augmented, temporal)


def test_augmentation_head_matches_jax():
    """GaussianConditioningAugmentationToTimestep with its projection
    (num_features 128, x4) on carried weights: timestep_embedding plus the
    projected augmentation timestep, fp32, 1e-5 of the scale (XLA's and
    torch's fp32 sin and cos round apart at arguments near 999)."""
    from test_torch_port_text import _shared as shared_weights
    from xdiffusion_tpu.layers.super_resolution import (
        GaussianConditioningAugmentationToTimestep as JaxHead,
    )

    from xdiffusion_tpu_torch.layers.super_resolution import (
        GaussianConditioningAugmentationToTimestep,
    )

    jhead, phead = JaxHead(128, 4), GaussianConditioningAugmentationToTimestep(128, 4)
    jproj, pproj = jhead.make_projection(), phead.make_projection()
    t = np.int32([0, 100, 999])
    params = shared_weights(jproj, pproj, jnp.asarray(t))
    emb = np.random.default_rng(6).standard_normal((3, 512)).astype(np.float32)
    want = jhead({"timestep_embedding": jnp.asarray(emb), "augmentation_timestep": jnp.asarray(t)},
                 {"augmentation_timestep": jproj.bind(params)})["timestep_embedding"]
    with torch.no_grad():
        got = phead({"timestep_embedding": torch.from_numpy(emb),
                     "augmentation_timestep": torch.from_numpy(t).long()},
                    {"augmentation_timestep": pproj})["timestep_embedding"]
    _scaled_close(got.numpy(), want, 1e-5)
    with pytest.raises(AssertionError):
        phead({"timestep_embedding": torch.from_numpy(emb)}, {"augmentation_timestep": pproj})


# ---- the stages and the cascades ----------------------------------------------


def _stage_draws(jstage, key, b: int, shape):
    """The draws JAX's stage loss makes from `key` (timesteps, noise, and for
    a super-resolution stage the augmentation timestep and noise of
    preprocessor_rng = fold_in(rng_drop, 7)), as the port's injections."""
    rng_t, rng_eps, _, rng_drop, _ = jax.random.split(key, 5)
    sched = jstage.noise_scheduler()
    t = np.asarray(sched.sample_random_times(rng_t, b)[0])
    out = {"timesteps": torch.from_numpy(t).long(),
           "noise": torch.from_numpy(np.asarray(jax.random.normal(rng_eps, shape)))}
    if "super_resolution" in jstage.config():
        prep = jax.random.fold_in(rng_drop, 7)
        s = np.asarray(sched.sample_random_times(jax.random.split(prep)[0], b)[0])
        noise = jax.random.normal(jax.random.fold_in(prep, 1), shape)
        out["context"] = {"augmentation_timestep": torch.from_numpy(s).long(),
                          "augmentation_noise": torch.from_numpy(np.asarray(noise))}
    return out


def _prompts(jmodel, pmodel, n: int):
    """Prompt tokens for a text cascade on each side, else empty contexts."""
    if not any(type(p).__name__ != "IgnoreContextAdapter" for p in pmodel._context_preprocessors):
        return {}, {}
    prompts = [PROMPTS[i % 2] for i in range(n)]
    jctx = jmodel.models()[0].preprocess_context({"text_prompts": prompts})
    pctx = pmodel.preprocess_context({"text_prompts": prompts})
    assert sorted(pctx) == ["text_tokens"]
    np.testing.assert_array_equal(pctx["text_tokens"].numpy(), np.asarray(jctx["text_tokens"]))
    return {"text_tokens": jctx["text_tokens"]}, pctx


@pytest.mark.parametrize("name", list(CASCADES))
def test_cascade_loss_matches_jax_with_its_draws(name, tmp_path_factory):
    """The cascade's summed loss and each `stage_k_loss` at 32x32 (stage 1
    on the images resized to 8x8, stage 2 conditioned on them), with every
    draw of JAX's per-stage keys injected, against the jitted JAX loss: 1e-5
    relative; for imagen (the Efficient UNet, its augmentation head, the
    text stages) every parameter's gradient against jax.value_and_grad, to
    GRAD_TOL. (The SR3 stage's UNet gradients are the flagship UNet's,
    tests/test_torch_port_grad.py.)"""
    jmodel, params, pmodel = build_cascade(name, tmp_path_factory)
    net = pmodel.score_network()
    net.zero_grad(set_to_none=True)
    images = np.random.default_rng(8).random((2, 32, 32, 1)).astype(np.float32)
    jctx, pctx = _prompts(jmodel, pmodel, 2)
    key = jax.random.PRNGKey(3)

    def jax_loss(p):
        return jmodel.loss_on_batch(p, key, jnp.asarray(images), jctx)

    grads = None
    if name == "imagen":
        (want, want_m), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    else:
        want, want_m = jax.jit(jax_loss)(params)
    draws, rng = [], key
    for layer in jmodel.models():
        rng, sub = jax.random.split(rng)
        size = layer.config().data.image_size
        draws.append(_stage_draws(layer, sub, 2, (2, size, size, 1)))
    got, got_m = pmodel.loss_on_batch(torch.from_numpy(images), pctx, deterministic=True,
                                      stage_noise=draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("stage_1_loss", "stage_2_loss"):
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-5)
    if grads is None:
        return
    got.backward()
    errors = _grad_errors({"params": {k: g["params"] for k, g in grads.items()}}, net)
    worst = max(errors, key=errors.get)
    assert len(errors) == sum(1 for _ in net.parameters())
    assert errors[worst] <= GRAD_TOL, f"{worst}: {errors[worst]:.2e}"
    net.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name", list(CASCADES))
def test_chained_sample_matches_jax_with_its_draws(name, tmp_path_factory):
    """cascade.sample for 10 steps (stage 1 at 8x8, its
    samples the conditioning of stage 2 at 32x32, augmented to the fixed
    level 0.1, step 10 of 100, at every step), imagen with prompts and its guidance (one
    forward on the doubled batch, dynamic thresholding), every draw of
    JAX's key chain injected: each stage's initial noise, per-step noise
    and per-step augmentation noise (of the doubled batch when guided).
    1e-3 on samples in [0, 1]."""
    jmodel, params, pmodel = build_cascade(name, tmp_path_factory)
    n, steps = 3, 10
    jctx, pctx = ({}, {})
    guidance = None
    if name == "imagen":
        jctx = {"text_prompts": PROMPTS + PROMPTS[:1]}
        pctx = {"text_prompts": PROMPTS + PROMPTS[:1]}
        guidance = 1.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(jmodel.sample(params, key, num_samples=n, context=jctx,
                                    classifier_free_guidance=guidance, num_sampling_steps=steps))
    stage_noise, rng = [], key
    for layer in jmodel.models():
        rng, sub = jax.random.split(rng)
        inner, init_rng = jax.random.split(sub)
        size = layer.config().data.image_size
        shape = (n, size, size, 1)
        step_keys = []
        for _ in range(steps):
            inner, step_key = jax.random.split(inner)
            step_keys.append(step_key)
        inject = {"initial_noise": torch.from_numpy(np.asarray(jax.random.normal(init_rng, shape))),
                  "context": {"sampling_noise": torch.from_numpy(np.stack(
                      [np.asarray(jax.random.normal(k, shape)) for k in step_keys]))}}
        if "super_resolution" in layer.config():
            rows = 2 * n if guidance is not None else n
            inject["context"]["sampling_augmentation_noise"] = torch.from_numpy(np.stack(
                [np.asarray(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k, 3), 1),
                                              (rows, size, size, 1))) for k in step_keys]))
        stage_noise.append(inject)
    got = pmodel.sample(num_samples=n, context=pctx, classifier_free_guidance=guidance,
                        num_sampling_steps=steps, stage_noise=stage_noise)
    assert tuple(got.shape) == want.shape == (n, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", ["ddpm_sr3", "imagen_8x8_to_32x32"] + list(CASCADES))
def test_config_builds_at_full_width_with_jax_parameter_count(name):
    """The shipped config builds with the port on the CPU (a cascade's
    stages in one ModuleDict), fp32, with as many parameters as the JAX
    package's networks (shapes from jax.eval_shape of init)."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.training.image.train import build_model as jax_build

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    path = os.path.join(MNIST, name + ".yaml")
    net = build_model(load_yaml(path), device="cpu").score_network()
    with no_transformers():
        jmodel = jax_build(jax_load_yaml(path))
    if name in CASCADES:
        offline_preprocessors(jmodel)
        shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
        assert sorted(net.keys()) == sorted(shapes) == ["stage_1", "stage_2"]
    else:
        from test_torch_port_mmdit import offline

        offline(jmodel._context_preprocessors)
        x, ctx = jmodel.example_batch(2)
        shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in net.parameters()) == want
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_sr_stage_trained_alone_fails_as_in_jax(tmp_path, monkeypatch):
    """The trainer gives a super-resolution stage no low-resolution images,
    in JAX (whose first loss raises KeyError: 'low_resolution_images') and
    in the port alike."""
    from xdiffusion_tpu_torch import train as train_cli

    few_digits(monkeypatch, tmp_path)
    config = tiny_stage("ddpm_sr3", tmp_path)
    with pytest.raises(KeyError, match="low_resolution_images"):
        train_cli.main(["--config_path", config, "--batch_size", "2", "--num_training_steps",
                        "1", "--output_path", str(tmp_path / "run"), "--device", "cpu"])


@pytest.mark.parametrize("name", list(CASCADES))
def test_cascade_through_the_training_and_sampling_clis(name, tmp_path, monkeypatch):
    """The tiny cascade (with imagen's guidance drop at 0.1) through the
    training CLI for 3 steps at batch 2, both stages in each step (their
    losses logged, one checkpoint holding `stage_1.*` and `stage_2.*`, a
    32x32 grid chained through both); a resume from step 2 repeats step 3's
    loss bit for bit; the sampling CLI chains both stages from the
    checkpoint (imagen with prompts and guidance)."""
    from PIL import Image

    from xdiffusion_tpu_torch import sample as sample_cli
    from xdiffusion_tpu_torch import train as train_cli

    few_digits(monkeypatch, tmp_path)
    config = tiny_cascade(name, tmp_path, guidance_drop=0.1 if name == "imagen" else 0.0,
                          steps=25)
    common = ["--config_path", config, "--batch_size", "2", "--save_and_sample_every_n", "2",
              "--num_samples", "2", "--device", "cpu"]
    run = train_cli.main(common + ["--num_training_steps", "3",
                                   "--output_path", str(tmp_path / "run")])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = {r["step"]: r for r in map(json.loads, f)}
    assert sorted(metrics) == [0, 2]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in metrics.values())
    ckpt = os.path.join(run, "checkpoints", "3.pt")
    keys = torch.load(ckpt, weights_only=True)["params"].keys()
    assert {k.split(".")[0] for k in keys} == {"stage_1", "stage_2"}
    assert np.asarray(Image.open(os.path.join(run, "sample-3.png"))).shape == (32, 64)
    resumed = train_cli.main(common + ["--num_training_steps", "3", "--output_path",
                                       str(tmp_path / "resumed"), "--resume_from",
                                       os.path.join(run, "checkpoints", "2.pt")])
    with open(os.path.join(resumed, "metrics.jsonl")) as f:
        again = {r["step"]: r for r in map(json.loads, f)}
    assert again[2]["loss"] == metrics[2]["loss"]
    args = ["--config_path", config, "--checkpoint", ckpt, "--num_samples", "3",
            "--sampling_steps", "3", "--output_path", str(tmp_path / "s"), "--device", "cpu"]
    if name == "imagen":
        args += ["--text_prompts", "0,1", "--guidance", "1.0"]
    samples = sample_cli.main(args)
    assert tuple(samples.shape) == (3, 32, 32, 1) and bool(torch.isfinite(samples).all())
    assert os.path.getsize(tmp_path / "s" / "sample-step3.png") > 0
