"""Class-label conditioning in the port against the JAX package on the CPU:
`LabelEmbeddingProjection` (its NULL row, id num_classes) and the four
UNets built class-conditional at small width (the tiny flagship `Unet`,
the video `Unet` and the pseudo-3D `Unet` of the video fixtures inside
`video_diffusion_models.yaml`'s process, the `EfficientUNet` fixture inside
the flagship's), each with classifier-free guidance through
`UnconditionalClassesAdapter`: forward, loss with injected times and noise,
and a 10-step guided trajectory with injected noise, on shared seeded
weights; and a tiny class-conditional config through the training CLI.

fp32 throughout: forwards 2e-5 of the output's scale, losses 1e-5
relative, trajectories 1e-3 on samples in [0, 1] (sums in other orders)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import no_transformers, one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import _flat, _tree
from test_torch_port_importers import _image_process
from test_torch_port_train import _mnist_dir, tiny_config
from test_torch_port_video_unet import video_config

CLASS_GUIDANCE = {
    "classifier_free_guidance": 2.0,
    "unconditional_guidance_probability": 0.0,
    "signals": ["classes"],
    "unconditional_context": {"target": "xdiffusion_tpu.context.UnconditionalClassesAdapter",
                              "params": {"num_classes": 10}},
}
NETWORKS = {
    "unet": lambda d: tiny_config(os.path.join(str(d), "unet.yaml"), fast_sampling=True),
    "unet_3d": lambda d: video_config("video_trajectory_parity", d),
    "unet_pseudo3d": lambda d: video_config("make_a_video_parity", d),
    "efficient_unet": lambda d: _image_process("efficient_unet_parity", d),
}
TEXT_TOKENS = {"unet_pseudo3d", "efficient_unet"}  # the fixtures' cross-attention over 6 tokens
CLASSES = np.array([3, 7], dtype=np.int32)


def class_conditional(path: str) -> str:
    """The config at `path` made class-conditional over 10 classes, with
    guidance 2.0 through the NULL row; written back."""
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["score_network"]["params"].update(is_class_conditional=True, num_classes=10)
    cfg["diffusion"]["classifier_free_guidance"] = CLASS_GUIDANCE
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """built(name) -> (JAX process, flax params, port process, extra
    context), shared seeded weights, each network built once."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    cache = {}

    def get(name):
        if name not in cache:
            path = class_conditional(NETWORKS[name](tmp_path_factory.mktemp(name)))
            jmodel = JaxDDPM(jax_load_yaml(path))
            x, ctx = jmodel.example_batch(2)
            extra = {}
            if name in TEXT_TOKENS:
                extra["text_tokens"] = np.random.default_rng(5).integers(
                    0, 50, size=(2, 6)).astype(np.int32)
                ctx["text_tokens"] = jnp.asarray(extra["text_tokens"])
            assert "classes" in ctx
            shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
            drawn = random_flax_params(_flat(shapes["params"]), seed=7)
            assert drawn["_label_projection/embed/embedding"].shape[0] == 11  # the NULL row
            pmodel = GaussianDiffusion_DDPM(load_yaml(path), device="cpu")
            load_flax_params(pmodel.score_network(), drawn)
            cache[name] = jmodel, {"params": _tree(drawn)}, pmodel, extra
        return cache[name]

    return get


def sample_shape(pmodel, n: int = 2):
    return tuple(pmodel.sampling_shape(n))


def contexts(jmodel, pmodel, extra, t, classes=CLASSES):
    jctx = {"classes": jnp.asarray(classes), "timestep": jnp.asarray(t),
            **{k: jnp.asarray(v) for k, v in extra.items()}}
    pctx = {"classes": torch.from_numpy(classes).long(), "timestep": torch.from_numpy(t),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    if pmodel.noise_scheduler().continuous():
        jctx["logsnr_t"] = jmodel.noise_scheduler().logsnr(jnp.asarray(t))
        pctx["logsnr_t"] = pmodel.noise_scheduler().logsnr(torch.from_numpy(t))
    else:
        pctx["timestep"] = pctx["timestep"].long()
    return jctx, pctx


def times(pmodel, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if pmodel.noise_scheduler().continuous():
        return rng.uniform(0.02, 0.98, size=2).astype(np.float32)
    return rng.integers(0, pmodel.noise_scheduler().steps(), size=2).astype(np.int32)


def test_label_embedding_projection_matches_jax():
    """The (num_classes + 1, D) table `embed`: labels 0-9 and the NULL id
    10 look up their rows, in fp32 and in bf16, as flax's nn.Embed does."""
    from xdiffusion_tpu.layers.embedding import LabelEmbeddingProjection as JaxLabel

    from xdiffusion_tpu_torch.layers.embedding import LabelEmbeddingProjection
    from xdiffusion_tpu_torch.weights import load_flax_params

    labels = np.array([0, 3, 9, 10, 10, 5], dtype=np.int32)
    for jdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jmod = JaxLabel(num_classes=10, embedding_dim=24, dtype=jdt)
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(labels))
        port = LabelEmbeddingProjection(10, 24, dtype=pdt)
        assert tuple(port.embed.weight.shape) == (11, 24)
        load_flax_params(port, {k: np.asarray(v) for k, v in _flat(params["params"]).items()})
        want = np.asarray(jmod.apply(params, jnp.asarray(labels)).astype(jnp.float32))
        got = port(torch.from_numpy(labels))
        assert got.dtype == pdt
        np.testing.assert_array_equal(got.detach().float().numpy(), want)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_class_conditional_forward_matches_jax(built, name):
    """One forward at classes (3, 7) and at the NULL class: 2e-5 of the
    output's scale; the label changes the output."""
    jmodel, params, pmodel, extra = built(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(sample_shape(pmodel)).astype(np.float32)
    t = times(pmodel)
    predict = jax.jit(jmodel.predict_score)
    outs = []
    for classes in (CLASSES, np.full(2, 10, np.int32)):
        jctx, pctx = contexts(jmodel, pmodel, extra, t, classes)
        want = np.asarray(predict(params, jnp.asarray(x), jctx))
        with torch.inference_mode():
            got = pmodel.predict_score(torch.from_numpy(x), pctx).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3 * np.abs(outs[0]).max()


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_class_conditional_loss_matches_jax(built, name):
    """loss_on_batch with labels, injected times and noise, no guidance
    drop, dropout off: the loss and the per-example losses to 1e-5
    relative."""
    jmodel, params, pmodel, extra = built(name)
    rng = np.random.default_rng(3)
    images = rng.random(sample_shape(pmodel)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    t = times(pmodel, seed=4)
    jctx = {"classes": jnp.asarray(CLASSES), **{k: jnp.asarray(v) for k, v in extra.items()}}
    pctx = {"classes": torch.from_numpy(CLASSES).long(),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    jax_loss = jax.jit(jmodel.loss_on_batch, static_argnames=("deterministic",))
    want, want_m = jax_loss(params, jax.random.PRNGKey(1), jnp.asarray(images), jctx,
                            timesteps=jnp.asarray(t), noise=jnp.asarray(noise),
                            deterministic=True)
    tt = torch.from_numpy(t)
    got, got_m = pmodel.loss_on_batch(
        torch.from_numpy(images), pctx, timesteps=tt if tt.is_floating_point() else tt.long(),
        noise=torch.from_numpy(noise), deterministic=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["loss_per_example"].numpy(),
                               np.asarray(want_m["loss_per_example"]), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_guided_ten_step_trajectory_matches_jax(built, name):
    """10 steps of the config's sampler with guidance 2.0 (each step the
    labels' and the NULL row's forwards mixed) and injected initial and
    per-step noise: 1e-3 on samples in [0, 1] for the discrete image
    processes. The video processes' 1024-scale cosine logSNR takes 10 long
    steps, and the guided mix 3 * e(labels) - 2 * e(NULL) multiplies each
    step's summation-order difference by up to 5: unguided, the video UNet's
    10 steps differ from JAX's by 2.6e-5, guided by 1.0e-3; 3e-3 there."""
    jmodel, params, pmodel, extra = built(name)
    steps, shape = 10, sample_shape(pmodel)
    rng = np.random.default_rng(2)
    init = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((steps,) + shape).astype(np.float32)
    ctx = {"classes": CLASSES, "sampling_noise": noise, **extra}
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=2, num_sampling_steps=steps,
        classifier_free_guidance=2.0, initial_noise=jnp.asarray(init),
        context={k: jnp.asarray(v) for k, v in ctx.items()}))
    pctx = {k: torch.from_numpy(v) for k, v in ctx.items()}
    pctx["classes"] = pctx["classes"].long()
    got = pmodel.sample(num_samples=2, num_sampling_steps=steps, classifier_free_guidance=2.0,
                        initial_noise=torch.from_numpy(init), context=pctx).numpy()
    assert got.shape == shape and np.isfinite(got).all()
    tol = 3e-3 if pmodel.noise_scheduler().continuous() else 1e-3
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_class_conditional_config_through_the_training_cli(tmp_path, monkeypatch):
    """`python -m xdiffusion_tpu_torch.train --device cpu` on the tiny
    flagship made class-conditional: 2 steps with the batches' labels write
    finite metrics, the checkpoint (with the label table) and the
    class-conditional grid."""
    from xdiffusion_tpu_torch import train as cli

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", _mnist_dir(tmp_path))
    config = class_conditional(tiny_config(tmp_path / "tiny.yaml", fast_sampling=True))
    out = cli.main(["--config_path", config, "--batch_size", "4", "--output_path",
                    str(tmp_path / "out"), "--save_and_sample_every_n", "2", "--num_samples",
                    "4", "--num_training_steps", "2", "--device", "cpu"])
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r[k]) for r in records for k in ("loss", "grad_norm"))
    state = torch.load(os.path.join(out, "checkpoints", "2.pt"), weights_only=False)
    tables = [k for k in state["params"] if "_label_projection.embed.weight" in k]
    assert tables and tuple(state["params"][tables[0]].shape) == (11, 128)
    assert os.path.getsize(os.path.join(out, "sample-2.png")) > 0
