"""Video sampling and the video CLIs in the port against the JAX package on
the CPU, on the unet_3d fixture (tests/fixtures/video_trajectory_parity.yaml:
4 frames of 8x8, num_features 32) inside `video_diffusion_models.yaml`'s
process (v target, 1024-scale cosine logSNR, ancestral sampling), with the
same seeded weights:

- a 5-step ancestral trajectory of (B, F, H, W, C) videos with injected
  initial and per-step noise;
- the `video_mask`/`x0` splice: the frames the mask marks False equal x0
  after every step, and the trajectory equals JAX's;
- reconstruction guidance (2 overlap frames, conditioning frames `x_a`)
  with JAX's own draws of its key chain (fold_in(step key, 11)) injected,
  and its gradient reaching the network's backward inside the loop;
- `InputPreprocessor`'s spatial branch on 5-D videos (the SSR stage);
- the video trainer (2 steps and a resume that repeats the second step's
  loss bit for bit) and the video sampling CLI on the fixture-size config.

Trajectories: 1e-4 on samples in [0, 1] (fp32, sums in other orders through
5 network evaluations)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_video_unet import build_process, video_config

TRAJ_TOL = 1e-4
SHAPE = (2, 4, 8, 8, 1)


@pytest.fixture(scope="module")
def video_pair(tmp_path_factory):
    """(JAX process, flax params, port process) of the fixture with 2 overlap
    frames for reconstruction guidance."""
    path = video_config("video_trajectory_parity", tmp_path_factory.mktemp("video"),
                        num_frame_overlap=2)
    return build_process(path)


def _draws(seed, steps):
    rng = np.random.default_rng(seed)
    init = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal((steps,) + SHAPE).astype(np.float32)
    return rng, init, noise


def _sample(model, ctx, init, steps, params=None):
    if params is not None:
        return np.asarray(model.sample(
            params, jax.random.PRNGKey(0), num_samples=SHAPE[0], num_sampling_steps=steps,
            initial_noise=jnp.asarray(init),
            context={k: jnp.asarray(v) for k, v in ctx.items()}))
    return model.sample(num_samples=SHAPE[0], num_sampling_steps=steps,
                        initial_noise=torch.from_numpy(init),
                        context={k: torch.from_numpy(v) for k, v in ctx.items()}).numpy()


def test_five_step_video_trajectory_matches_jax(video_pair):
    jmodel, params, pmodel = video_pair
    _, init, noise = _draws(0, 5)
    want = _sample(jmodel, {"sampling_noise": noise}, init, 5, params)
    got = _sample(pmodel, {"sampling_noise": noise}, init, 5)
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)


def test_video_mask_splice_matches_jax_and_pins_the_observed_frames(video_pair, monkeypatch):
    """Frames 0 and 2 of the first video and 1 of the second are observed
    (mask False): x0 replaces them before and after every step, so the
    samples there are unnormalize(x0) exactly, and every other frame moves
    as in JAX."""
    from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler

    jmodel, params, pmodel = video_pair
    rng, init, noise = _draws(1, 5)
    mask = np.ones((2, 4), dtype=bool)
    mask[0, [0, 2]] = mask[1, 1] = False
    x0 = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    ctx = {"sampling_noise": noise, "video_mask": mask, "x0": x0}
    want = _sample(jmodel, ctx, init, 5, params)
    steps = []
    p_sample = AncestralSampler.p_sample

    def spy(self, x, *args, **kwargs):
        out = p_sample(self, x, *args, **kwargs)
        steps.append(x.clone())
        return out

    monkeypatch.setattr(AncestralSampler, "p_sample", spy)
    got = _sample(pmodel, ctx, init, 5)
    observed = ~mask[:, :, None, None, None].repeat(8, 2).repeat(8, 3)
    assert len(steps) == 5 and all(np.array_equal(s.numpy()[observed], x0[observed])
                                   for s in steps)
    np.testing.assert_array_equal(got[observed], ((x0 + 1) / 2)[observed])
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)


def _jax_reconstruction_draws(x_a_shape, steps):
    """JAX's reconstruction noise of each step: normal(fold_in(step key,
    11)) along the sample loop's key chain from PRNGKey(0)."""
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    out = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(jax.random.fold_in(step_key, 11), x_a_shape)))
    return np.stack(out)


def test_reconstruction_guidance_matches_jax_with_its_draws(video_pair, monkeypatch):
    """3 guided steps with 4 conditioning frames x_a and 2 overlap frames:
    the guided trajectory equals JAX's (its reconstruction noise replayed
    from its key chain and injected), the gradient of the overlap error
    reaches z through the network's backward (non-zero, the first two
    frames' zero), and the samples' first two frames are x_a's last two."""
    from xdiffusion_tpu_torch.samplers import ancestral

    jmodel, params, pmodel = video_pair
    steps = 3
    rng, init, noise = _draws(2, steps)
    x_a = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    ctx = {"sampling_noise": noise, "x_a": x_a}
    want = _sample(jmodel, ctx, init, steps, params)
    grads = []
    autograd_grad = torch.autograd.grad

    def spy(outputs, inputs, *args, **kwargs):
        out = autograd_grad(outputs, inputs, *args, **kwargs)
        if isinstance(inputs, torch.Tensor) and tuple(inputs.shape) == SHAPE:  # the sampler's
            grads.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(ancestral.torch.autograd, "grad", spy)
    ctx["reconstruction_noise"] = _jax_reconstruction_draws(x_a.shape, steps)
    got = _sample(pmodel, ctx, init, steps)
    assert len(grads) == steps
    assert all(g[:, :2].abs().max() == 0 and g[:, 2:].abs().max() > 0 for g in grads)
    np.testing.assert_allclose(got[:, :2], (x_a[:, -2:] + 1) / 2, atol=1e-6, rtol=0)
    unguided = _sample(pmodel, {"sampling_noise": noise}, init, steps)
    assert np.abs(got[:, 2:] - unguided[:, 2:]).max() > 10 * TRAJ_TOL
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)


def test_reconstruction_guidance_draws_from_the_generator_and_needs_logsnr(video_pair):
    """Without injected reconstruction noise the guided sampler draws it from
    the sampling generator (the same seed repeats the samples); a discrete
    schedule is refused."""
    from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler

    _, _, pmodel = video_pair
    rng, init, _ = _draws(3, 2)
    x_a = torch.from_numpy(rng.uniform(-1, 1, SHAPE).astype(np.float32))

    def run(seed):
        return pmodel.sample(num_samples=2, num_sampling_steps=2,
                             initial_noise=torch.from_numpy(init), context={"x_a": x_a},
                             generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(4), run(4)) and not torch.equal(run(4), run(5))
    sampler = AncestralSampler(reconstruction_guidance=True)
    assert sampler.needs_autograd({"x_a": x_a}) and not sampler.needs_autograd({})

    class Discrete:
        def continuous(self):
            return False

    class Process:
        def noise_scheduler(self):
            return Discrete()

    with pytest.raises(ValueError, match="continuous"):
        sampler._guided_x_hat(x_a, {"x_a": x_a}, None, Process(), None, None)


def test_input_preprocessor_resizes_videos_spatially_as_jax():
    """The SSR stage's spatial branch on (B, F, h, w, C) videos: bilinear on
    the two trailing spatial axes only, 16 -> 32 at 5 frames, against JAX's
    preprocessor without augmentation: 1e-6."""
    from xdiffusion_tpu.layers.super_resolution import InputPreprocessor as JaxPre

    from xdiffusion_tpu_torch.layers.super_resolution import InputPreprocessor

    kw = dict(low_resolution_size=16, super_resolution_size=32,
              context_input_key="low_resolution_images",
              apply_gaussian_conditioning_augmentation=False)
    rng = np.random.default_rng(6)
    low = rng.random((2, 5, 16, 16, 1)).astype(np.float32)
    x = rng.standard_normal((2, 5, 32, 32, 1)).astype(np.float32)
    want = JaxPre(**kw)(jnp.asarray(x), {"low_resolution_images": jnp.asarray(low)})
    got = InputPreprocessor(**kw)(torch.from_numpy(x),
                                  {"low_resolution_images": torch.from_numpy(low)})
    assert tuple(got.shape) == (2, 5, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ---- the CLIs ---------------------------------------------------------------------------


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_train_video_and_sample_video_clis_on_cpu(tmp_path, monkeypatch):
    """The fixture-size unet_3d config through `train_video` on the
    synthetic Moving-MNIST (16-frame 64x64 videos cropped to 4 frames and
    resized to 8x8): 2 steps at batch 2 with checkpoints and frame strips; a
    resume from step 1 repeats the second step's loss bit for bit; then
    `sample_video` from the step-2 checkpoint writes the GIF."""
    from xdiffusion_tpu_torch import sample_video, train_video

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = video_config("video_trajectory_parity", tmp_path)
    common = ["--config_path", config, "--batch_size", "2", "--device", "cpu",
              "--save_and_sample_every_n", "1", "--sampling_steps", "2", "--num_samples", "2"]
    run = train_video.main(common + ["--num_training_steps", "2",
                                     "--output_path", str(tmp_path / "run")])
    metrics = _metrics(run)
    assert sorted(metrics) == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in metrics.values())
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["1.pt", "2.pt"]
    assert os.path.exists(os.path.join(run, "sample-2.png"))
    resumed = train_video.main(common + ["--num_training_steps", "2",
                                         "--output_path", str(tmp_path / "resumed"),
                                         "--resume_from",
                                         os.path.join(run, "checkpoints", "1.pt")])
    assert _metrics(resumed)[1]["loss"] == metrics[1]["loss"]
    samples = sample_video.main(["--config_path", config, "--device", "cpu",
                                 "--checkpoint", os.path.join(run, "checkpoints", "2.pt"),
                                 "--num_samples", "2", "--sampling_steps", "2",
                                 "--output_path", str(tmp_path / "samples")])
    assert tuple(samples.shape) == SHAPE and bool(torch.isfinite(samples).all())
    with open(tmp_path / "samples" / "video-step2.gif", "rb") as f:
        assert f.read(6) == b"GIF89a"
