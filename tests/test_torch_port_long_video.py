"""The rest of the video path in the port against the JAX package on the
CPU: temporal super-resolution and the Imagen-Video cascade, the long-video
sampling scheme and the two CLIs that drive it, and the image-to-video warm
start.

- `InputPreprocessor`'s temporal branch (frame repetition) with and
  without conditioning augmentation (JAX's draws injected); the temporal
  SR stage (`imagen_video_tsr_8x16.yaml` cut to num_features 32, two
  levels) through its loss with JAX's draws; the three-stage video
  cascade's chained sample with every draw of JAX's key chain injected;
  the 5-D cascade loss refused as JAX refuses it;
- `Autoregressive` against JAX's iterator, every yield;
- the sampling CLI's `--sampling_scheme_path` and the extend CLI (hard
  and guided) with `sample()` stubbed on both sides: every window's
  `video_mask`, `x0` and `x_a`, the sampler and the GIF against JAX's
  CLIs; then the real CLIs at fixture size;
- the warm start: the parameters an image network's checkpoint leaves at
  init in a Video-LDM and an AnimateDiff (each cut to num_features 32, two
  levels, 4 frames) against the paths JAX's `restore_params_partial` leaves
  missing; a non-temporal miss refused; two temporal-only training steps
  leave every frozen parameter bit for bit.

Tolerances: fp32, sums in other orders; the preprocessor 1e-6, the stage
loss 1e-5 relative, the chained sample 1e-3 on samples in [0, 1] (as the
image cascades'); the schemes, windows and GIFs exactly."""

import contextlib
import importlib.util
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
from test_torch_port_cascade import _stage_draws, no_transformers, offline_preprocessors
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import _flat, _tree
from test_torch_port_fdm import fdm_config
from test_torch_port_ltx import _gif_frames
from test_torch_port_video_unet import video_config

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params, randomize_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO = os.path.join(REPO, "configs", "video", "moving_mnist")
SCHEME = os.path.join(REPO, "configs", "video", "sampling_schemes", "autoregressive.yaml")
STAGES = ("imagen_video_8x16x16", "imagen_video_tsr_8x16", "imagen_video_ssr_16x32")
PROMPTS = ["3", "seven"]
# Cuts of the shipped widths: 128 features to 32 (the time embedding's 512
# to 128, heads of 64 to 32), two levels, one residual block a level, no
# dropout (in the blocks and the attention layers) and no guidance drop; frames, where `frames` says so, 16 to 4.
_WIDTHS = {"num_features": (128, 32), "time_embedding_dim": (512, 128), "dim_head": (64, 32)}
_FRAMES = {"input_number_of_frames": (16, 4), "num_frames": (16, 4),
           "temporal_sequence_length": (16, 4), "output_frames": (16, 4)}


def shrink(node, frames: bool = False):
    """Cuts a config dict in place (see _WIDTHS and _FRAMES)."""
    cuts = dict(_WIDTHS, **(_FRAMES if frames else {}))
    if isinstance(node, dict):
        for k, v in node.items():
            if k in cuts and v == cuts[k][0]:
                node[k] = cuts[k][1]
            else:
                shrink(v, frames)
        if "channel_multipliers" in node:
            node.update(channel_multipliers=node["channel_multipliers"][:2], num_resnet_blocks=1)
        if "dropout" in node:
            node["dropout"] = 0.0
        if "unconditional_guidance_probability" in node:
            node["unconditional_guidance_probability"] = 0.0
    elif isinstance(node, list):
        for v in node:
            shrink(v, frames)
    return node


def _write(cfg, directory, name) -> str:
    path = os.path.join(str(directory), name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def tiny_video_cascade(directory) -> str:
    """imagen_video.yaml with its three stages cut (`shrink`; frames as
    shipped: 8, then 16), written to `directory`."""
    with open(os.path.join(VIDEO, "imagen_video.yaml")) as f:
        cascade = yaml.safe_load(f)
    for k, name in enumerate(STAGES):
        with open(os.path.join(VIDEO, name + ".yaml")) as f:
            stage = shrink(yaml.safe_load(f))
        cascade["diffusion_cascade"][f"cascade_layer_{k + 1}"]["config"] = _write(
            stage, directory, name)
    return _write(cascade, directory, "imagen_video")


@pytest.fixture(scope="module")
def video_cascade(tmp_path_factory):
    """(JAX cascade, its params, port cascade on the CPU) on shared seeded
    weights."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.cascade import GaussianDiffusionCascade as JaxCascade

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.cascade import GaussianDiffusionCascade

    path = tiny_video_cascade(tmp_path_factory.mktemp("imagen_video"))
    with no_transformers():
        jmodel = JaxCascade(jax_load_yaml(path))
    offline_preprocessors(jmodel)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    flat = {f"{stage}/{k}": v for stage, tree in shapes.items()
            for k, v in _flat(tree["params"]).items()}
    drawn = random_flax_params(flat, seed=5)
    params = {}
    for key, value in drawn.items():
        stage, _, rest = key.partition("/")
        params.setdefault(stage, {})[rest] = value
    params = {s: {"params": _tree(t)} for s, t in params.items()}
    pmodel = GaussianDiffusionCascade(load_yaml(path), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, params, pmodel


# ---- temporal super-resolution ---------------------------------------------------------


@pytest.mark.parametrize("case", ["clean", "random", "level", "frameskip"])
def test_temporal_input_preprocessor_matches_jax(case):
    """The TSR stage's preprocessor (8 frames to 16 by repetition, the
    1024-scale cosine logSNR schedule) on (3, 8, 6, 6, 1) conditioning and a
    (3, 16, 6, 6, 1) x: without augmentation ("clean"), with a random
    augmentation time (JAX's draw from its key injected with its noise), at
    the fixed level 0.1, and with `temporal_upsampling: frameskip_3` (16
    frames of 6 repeated thrice, cut to 16). fp32, 1e-6."""
    from xdiffusion_tpu.config import instantiate_from_config as jax_instantiate
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.layers.super_resolution import InputPreprocessor as JaxPre

    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
    from xdiffusion_tpu_torch.layers.super_resolution import InputPreprocessor

    path = os.path.join(VIDEO, "imagen_video_tsr_8x16.yaml")
    jsched = jax_instantiate(jax_load_yaml(path).diffusion.noise_scheduler.to_dict())
    psched = instantiate_from_config(load_yaml(path).diffusion.noise_scheduler.to_dict())
    kw = dict(low_resolution_size=8, super_resolution_size=16, is_spatial=False,
              is_temporal=True, context_input_key="low_resolution_images",
              apply_gaussian_conditioning_augmentation=case != "clean")
    frames = 8
    if case == "frameskip":
        kw.update(low_resolution_size=6, temporal_upsampling="frameskip_3")
        frames = 6
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16, 6, 6, 1)).astype(np.float32)
    low = rng.random((3, frames, 6, 6, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jctx = {"low_resolution_images": jnp.asarray(low), "preprocessor_rng": key}
    pctx = {"low_resolution_images": torch.from_numpy(low)}
    if case == "level":
        jctx["augmentation_level"] = pctx["augmentation_level"] = 0.1
    want = JaxPre(**kw)(jnp.asarray(x), jctx, noise_scheduler=jsched)
    pctx["augmentation_noise"] = torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(key, 1), (3, 16, 6, 6, 1))))
    if case in ("random", "frameskip"):
        pctx["augmentation_timestep"] = torch.from_numpy(np.asarray(
            jsched.sample_random_times(jax.random.split(key)[0], 3)[0]))
    got = InputPreprocessor(**kw)(torch.from_numpy(x), pctx, noise_scheduler=psched)
    assert tuple(got.shape) == (3, 16, 6, 6, 2)
    np.testing.assert_array_equal(got[..., :1].numpy(), x)
    if case == "clean":
        repeated = np.repeat(low, 2, axis=1) * 2 - 1
        np.testing.assert_array_equal(got[..., 1:].numpy(), repeated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_tsr_stage_loss_matches_jax_with_its_draws(video_cascade):
    """The temporal SR stage alone (the cut cascade's stage 2) on 16-frame
    16x16 videos with their 8-frame conditioning and prompts: its loss with
    JAX's draws of one key injected (timesteps, noise, the augmentation time
    and noise) against the jitted JAX loss, 1e-5 relative; the stage's
    conditioning channel is the repeated frames."""
    jmodel, params, pmodel = video_cascade
    jstage, pstage = jmodel.models()[1], pmodel.models()[1]
    rng = np.random.default_rng(8)
    images = rng.random((2, 16, 16, 16, 1)).astype(np.float32)
    low = rng.random((2, 8, 16, 16, 1)).astype(np.float32)
    jctx = jstage.preprocess_context({"text_prompts": PROMPTS})
    pctx = pstage.preprocess_context({"text_prompts": PROMPTS})
    np.testing.assert_array_equal(pctx["text_tokens"].numpy(), np.asarray(jctx["text_tokens"]))
    jctx = {"text_tokens": jctx["text_tokens"], "low_resolution_images": jnp.asarray(low)}
    key = jax.random.PRNGKey(3)
    want, _ = jax.jit(lambda p: jstage.loss_on_batch(p, key, jnp.asarray(images), jctx))(
        params["stage_2"])
    draws = _stage_draws(jstage, key, 2, images.shape)
    # The continuous schedule's times are floats (the helper casts a
    # discrete schedule's to integers): redraw them as they are.
    rng_t, _, _, rng_drop, _ = jax.random.split(key, 5)
    sched = jstage.noise_scheduler()
    draws["timesteps"] = torch.from_numpy(np.array(sched.sample_random_times(rng_t, 2)[0]))
    draws["context"]["augmentation_timestep"] = torch.from_numpy(np.array(
        sched.sample_random_times(jax.random.split(jax.random.fold_in(rng_drop, 7))[0], 2)[0]))
    assert draws["timesteps"].dtype == torch.float32
    ctx = dict(pctx, low_resolution_images=torch.from_numpy(low), **draws.pop("context"))
    got, _ = pstage.loss_on_batch(torch.from_numpy(images), ctx, deterministic=True, **draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_video_cascade_chained_sample_matches_jax_with_its_draws(video_cascade):
    """cascade.sample for 3 steps a stage at batch 2 with prompts: the base
    (2, 8, 16, 16, 1) conditions the temporal stage (16 frames by
    repetition), whose samples condition the spatial stage (32x32), each SR
    stage augmented to the fixed level 0.1 at every step; every draw of
    JAX's key chain injected (each stage's initial noise, per-step noise and
    per-step augmentation noise). 1e-3 on samples in [0, 1]."""
    jmodel, params, pmodel = video_cascade
    n, steps = 2, 3
    key = jax.random.PRNGKey(11)
    want = np.asarray(jmodel.sample(params, key, num_samples=n, context={"text_prompts": PROMPTS},
                                    num_sampling_steps=steps))
    stage_noise, rng = [], key
    for layer in jmodel.models():
        rng, sub = jax.random.split(rng)
        inner, init_rng = jax.random.split(sub)
        cfg = layer.config()
        shape = (n, cfg.diffusion.sampling.output_frames, cfg.data.image_size,
                 cfg.data.image_size, 1)
        step_keys = []
        for _ in range(steps):
            inner, step_key = jax.random.split(inner)
            step_keys.append(step_key)
        inject = {"initial_noise": torch.from_numpy(np.asarray(jax.random.normal(init_rng, shape))),
                  "context": {"sampling_noise": torch.from_numpy(np.stack(
                      [np.asarray(jax.random.normal(k, shape)) for k in step_keys]))}}
        if "super_resolution" in cfg:
            inject["context"]["sampling_augmentation_noise"] = torch.from_numpy(np.stack(
                [np.asarray(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k, 3), 1),
                                              shape)) for k in step_keys]))
        stage_noise.append(inject)
    got = pmodel.sample(num_samples=n, context={"text_prompts": PROMPTS},
                        num_sampling_steps=steps, stage_noise=stage_noise)
    assert tuple(got.shape) == want.shape == (n, 16, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_video_cascade_loss_refuses_5d_batches_as_jax(video_cascade):
    """The JAX cascade's `_resize` unpacks a 4-D shape, so a video batch
    raises ValueError before any stage runs; the port's loss raises it too."""
    jmodel, params, pmodel = video_cascade
    videos = np.zeros((2, 16, 32, 32, 1), np.float32)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jmodel.loss_on_batch(params, jax.random.PRNGKey(0), jnp.asarray(videos), {})
    with pytest.raises(ValueError, match="too many values to unpack"):
        pmodel.loss_on_batch(torch.from_numpy(videos), {}, generator=torch.Generator())


# ---- the sampling scheme and the CLIs ------------------------------------------------


@pytest.mark.parametrize("params", [dict(video_length=160, num_observed_frames=0, max_frames=16,
                                         step_size=12),
                                    dict(video_length=10, num_observed_frames=0, max_frames=4,
                                         step_size=3),
                                    dict(video_length=20, num_observed_frames=3, max_frames=8,
                                         step_size=5),
                                    dict(video_length=7, num_observed_frames=0, max_frames=4,
                                         step_size=2)],
                         ids=["autoregressive.yaml", "short", "observed", "ragged"])
@pytest.mark.parametrize("batched", [False, True])
def test_autoregressive_matches_jax_every_yield(params, batched):
    """Autoregressive from the same parameters (autoregressive.yaml's: 160
    frames from 16, 12 new a window, 13 windows): every yield (observed
    and latent indices, the window mask) equal to JAX's, unbatched and
    with set_videos for 3 videos."""
    from xdiffusion_tpu.samplers.schemes import Autoregressive as JaxScheme

    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
    from xdiffusion_tpu_torch.samplers.schemes import Autoregressive

    if params["video_length"] == 160:
        got = instantiate_from_config(load_yaml(SCHEME).sampling_scheme.to_dict())
        assert isinstance(got, Autoregressive)
    else:
        got = Autoregressive(**params)
    want = JaxScheme(**params)
    if batched:
        got.set_videos([0, 1, 2])
        want.set_videos([0, 1, 2])
    got_yields, want_yields = list(got), list(want)
    assert len(got_yields) == len(want_yields) > 1
    for g, w in zip(got_yields, want_yields):
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_array_equal(g[2], w[2])
    if params["video_length"] == 160:
        assert len(got_yields) == 13


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_cli", os.path.join(REPO, "sampling", "video", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stub_frames(call: int, shape) -> np.ndarray:
    """The stubbed sample of call `call`: values that name the call, the
    video and the frame slot."""
    b, f = shape[:2]
    values = (0.05 * (call + 1) + 0.1 * np.arange(b)[:, None] + 0.01 * np.arange(f)[None, :])
    return np.broadcast_to(values[:, :, None, None, None] % 1.0, shape).astype(np.float32)


@contextlib.contextmanager
def stubbed_clis(monkeypatch, shape):
    """Both packages' `sample()` stubbed (each call's whole context, its
    prompts too, its sampler and steps recorded; `_stub_frames` returned), and the JAX CLI's checkpoint
    restore and parameter init skipped. Yields (JAX calls, port calls)."""
    from xdiffusion_tpu import checkpoints as jax_checkpoints
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    calls = ([], [])

    def record(side, context, sampler, steps, num_samples):
        ctx = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in (context or {}).items()}
        guided = None if sampler is None else (
            getattr(sampler, "reconstruction_guidance", None)
            or getattr(sampler, "_reconstruction_guidance", None),
            sampler._omega, sampler._num_frame_overlap)
        calls[side].append({"context": ctx, "sampler": guided, "steps": steps})
        return _stub_frames(len(calls[side]) - 1, (num_samples,) + shape[1:])

    def jax_sample(self, params, rng, num_samples=16, context=None, num_sampling_steps=None,
                   sampler=None, **kw):
        return jnp.asarray(record(0, context, sampler, num_sampling_steps, num_samples))

    def port_sample(self, num_samples=16, context=None, num_sampling_steps=None, sampler=None,
                    **kw):
        return torch.from_numpy(record(1, context, sampler, num_sampling_steps,
                                       num_samples).copy())

    monkeypatch.setattr(JaxDDPM, "sample", jax_sample)
    monkeypatch.setattr(JaxDDPM, "init_params", lambda self, rng, *a: {})
    monkeypatch.setattr(jax_checkpoints, "restore_checkpoint", lambda path, state: (state, 7))
    monkeypatch.setattr(GaussianDiffusion_DDPM, "sample", port_sample)
    yield calls


def _port_checkpoint(path, tmp_path) -> str:
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    net = GaussianDiffusion_DDPM(load_yaml(path), device="cpu").score_network()
    ckpt = str(tmp_path / "net.pt")
    torch.save(net.state_dict(), ckpt)
    return ckpt


def _same_calls(calls):
    jax_calls, port_calls = calls
    assert len(jax_calls) == len(port_calls) > 1
    for j, p in zip(jax_calls, port_calls):
        assert sorted(j["context"]) == sorted(p["context"])
        for k in j["context"]:
            assert j["context"][k].dtype == p["context"][k].dtype, k
            np.testing.assert_array_equal(p["context"][k], j["context"][k])
        assert j["sampler"] == p["sampler"] and j["steps"] == p["steps"]


def _same_gifs(got, want):
    g_frames, g_durations, g_loop = _gif_frames(got)
    w_frames, w_durations, w_loop = _gif_frames(want)
    assert len(g_frames) == len(w_frames) and g_durations == w_durations and g_loop == w_loop
    for g, w in zip(g_frames, w_frames):
        np.testing.assert_array_equal(g, w)


def test_scheme_cli_windows_match_jax(tmp_path, monkeypatch):
    """The sampling CLI with `--sampling_scheme_path` (10 frames from the
    fixture-size FDM's 4, 3 new a window) and `sample()` stubbed on both
    sides: every window's `video_mask` and `x0` (the frames so far, in
    [-1, 1]) equal JAX's CLI's, its steps too, and long-video-step7.gif
    decodes to JAX's frames."""
    from xdiffusion_tpu_torch import sample_video

    path = fdm_config(tmp_path, num_scales=10)
    scheme = _write({"sampling_scheme": {
        "target": "xdiffusion_tpu.samplers.schemes.Autoregressive",
        "params": dict(video_length=10, num_observed_frames=0, max_frames=4, step_size=3)}},
        tmp_path, "scheme")
    ckpt = _port_checkpoint(path, tmp_path)
    args = ["--config_path", path, "--num_samples", "2", "--sampling_steps", "3",
            "--sampling_scheme_path", scheme]
    with stubbed_clis(monkeypatch, (2, 4, 16, 16, 1)) as calls:
        monkeypatch.setattr(sys, "argv", ["sample.py", "--checkpoint", "none"] + args
                            + ["--output_path", str(tmp_path / "jax")])
        _jax_cli("sample").main()
        video = sample_video.main(args + ["--checkpoint", ckpt, "--output_path",
                                          str(tmp_path / "port"), "--device", "cpu"])
    assert tuple(video.shape) == (2, 10, 16, 16, 1)
    _same_calls(calls)
    assert len(calls[1]) == 3 and calls[1][0]["context"]["video_mask"].all()
    assert (calls[1][1]["context"]["video_mask"] == [[False] + [True] * 3] * 2).all()
    _same_gifs(str(tmp_path / "port" / "long-video-step0.gif"),
               str(tmp_path / "jax" / "long-video-step7.gif"))


@pytest.mark.parametrize("guided", [False, True], ids=["hard", "guided"])
def test_extend_cli_chunks_match_jax(guided, tmp_path, monkeypatch):
    """The extend CLI to 11 frames from the fixture-size FDM's 4 with 2
    overlap frames and `sample()` stubbed on both sides: every chunk's
    context (hard: `video_mask` False on the overlap and `x0` the padded
    tail in [-1, 1]; guided: `x_a` the tail in [-1, 1]), its sampler
    (reconstruction guidance with omega 3 and the overlap) and steps equal
    JAX's CLI's, and extended-11f.gif decodes to JAX's frames."""
    from xdiffusion_tpu_torch import extend_video

    path = fdm_config(tmp_path, num_scales=10)
    ckpt = _port_checkpoint(path, tmp_path)
    args = ["--config_path", path, "--num_samples", "2", "--total_frames", "11",
            "--num_frame_overlap", "2", "--sampling_steps", "3"]
    if guided:
        args += ["--reconstruction_guidance", "--guidance_omega", "3.0"]
    with stubbed_clis(monkeypatch, (2, 4, 16, 16, 1)) as calls:
        monkeypatch.setattr(sys, "argv", ["extend.py", "--checkpoint", "none", "--force_cpu"]
                            + args + ["--output_path", str(tmp_path / "jax")])
        _jax_cli("extend").main()
        video = extend_video.main(args + ["--checkpoint", ckpt, "--output_path",
                                          str(tmp_path / "port"), "--device", "cpu"])
    assert tuple(video.shape) == (2, 11, 16, 16, 1)
    _same_calls(calls)
    assert len(calls[1]) == 5 and (calls[1][1]["sampler"] is not None) == guided
    key = "x_a" if guided else "x0"
    assert calls[1][1]["context"][key].shape[1] == (2 if guided else 4)
    _same_gifs(str(tmp_path / "port" / "extended-11f.gif"),
               str(tmp_path / "jax" / "extended-11f.gif"))


def test_long_video_clis_run_on_the_cpu(tmp_path):
    """The real CLIs at fixture size, 2 sampling steps: the scheme on the
    FDM (10 frames from 4), the hard extension of the FDM to 7 frames, and
    the guided extension of the unet_3d fixture (a continuous schedule) to
    7 frames; finite videos of the asked lengths and their GIFs. The guided
    extension of the FDM's discrete schedule is refused, as JAX asserts."""
    from xdiffusion_tpu_torch import extend_video, sample_video

    fdm = fdm_config(tmp_path, num_scales=10)
    fdm_ckpt = _port_checkpoint(fdm, tmp_path)
    scheme = _write({"sampling_scheme": {
        "target": "xdiffusion_tpu.samplers.schemes.Autoregressive",
        "params": dict(video_length=10, num_observed_frames=0, max_frames=4, step_size=3)}},
        tmp_path, "scheme")
    common = ["--num_samples", "2", "--sampling_steps", "2", "--device", "cpu"]
    video = sample_video.main(["--config_path", fdm, "--checkpoint", fdm_ckpt,
                               "--sampling_scheme_path", scheme, "--output_path",
                               str(tmp_path / "s")] + common)
    assert tuple(video.shape) == (2, 10, 16, 16, 1) and bool(torch.isfinite(video).all())
    assert len(_gif_frames(str(tmp_path / "s" / "long-video-step0.gif"))[0]) > 1
    extend = ["--total_frames", "7", "--num_frame_overlap", "1"] + common
    video = extend_video.main(["--config_path", fdm, "--checkpoint", fdm_ckpt, "--output_path",
                               str(tmp_path / "e")] + extend)
    assert tuple(video.shape) == (2, 7, 16, 16, 1) and bool(torch.isfinite(video).all())
    assert os.path.getsize(tmp_path / "e" / "extended-7f.gif") > 0
    with pytest.raises(ValueError, match="continuous"):
        extend_video.main(["--config_path", fdm, "--checkpoint", fdm_ckpt,
                           "--reconstruction_guidance"] + extend)
    vdm = video_config("video_trajectory_parity", tmp_path)
    video = extend_video.main(["--config_path", vdm, "--checkpoint", _port_checkpoint(vdm, tmp_path),
                               "--reconstruction_guidance", "--output_path",
                               str(tmp_path / "g")] + extend)
    assert tuple(video.shape) == (2, 7, 8, 8, 1) and bool(torch.isfinite(video).all())


# ---- the image-to-video warm start -------------------------------------------------


def warm_start_configs(name: str, directory):
    """(video config, image config) paths: the shipped video config cut
    (`shrink`, 4 frames), and an image config of its spatial network (its
    process without frames, the spatial block without the per-frame batch
    heads), both written to `directory`."""
    with open(os.path.join(VIDEO, name + ".yaml")) as f:
        video = shrink(yaml.safe_load(f), frames=True)
    image = json.loads(json.dumps(video))
    spatial = image["diffusion"]["score_network"]["params"]["spatial_score_network"]
    cond = spatial["conditioning"]
    cond["context_transformer_head"] = [h for h in cond["context_transformer_head"]
                                        if not h["target"].endswith("SpatialBatchForVideo")]
    image["diffusion"]["score_network"] = {"target": "xdiffusion_tpu.score_networks.unet.Unet",
                                           "params": spatial}
    image["diffusion"]["sampling"].pop("output_frames")
    image["data"].pop("input_number_of_frames", None)
    return _write(video, directory, name), _write(image, directory, name + "_image")


def _image_checkpoint(image_path, directory, drop=()) -> str:
    """A training checkpoint of the image network (seeded weights), without
    the parameters in `drop`."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    net = build_model(load_yaml(image_path), device="cpu").score_network()
    randomize_(net, 3)
    params = {k: v for k, v in net.state_dict().items() if k not in drop}
    os.makedirs(os.path.join(str(directory), "checkpoints"), exist_ok=True)
    path = os.path.join(str(directory), "checkpoints", "5.pt")
    torch.save({"step": 5, "params": params, "optimizer": None, "ema": None}, path)
    return path


class _FakeManager:
    """Stands in for orbax's manager in JAX's `restore_params_partial`."""

    def __init__(self, params):
        self.params = params

    def latest_step(self):
        return 5

    def restore(self, step):
        return {"params": self.params}

    def close(self):
        pass


def _prefix(name: str) -> str:
    """A parameter's module path: flax `a/b/kernel` and port `a.b.weight`
    both give `a.b`."""
    return name.replace("/", ".").rpartition(".")[0]


@pytest.mark.parametrize("name", ["video_ldm", "animate_diff"])
def test_warm_start_leaves_at_init_what_jax_leaves_missing(name, tmp_path, monkeypatch):
    """An image network's checkpoint into the cut video config: the port's
    `restore_params_partial` fills every parameter of the same name and
    shape (bit for bit) and leaves at init the parameters whose module
    paths are those JAX's `restore_params_partial` leaves missing (each a
    temporal module's); with a non-temporal parameter (the image network's
    initial_conv) dropped from the checkpoint both refuse."""
    from xdiffusion_tpu import checkpoints as jax_checkpoints
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.training.image.train import build_model as jax_build

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    video_path, image_path = warm_start_configs(name, tmp_path)
    ckpt = _image_checkpoint(image_path, tmp_path / "run")
    net = build_model(load_yaml(video_path), device="cpu").score_network()
    step, missing = checkpoints.restore_params_partial(str(tmp_path / "run"), net)
    image = torch.load(ckpt, weights_only=True)["params"]
    assert step == 5 and missing
    for key, p in net.named_parameters():
        if key not in missing:
            assert torch.equal(p, image[key]), key

    with no_transformers():
        jvideo, jimage = jax_build(jax_load_yaml(video_path)), jax_build(jax_load_yaml(image_path))
    offline_preprocessors(jvideo) if hasattr(jvideo, "models") else None
    x, ctx = jvideo.example_batch(1)
    vshapes = jax.eval_shape(jvideo._score_network.init, jax.random.PRNGKey(0), x, ctx)
    x, ctx = jimage.example_batch(1)
    ishapes = jax.eval_shape(jimage._score_network.init, jax.random.PRNGKey(0), x, ctx)
    zeros = lambda tree: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)  # noqa: E731
    monkeypatch.setattr(jax_checkpoints, "_manager", lambda d: _FakeManager(zeros(ishapes)))
    _, _, jax_missing = jax_checkpoints.restore_params_partial("unused", zeros(vshapes))
    assert {_prefix(m) for m in missing} == {_prefix(m.partition("/")[2]) for m in jax_missing}

    drop = [k for k in image if k.startswith("initial_conv")]
    _image_checkpoint(image_path, tmp_path / "run2", drop=drop)
    with pytest.raises(ValueError, match="not all temporal"):
        checkpoints.restore_params_partial(str(tmp_path / "run2"), net)
    flat = traverse_util.flatten_dict(zeros(ishapes))
    cut = traverse_util.unflatten_dict({k: v for k, v in flat.items() if "initial_conv" not in k})
    monkeypatch.setattr(jax_checkpoints, "_manager", lambda d: _FakeManager(cut))
    with pytest.raises(AssertionError, match="not all temporal"):
        jax_checkpoints.restore_params_partial("unused", zeros(vshapes))


def test_temporal_only_training_keeps_the_backbone_bit_for_bit(tmp_path, monkeypatch):
    """The video trainer warm-started from an image checkpoint with
    train_temporal_modules_only, 2 steps of the cut Video-LDM at batch 2:
    every parameter restored from the checkpoint stays bit for bit, the
    temporal gates move, the optimizer holds only the temporal ones; the
    flag without a checkpoint, and with a resume, is refused."""
    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.training.video.train import train

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    video_path, image_path = warm_start_configs("video_ldm", tmp_path)
    ckpt = _image_checkpoint(image_path, tmp_path / "image_run")
    image = torch.load(ckpt, weights_only=True)["params"]
    kw = dict(num_training_steps=2, batch_size=2, save_and_sample_every_n=2, device="cpu",
              num_samples=1, sampling_steps=1, output_path=str(tmp_path / "out"))
    run = train(video_path, load_model_weights_from_checkpoint=ckpt,
                train_temporal_modules_only=True, **kw)
    payload = torch.load(os.path.join(run, "checkpoints", "2.pt"), weights_only=True)
    trained = payload["params"]
    temporal = [k for k in trained if k not in image or image[k].shape != trained[k].shape]
    assert temporal and all(any(m in k.lower() for m in checkpoints.TEMPORAL_KEY_MARKERS)
                            for k in temporal)
    for key in trained:
        if key not in temporal:
            assert torch.equal(trained[key], image[key]), key
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    torch.manual_seed(0)  # the trainer's initialisation
    init = build_model(load_yaml(video_path), device="cpu").score_network().state_dict()
    moved = [k for k in temporal if not torch.equal(trained[k], init[k])]
    # The zero-initialised gates and projections move first; what sits
    # behind them takes no gradient until they have.
    assert any(k.endswith("alpha") for k in moved) and len(moved) >= 10
    state = payload["optimizer"]["optimizer"]["param_groups"]
    assert sum(len(g["params"]) for g in state) == len(temporal)
    with pytest.raises(ValueError, match="needs load_model_weights_from_checkpoint"):
        train(video_path, train_temporal_modules_only=True, **kw)
    with pytest.raises(NotImplementedError, match="resuming a temporal-only run"):
        train(video_path, load_model_weights_from_checkpoint=ckpt,
              train_temporal_modules_only=True, resume_from=run, **kw)


def test_warm_start_from_the_clip_image_config_is_refused_as_in_jax(tmp_path, monkeypatch):
    """configs/image/moving_mnist/ddpm_32x32_v_continuous_clip.yaml's network
    (CLIP context of 512) into video_ldm.yaml (T5 context of 768) at full
    width: its text projection and cross-attention encoder kv differ in
    shape, so they stay at init without a temporal marker, and both
    packages refuse the restore. (The warm start runs from an image config
    of the video config's own spatial network: `warm_start_configs`.)"""
    from xdiffusion_tpu import checkpoints as jax_checkpoints
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.training.image.train import build_model as jax_build

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    image_path = os.path.join(REPO, "configs", "image", "moving_mnist",
                              "ddpm_32x32_v_continuous_clip.yaml")
    video_path = os.path.join(VIDEO, "video_ldm.yaml")
    image = build_model(load_yaml(image_path), device="cpu").score_network()
    os.makedirs(tmp_path / "checkpoints")
    torch.save({"step": 1, "params": image.state_dict()}, tmp_path / "checkpoints" / "1.pt")
    with pytest.raises(ValueError, match="encoder_kv"):
        checkpoints.restore_params_partial(str(tmp_path),
                                           build_model(load_yaml(video_path),
                                                       device="cpu").score_network())
    with no_transformers():
        jvideo, jimage = jax_build(jax_load_yaml(video_path)), jax_build(jax_load_yaml(image_path))
    shapes = []
    for jmodel in (jvideo, jimage):
        x, ctx = jmodel.example_batch(1)
        shapes.append(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)))
    monkeypatch.setattr(jax_checkpoints, "_manager", lambda d: _FakeManager(shapes[1]))
    with pytest.raises(AssertionError, match="encoder_kv"):
        jax_checkpoints.restore_params_partial("unused", shapes[0])
