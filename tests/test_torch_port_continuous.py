"""Continuous-time (logSNR) diffusion in the port against the JAX package on
the CPU: the logSNR tables, the table index at and next to its boundaries,
the scheduler's posterior and predictions, the inverse-cosine time
embedding, the samplers' per-step context, the three continuous UNet configs
(forward, 10-step trajectories, loss) at num_features 32 with the same
seeded weights, and prompt-conditioned training and sampling through the
port's trainer and CLI on a tiny text-conditioned continuous config."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import no_transformers, one_torch_thread  # noqa: F401 (autouse)
import yaml

from test_torch_port_vae import built_once  # noqa: F401 (fixture)

from test_torch_port_text import (
    CONTINUOUS_CONFIGS,
    build,
    check_forward,
    check_loss,
    check_trajectory,
    config_path,
)

HEADLINE = "mnist/ddpm_32x32_v_continuous_clip"


def _schedulers(schedule: str, num_scales: int):
    from xdiffusion_tpu.scheduler import continuous_noise_scheduler as jax_factory

    from xdiffusion_tpu_torch.scheduler import ContinuousNoiseScheduler, continuous_noise_scheduler

    kw = dict(num_scales=num_scales, logsnr_schedule=schedule, logsnr_min=-20, logsnr_max=20,
              importance_sampler={"target": "unused"})
    port = continuous_noise_scheduler(**kw)
    assert isinstance(port, ContinuousNoiseScheduler) and port.continuous()
    return jax_factory(**kw), port


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
@pytest.mark.parametrize("num_scales", [1024, 1000])
def test_logsnr_tables_equal_jax(schedule, num_scales):
    """Built in float64 numpy and cast, as in JAX: equal bit for bit."""
    want, got = _schedulers(schedule, num_scales)
    assert got.steps() == num_scales and got.gammas.shape == (num_scales + 1,)
    for name in ("gammas", "alphas", "sigma2", "sqrt_sigma2"):
        assert getattr(got, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def _boundary_times(num_scales: int) -> np.ndarray:
    """t = k / N for several k, and the fp32 neighbours on each side, where
    a float64 index would land on the other entry."""
    k = np.array([0, 1, 3, 10, 100, 333, 511, 512, 700, 1000, num_scales - 1, num_scales],
                 dtype=np.float32)
    t = (k / np.float32(num_scales)).astype(np.float32)
    return np.concatenate([t, np.nextafter(t, np.float32(-1)), np.nextafter(t, np.float32(2)),
                           np.float32([0.5, 0.25, 0.999, 1.0])]).clip(0, 1).astype(np.float32)


@pytest.mark.parametrize("num_scales", [1024, 1000])
def test_table_index_and_forward_process_at_boundaries_match_jax(num_scales):
    """The index int32(fp32(t) * N) on and next to entry boundaries, and
    the logSNR, q_sample and the v target read through it: the same entry
    as JAX, the values to fp32 rounding."""
    want, got = _schedulers("cosine", num_scales)
    t = _boundary_times(num_scales)
    jt, pt = jnp.asarray(t), torch.from_numpy(t)
    want_idx = np.clip((jt * num_scales).astype(jnp.int32), 0, num_scales)
    np.testing.assert_array_equal(got.index(pt).numpy(), np.asarray(want_idx))
    if num_scales == 1000:  # some of these t would take the neighbour in float64
        assert (np.floor(t.astype(np.float64) * num_scales) != np.asarray(want_idx)).any()
    np.testing.assert_array_equal(got.logsnr(pt).numpy(), np.asarray(want.logsnr(jt)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((t.shape[0], 4, 4, 1)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    for fn in ("q_sample", "predict_v_from_x_and_epsilon"):
        if fn == "q_sample":
            w = want.q_sample(jnp.asarray(x), jt, jnp.asarray(eps))
            g = got.q_sample(torch.from_numpy(x), pt, torch.from_numpy(eps))
        else:
            w = want.predict_v_from_x_and_epsilon(jnp.asarray(x), jnp.asarray(eps), jt)
            g = got.predict_v_from_x_and_epsilon(torch.from_numpy(x), torch.from_numpy(eps), pt)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=fn)


def test_posterior_and_predictions_match_jax():
    """q_posterior, the fixed-large variance and the three predictions at
    the logSNR pairs a 10-step sampler walks (t = 1 ... 0.1 against s = t -
    0.1, the ends at +-20), fp32 to 1e-5 relative."""
    from xdiffusion_tpu.utils import log1mexp as jax_log1mexp

    from xdiffusion_tpu_torch.utils import log1mexp

    want, got = _schedulers("cosine", 1024)
    t = np.arange(10, 0, -1, dtype=np.float32)
    s_t, t_t = t - 1.0, t
    logsnr_s = np.asarray(want.logsnr(jnp.asarray(s_t / 10)))
    logsnr_t = np.asarray(want.logsnr(jnp.asarray(t_t / 10)))
    rng = np.random.default_rng(1)
    x0, z, v = (rng.standard_normal((10, 3, 3, 2)).astype(np.float32) for _ in range(3))
    jctx = {"logsnr_s": jnp.asarray(logsnr_s), "logsnr_t": jnp.asarray(logsnr_t)}
    pctx = {"logsnr_s": torch.from_numpy(logsnr_s), "logsnr_t": torch.from_numpy(logsnr_t)}
    jx, jz, jv = map(jnp.asarray, (x0, z, v))
    px, pz, pv = map(torch.from_numpy, (x0, z, v))
    pairs = [
        (want.q_posterior(jx, jz, jctx), got.q_posterior(px, pz, pctx)),
        (want.variance_fixed_large(jctx, z.shape), got.variance_fixed_large(pctx, z.shape)),
        ((want.predict_x_from_epsilon(jz, jv, jctx),), (got.predict_x_from_epsilon(pz, pv, pctx),)),
        ((want.predict_x_from_v(jz, jv, jctx),), (got.predict_x_from_v(pz, pv, pctx),)),
        ((want.predict_epsilon_from_x(jz, jx, jctx),),
         (got.predict_epsilon_from_x(pz, px, pctx),)),
    ]
    for i, (ws, gs) in enumerate(pairs):
        for w, g in zip(ws, gs):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                       err_msg=str(i))
    d = np.concatenate([np.float32([1e-6, 1e-3, 0.5, np.log(2.0), 0.7, 5.0, 40.0]),
                        logsnr_s - logsnr_t]).astype(np.float32)
    np.testing.assert_allclose(log1mexp(torch.from_numpy(d)).numpy(),
                               np.asarray(jax_log1mexp(jnp.asarray(d))), rtol=1e-6)


def test_inv_cos_timestep_embedding_matches_jax():
    """logSNR values inside and beyond the clip range [-20, 20]."""
    from xdiffusion_tpu.layers.embedding import InvCosTimestepEmbeddingProjection as JaxInvCos

    from xdiffusion_tpu_torch.layers.embedding import InvCosTimestepEmbeddingProjection
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params
    from flax import traverse_util

    logsnr = np.float32([-30.0, -20.0, -5.5, 0.0, 0.3, 7.0, 20.0, 25.0])
    jmod = JaxInvCos(num_features=32, time_embedding_mult=4, max_time=1.0)
    port = InvCosTimestepEmbeddingProjection(32, 4, max_time=1.0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(logsnr))
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(variables["params"]).items()}
    drawn = random_flax_params(flat, 0)
    load_flax_params(port, drawn)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(logsnr)))
    with torch.no_grad():
        got = port(torch.from_numpy(logsnr))
    assert got.shape == (8, 128) and port.out_features == 128
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("sampler", ["ddim", "ancestral"])
@pytest.mark.parametrize("steps", [10, 50, 1024])
def test_continuous_step_context_matches_jax(sampler, steps):
    """The per-step times and logSNR pairs of each sampler on the
    headline's schedule: equal to JAX's, in loop order."""
    from xdiffusion_tpu.samplers.ancestral import AncestralSampler as JaxAncestral
    from xdiffusion_tpu.samplers.ddim import DDIMSampler as JaxDDIM

    from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

    jmodel, _, pmodel = build(HEADLINE)
    jsampler, psampler = {"ddim": (JaxDDIM(), DDIMSampler()),
                          "ancestral": (JaxAncestral(), AncestralSampler())}[sampler]
    want = jsampler.step_context(jmodel, steps)
    got = psampler.step_context(pmodel, steps)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == (steps,), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["timestep"].dtype == torch.float32


@pytest.mark.parametrize("name", CONTINUOUS_CONFIGS)
def test_continuous_config_forward_matches_jax(name):
    check_forward(name)


def test_headline_forward_matches_jax_in_bf16():
    check_forward(HEADLINE, "bfloat16")


@pytest.mark.parametrize("name,sampler", [(n, "config") for n in CONTINUOUS_CONFIGS]
                         + [(HEADLINE, "ddim"), ("mnist/ddpm_32x32_epsilon_continuous", "ddim")])
def test_continuous_config_trajectory_matches_jax(name, sampler):
    check_trajectory(name, sampler=sampler)


def test_headline_guided_trajectory_matches_jax_in_bf16():
    check_trajectory(HEADLINE, "bfloat16")


@pytest.mark.parametrize("name", CONTINUOUS_CONFIGS)
def test_continuous_config_loss_matches_jax(name):
    check_loss(name)


# ---- the trainer and the CLI on a tiny text-conditioned continuous config ---


def _tiny_headline(path) -> str:
    """The headline config cut to 16x16 (num_features 32, multipliers [1,
    2], cross-attention at 8x8 over 64 + 77 keys) and 8 logSNR scales, so
    the trainer's 8-step sample grids stay quick."""
    with open(config_path(HEADLINE)) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["noise_scheduler"]["params"]["num_scales"] = 8
    diff["sampling"]["output_spatial_size"] = 16
    sn = diff["score_network"]["params"]
    sn.update(num_features=32, channel_multipliers=[1, 2], num_resnet_blocks=1,
              input_spatial_size=16)
    sn["attention"]["attention_resolutions"] = [8]
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    cfg["data"]["image_size"] = 16
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_prompt_conditioned_training_resumes_bit_for_bit(tmp_path, built_once):
    """train() on the tiny headline: each step's prompts come through the
    CLIP embedder from np.random.default_rng((seed, step)), so a run
    resumed from step 2 repeats step 2's loss bit for bit; the guided
    grids are written. Both runs take the dataset built once
    (`built_once`: the same synthetic digits either way)."""
    from xdiffusion_tpu_torch.training.image.train import train

    config = _tiny_headline(tmp_path / "tiny_v_continuous_clip.yaml")
    common = dict(batch_size=4, save_and_sample_every_n=2, num_samples=4, seed=3,
                  device="cpu", log_every=1, sample_with_guidance=True)
    out = train(config, num_training_steps=3, output_path=str(tmp_path / "run"), **common)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        first = {r["step"]: r for r in map(__import__("json").loads, f)}
    assert sorted(first) == [0, 1, 2] and all(np.isfinite(r["loss"]) for r in first.values())
    for name in ("sample-2.png", "sample-3.png", "checkpoints/2.pt"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    resumed = train(config, num_training_steps=3, output_path=str(tmp_path / "resumed"),
                    resume_from=os.path.join(out, "checkpoints", "2.pt"), **common)
    with open(os.path.join(resumed, "metrics.jsonl")) as f:
        again = {r["step"]: r for r in map(__import__("json").loads, f)}
    assert again[2]["loss"] == first[2]["loss"]


def test_sample_cli_with_text_prompts(tmp_path):
    """--text_prompts repeats the prompts over the samples, as
    sampling/image/sample.py does: with four samples "1,2" gives prompts
    1, 2, 1, 2, and the samples equal sample() with those prompts."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import randomize_

    config = _tiny_headline(tmp_path / "tiny.yaml")
    model = GaussianDiffusion_DDPM(load_yaml(config), device="cpu")
    randomize_(model.score_network(), 5)
    ckpt = str(tmp_path / "weights.pt")
    torch.save(model.score_network().state_dict(), ckpt)
    got = cli.main(["--config_path", config, "--checkpoint", ckpt, "--num_samples", "4",
                    "--sampling_steps", "3", "--guidance", "1.0", "--text_prompts", "1, 2",
                    "--output_path", str(tmp_path / "out"), "--device", "cpu", "--seed", "2"])
    assert os.path.getsize(tmp_path / "out" / "sample-step0.png") > 0
    want = model.sample(num_samples=4, num_sampling_steps=3, classifier_free_guidance=1.0,
                        context={"text_prompts": ["1", "2", "1", "2"]},
                        generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
