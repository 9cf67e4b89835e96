"""The consistency process in the port against the JAX package on the CPU:
the (EMA rate, N scales) schedule in every mode, the Karras boundaries and
weightings, the training and distillation losses and the student's
gradients with JAX's draws rebuilt and injected, one optimizer step with
the target and EMA updates, every consistency sampler with JAX's per-step
draws, the `euler_ancestral` refusal, both shipped configs at full width,
and the distill_consistency and sampling CLIs with --device cpu.

The losses run on tiny SongUNets as tests/test_torch_port_edm.py builds
them (16x16, one channel, model_channels 32, channel_mult [8, 8]: one
attention head of 256 channels, K1's plain version at head dim 256) under
EDM preconditioning with the consistency configs' sigma range; the
samplers on a smaller one at 8x8. Weights are seeded flax trees carried
into the port through the bridge (weights.load_flax_params), tree by tree. fp32
throughout: the two packages sum in other orders, nothing else differs.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_edm import SMALL, SONG, _close, _x

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs/image/mnist")
SAMPLERS_DIR = os.path.join(CONFIG_DIR, "samplers")
PRECOND = dict(label_dim=0, sigma_min=0.002, sigma_max=80.0, sigma_data=0.5)


def _config(backbone=SONG, distillation=False, sampler=None):
    size = backbone["img_resolution"]
    sampler = sampler or {"target": "xdiffusion_tpu.samplers.consistency.OneStepConsistencySampler",
                          "params": {"sigma_min": 0.002, "sigma_max": 80, "rho": 7,
                                     "clip_denoised": True}}
    loss = "ConsistencyDistillationLoss" if distillation else "ConsistencyTrainingLoss"
    return {
        "target": "xdiffusion_tpu.diffusion.consistency.GaussianDiffusion_ConsistencyModel",
        "diffusion": {
            "sampling": dict(sampler, output_channels=1, output_spatial_size=size),
            "consistency_model": {"rho": 7, "target_ema": {
                "target_ema_mode": "adaptive", "start_ema": 0.95, "scale_mode": "progressive",
                "start_scales": 2, "end_scales": 200}},
            "exponential_moving_average": {"target_ema_mode": "fixed", "start_ema": 0.9999,
                                           "scale_mode": "fixed", "start_scales": 0},
            "loss": {"target": f"xdiffusion_tpu.diffusion.consistency.{loss}",
                     "params": {"sigma_data": 0.5, "rho": 7.0, "weight_schedule": "uniform",
                                "loss_norm": "l2"}},
            "score_network": {
                "target": "xdiffusion_tpu.score_networks.edm.EDMPrecond",
                "params": dict(PRECOND, img_resolution=size, img_channels=1,
                               model={"target": "xdiffusion_tpu.score_networks.edm.SongUNet",
                                      "params": dict(backbone)}),
            },
        },
        "data": {"image_size": size, "num_channels": 1, "num_classes": 10},
    }


def _trees(jmodel, seeds):
    """Seeded flattened flax trees of the process's network, one per name."""
    from xdiffusion_tpu_torch.weights import random_flax_params

    size = jmodel.config().data.image_size
    init = jax.eval_shape(lambda: jmodel.score_network().init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)), jnp.ones((1,))))
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}
    return {name: random_flax_params(flat, seed=seed) for name, seed in seeds.items()}


def _jax_tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


def _build(cfg):
    """(jax process, its params dict, port process): score, target and EMA
    networks each on its own seeded tree."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.consistency import (
        GaussianDiffusion_ConsistencyModel as JaxConsistency,
    )

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.consistency import GaussianDiffusion_ConsistencyModel
    from xdiffusion_tpu_torch.weights import load_flax_params

    jmodel = JaxConsistency(JaxDotConfig(cfg))
    trees = _trees(jmodel, {"score": 7, "target": 8, "ema": 9})
    params = {name: _jax_tree(flat) for name, flat in trees.items()}
    pmodel = GaussianDiffusion_ConsistencyModel(DotConfig(copy.deepcopy(cfg)), device="cpu")
    nets = pmodel.networks()
    assert sorted(nets) == sorted(trees)
    for name, flat in trees.items():
        load_flax_params(nets[name], flat)
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(backbone="song", distillation=False):
        key = (backbone, distillation)
        if key not in cache:
            cache[key] = _build(_config(SONG if backbone == "song" else SMALL, distillation))
        return cache[key]

    return get


# ---- the schedule, the boundaries, the weightings ----------------------------

SCHEDULES = {
    "fixed": dict(target_ema_mode="fixed", start_ema=0.95, scale_mode="fixed",
                  start_scales=40),
    "adaptive_progressive": dict(target_ema_mode="adaptive", start_ema=0.95,
                                 scale_mode="progressive", start_scales=2, end_scales=200),
    "fixed_progressive": dict(target_ema_mode="fixed", start_ema=0.9, scale_mode="progressive",
                              start_scales=10, end_scales=150),
    "progdist": dict(target_ema_mode="fixed", start_ema=0.95, scale_mode="progdist",
                     start_scales=64, distill_steps_per_iter=50),
}


@pytest.mark.parametrize("mode", list(SCHEDULES))
def test_ema_and_scales_schedule_matches_jax(mode):
    """(target EMA rate, N) at steps 0 to past the end, equal to JAX's: the
    same float64 numpy, so exactly."""
    from xdiffusion_tpu.layers.ema import create_ema_and_scales_fn as jax_fn

    from xdiffusion_tpu_torch.layers.ema import create_ema_and_scales_fn

    kw = dict(SCHEDULES[mode], total_steps=1000)
    want, got = jax_fn(**kw), create_ema_and_scales_fn(**kw)
    for step in (0, 1, 7, 49, 50, 99, 100, 250, 333, 500, 999, 1000, 1200):
        g, w = got(step), want(step)
        assert g == w and isinstance(g[0], float) and isinstance(g[1], int), (step, g, w)


def test_karras_boundaries_and_weightings_match_jax():
    """The fp32 boundaries for N in {2, 18, 201} (N - 1 floored at 1) at
    every index, to 1 fp32 ulp; each weight schedule on their SNRs to 2
    ulps."""
    from xdiffusion_tpu.diffusion import consistency as jc

    from xdiffusion_tpu_torch.diffusion import consistency as pc

    for n in (2, 18, 201):
        idx = np.arange(max(n - 1, 1), dtype=np.float32)
        want = jc._karras_boundaries(jnp.asarray(idx), jnp.int32(n), 0.002, 80.0, 7.0)
        got = pc._karras_boundaries(torch.from_numpy(idx), torch.tensor(n), 0.002, 80.0, 7.0)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1.2e-7, atol=0)
        snr = got[0] ** -2
        for schedule in ("snr", "snr+1", "karras", "truncated-snr", "uniform"):
            np.testing.assert_allclose(
                pc.get_weightings(schedule, snr, 0.5).numpy(),
                np.asarray(jc.get_weightings(schedule, jnp.asarray(snr.numpy()), 0.5)),
                rtol=2.4e-7, atol=0)
    with pytest.raises(NotImplementedError):
        pc.get_weightings("lognormal", snr, 0.5)


# ---- the losses ----------------------------------------------------------------

N_SCALES = 18


def _jax_draws(rng, b, shape, num_scales):
    """The loss's draws as JAX makes them inside it from `rng`."""
    rng_i, rng_n = jax.random.split(rng)
    noise = np.array(jax.random.normal(rng_n, shape))
    indices = np.array(jax.random.randint(rng_i, (b,), 0, max(num_scales - 1, 1)))
    return indices, noise


def _teacher(jmodel):
    """A teacher network (another seeded tree) on both sides."""
    from xdiffusion_tpu_torch.weights import load_flax_params

    flat = _trees(jmodel, {"teacher": 11})["teacher"]
    tparams = _jax_tree(flat)
    jnet = jmodel.score_network()

    def jteacher(x, sigma):
        return jnet.apply(tparams, x, sigma)

    return jteacher, flat, load_flax_params


def _loss_case(built, distillation):
    """The loss at batch 2 with JAX's draws injected: (jax loss, jax metrics,
    jax score gradients, port loss, port metrics, port process)."""
    jmodel, params, pmodel = built("song", distillation)
    rng = jax.random.PRNGKey(3)
    images = np.random.default_rng(2).random((2, 16, 16, 1)).astype(np.float32)
    indices, noise = _jax_draws(rng, 2, images.shape, N_SCALES)
    kwargs, pkwargs = {}, {}
    if distillation:
        jteacher, flat, load = _teacher(jmodel)
        pteacher = copy.deepcopy(pmodel.score_network())
        load(pteacher, flat)
        kwargs["teacher_denoise_fn"] = jteacher
        pkwargs["teacher_denoise_fn"] = lambda x, s: pteacher(x, s)

    def jloss(score):
        return jmodel.loss_on_batch({**params, "score": score}, rng, jnp.asarray(images),
                                    {"num_scales": jnp.int32(N_SCALES)}, **kwargs)

    (want, wm), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params["score"])
    net = pmodel.score_network()
    net.zero_grad()
    got, gm = pmodel.loss_on_batch(torch.from_numpy(images), {"num_scales": N_SCALES},
                                   indices=torch.from_numpy(indices),
                                   noise=torch.from_numpy(noise), **pkwargs)
    got.backward()
    return want, wm, grads, got, gm, pmodel


@pytest.fixture(scope="module")
def losses(built):
    return {d: _loss_case(built, d) for d in (False, True)}


@pytest.mark.parametrize("distillation", [False, True], ids=["training", "distillation"])
def test_loss_and_student_gradients_match_jax(losses, distillation):
    """Consistency training (Euler step toward x0) and distillation (a Heun
    step through a teacher) with JAX's indices and noise: the loss and each
    example's to 1e-5 relative; every score-network gradient against
    jax.value_and_grad to 1e-3 of its largest magnitude, floored at 1e-3 of
    the network's largest gradient (fp32 sums in other orders through the
    backward of 10 blocks); the target network gets no gradient."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    want, wm, grads, got, gm, pmodel = losses[distillation]
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(gm["loss_per_example"].numpy(),
                               np.asarray(wm["loss_per_example"]), rtol=1e-5)
    assert int(gm["timesteps"]) == N_SCALES
    net = pmodel.score_network()
    flat = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(
        grads["params"]).items()}
    want_grads = flax_to_state_dict(flat, net)
    floor = 1e-3 * max(g.abs().max().item() for g in want_grads.values())
    for name, p in net.named_parameters():
        w = want_grads[name]
        err = (p.grad - w).abs().max().item()
        assert err <= max(1e-3 * w.abs().max().item(), floor), (name, err)
    assert all(p.grad is None for p in pmodel.networks()["target"].parameters())


def test_losses_run_the_networks_without_dropout(built):
    """The SongUNet drops at 0.1, but the JAX losses apply the networks
    without `deterministic=False`: the port's loss is the same, bit for
    bit, with the networks in training or eval mode, and with a generator
    drawing its indices and noise (which would feed dropout if the loss
    passed it on)."""
    _, _, pmodel = built("song", False)
    assert pmodel.config().diffusion.score_network.params.model.params.dropout == 0.1
    images = torch.rand((2, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    out = []
    for training in (True, False):
        for net in pmodel.networks().values():
            net.train(training)
        with torch.no_grad():
            loss, _ = pmodel.loss_on_batch(images, {"num_scales": N_SCALES},
                                           generator=torch.Generator().manual_seed(4))
        out.append(loss.item())
    for net in pmodel.networks().values():
        net.eval()
    assert out[0] == out[1] and np.isfinite(out[0])


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def test_one_step_and_auxiliary_updates_match_jax(built, losses):
    """One Adam step of the score network (the default optimizer, clip and
    all) from JAX's gradients of the training loss, loaded into the port's
    `.grad`, then update_auxiliary_params with the schedule's step-0 rate
    (in fp32, as the JAX step's traced scalar) and the sampling EMA's
    0.9999, against JAX's: score, target and EMA each within 1e-6 of the
    largest magnitude of its parameter (fp32 rounding of the same
    arithmetic; the largest miss is about one ulp). Adam's first step moves
    each parameter by about lr = 2e-4: a step that did nothing or a reversed
    one misses by lr or 2 lr, and a target moved before the score network's
    step misses by (1 - r) lr, each well above the tolerance."""
    import optax
    from xdiffusion_tpu.optim import default_optimizer as jax_optimizer

    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    jmodel, params, pmodel = built("song", False)
    _, _, grads, _, _, _ = losses[False]
    target_ema, _ = pmodel.scale_fn(100)(0)
    tx = jax_optimizer().build()

    def jax_step(params, grads, rate):
        updates, _ = tx.update(grads, tx.init(params["score"]), params["score"])
        score = optax.apply_updates(params["score"], updates)
        return jmodel.update_auxiliary_params({**params, "score": score}, rate, ema_rate=0.9999)

    new = jax.jit(jax_step)(params, grads, jnp.float32(target_ema))

    nets = pmodel.networks()
    jax_grads = flax_to_state_dict(_flat(grads["params"]), nets["score"])
    for name, p in nets["score"].named_parameters():
        p.grad = jax_grads[name].clone()
    default_optimizer().build(nets["score"].parameters()).step()
    pmodel.update_auxiliary_params(target_ema, ema_rate=0.9999)
    for name in ("score", "target", "ema"):
        want = flax_to_state_dict(_flat(new[name]["params"]), nets[name])
        state = nets[name].state_dict()
        for key, w in want.items():
            err = (state[key] - w).abs().max().item()
            assert err <= 1e-6 * w.abs().max().item(), (name, key, err)


def test_train_refuses_a_consistency_config(tmp_path):
    """train() names the distill_consistency CLI, where JAX's trainer fails on
    the missing context['num_scales']; a loss without N says the same."""
    from xdiffusion_tpu_torch.training.image.train import train

    path = tmp_path / "cm.yaml"
    path.write_text(yaml.safe_dump(_config(SMALL)))
    with pytest.raises(ValueError, match="distill_consistency"):
        train(str(path), num_training_steps=1, batch_size=2, device="cpu",
              output_path=str(tmp_path / "out"))


# ---- the samplers --------------------------------------------------------------

SAMPLER_CASES = {
    "onestep_class": None,
    "onestep": dict(sampler="onestep"),
    "multistep": dict(sampler="multistep", steps=40, multistep=[0, 22, 39]),
    "euler": dict(sampler="euler", steps=4),
    "progdist": dict(sampler="progdist", steps=4),
    "ancestral": dict(sampler="ancestral", steps=4),
    "heun": dict(sampler="heun", steps=4, s_churn=10.0, s_tmin=0.05, s_tmax=50.0),
    "dpm": dict(sampler="dpm", steps=4, s_churn=10.0, s_tmin=0.05, s_tmax=50.0),
}
DRAWS = {"multistep": 2, "ancestral": 4, "heun": 4, "dpm": 4}
# JAX's `sample` caches its compiled loop by id(sampler): the samplers stay
# alive so that no later one takes a freed one's id.
_JAX_SAMPLERS = []


def _jax_step_noise(rng, n, shape):
    """The per-step draws of JAX's consistency samplers for `sample(rng)`:
    the scan's key splits (heun's extra draw after its scan continues the
    chain)."""
    key, _ = jax.random.split(rng)
    draws = []
    for _ in range(n):
        key, nk = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(nk, shape, dtype=jnp.float32)))
    return np.stack(draws) if draws else np.zeros((0,) + shape, np.float32)


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_matches_jax(built, case):
    """Each sampler on the EMA network with the same latents and JAX's
    per-step draws (churn where it takes them): 2e-4 absolute on samples in
    [0, 1] (fp32 from sigma 80)."""
    from xdiffusion_tpu.samplers import consistency as jsamplers

    from xdiffusion_tpu_torch.samplers import consistency as psamplers

    jmodel, params, pmodel = built("small", False)
    kw = SAMPLER_CASES[case]
    if kw is None:
        jsampler = psampler = None  # the config's OneStepConsistencySampler
    else:
        jsampler = jsamplers.GeneralizedConsistencySampler(**kw)
        psampler = psamplers.GeneralizedConsistencySampler(**kw)
        _JAX_SAMPLERS.append(jsampler)
    shape = (2, 8, 8, 1)
    latents = _x(shape, seed=4)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jmodel.sample(params, rng, num_samples=2, sampler=jsampler,
                                    initial_noise=jnp.asarray(latents)))
    noise = _jax_step_noise(rng, DRAWS.get(case, 0), shape)
    got = pmodel.sample(num_samples=2, sampler=psampler, initial_noise=torch.from_numpy(latents),
                        context={"sampling_noise": torch.from_numpy(noise)}).numpy()
    assert got.shape == shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_euler_ancestral_override_is_refused_as_in_jax(built):
    """configs/image/mnist/samplers/consistency_model_euler_ancestral.yaml
    names a sampler neither package has: both raise the same ValueError when
    sampling starts, before any network call."""
    from xdiffusion_tpu.config import instantiate_from_config as jax_instantiate
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml

    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml

    path = os.path.join(SAMPLERS_DIR, "consistency_model_euler_ancestral.yaml")
    jmodel, params, pmodel = built("small", False)
    jsampler = jax_instantiate(jax_load_yaml(path).sampling.to_dict())
    _JAX_SAMPLERS.append(jsampler)
    psampler = instantiate_from_config(load_yaml(path).sampling.to_dict())
    message = "unknown consistency sampler 'euler_ancestral'"
    with pytest.raises(ValueError, match=message):
        jmodel.sample(params, jax.random.PRNGKey(0), num_samples=2, sampler=jsampler)
    with pytest.raises(ValueError, match=message):
        pmodel.sample(num_samples=2, sampler=psampler)


# ---- the shipped configs and the CLIs ------------------------------------------


@pytest.mark.parametrize("name", ["consistency_model.yaml",
                                  "consistency_model_distillation.yaml"])
def test_consistency_config_builds_at_full_width(name):
    """Each shipped consistency config builds on the CPU (build_model): the
    process, three networks of the same SongUNet (dropout 0.1, one head of
    256 channels at 16x16), the loss, the one-step sampler, the schedule."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.consistency import (
        ConsistencyDistillationLoss,
        ConsistencyTrainingLoss,
        GaussianDiffusion_ConsistencyModel,
    )
    from xdiffusion_tpu_torch.samplers.consistency import OneStepConsistencySampler
    from xdiffusion_tpu_torch.training.image.train import build_model

    model = build_model(load_yaml(os.path.join(CONFIG_DIR, name)), device="cpu")
    assert isinstance(model, GaussianDiffusion_ConsistencyModel)
    nets = model.networks()
    assert sorted(nets) == ["ema", "score", "target"]
    counts = {k: sum(p.numel() for p in n.parameters()) for k, n in nets.items()}
    assert len(set(counts.values())) == 1 and counts["score"] > 50_000_000
    assert not any(p.requires_grad for k in ("target", "ema") for p in nets[k].parameters())
    heads = {m.num_heads for m in nets["score"].modules() if getattr(m, "attention", False)}
    assert heads == {1}
    distill = "distillation" in name
    assert isinstance(model._loss, ConsistencyDistillationLoss if distill
                      else ConsistencyTrainingLoss)
    assert isinstance(model._sampler, OneStepConsistencySampler)
    assert model.scale_fn(1000)(0) == ((0.95, 40) if distill else (0.9025, 2))


def _tiny_yaml(tmp_path, name, cfg):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_distill_consistency_and_sampling_clis(tmp_path, monkeypatch):
    """`python -m xdiffusion_tpu_torch.distill_consistency` with --device cpu:
    3 steps of consistency distillation from a tiny EDM teacher's checkpoint
    (its parameters; the EMA it also holds is a decoy), then 3 of
    consistency training, each writing metrics, a grid and a checkpoint of
    the three networks; then the sampling CLI on a checkpoint with the
    one-step and multistep overrides (the EMA network's weights)."""
    from test_torch_port_edm import _config as edm_config
    from test_torch_port_train import _mnist_dir

    from xdiffusion_tpu_torch import distill_consistency as cli
    from xdiffusion_tpu_torch import sample as sample_cli
    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.edm import GaussianDiffusion_EDM

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", _mnist_dir(tmp_path))
    teacher_cfg = edm_config("small")
    teacher_path = _tiny_yaml(tmp_path, "teacher.yaml", teacher_cfg)
    teacher = GaussianDiffusion_EDM(DotConfig(teacher_cfg), device="cpu").score_network()
    decoy = {k: torch.full_like(v, float("nan")) for k, v in teacher.state_dict().items()}
    ckpt = tmp_path / "teacher.pt"
    torch.save({"step": 5, "params": teacher.state_dict(), "ema": decoy}, ckpt)

    runs = {}
    for distill in (True, False):
        student = _tiny_yaml(tmp_path, f"student_{distill}.yaml", _config(SMALL, distill))
        out = str(tmp_path / f"out_{distill}")
        assert cli.main(["--teacher_config_path", teacher_path, "--student_config_path",
                         student, "--teacher_checkpoint", str(ckpt), "--num_training_steps", "3",
                         "--batch_size", "4", "--output_path", out, "--device", "cpu"]) == out
        records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
        assert [r["step"] for r in records] == [0] and np.isfinite(records[0]["loss"])
        assert records[0]["num_scales"] == 2
        assert os.path.getsize(os.path.join(out, "sample-3.png")) > 0
        payload = torch.load(os.path.join(out, "checkpoints", "3.pt"), weights_only=True)
        assert payload["step"] == 3 and {"params", "target", "ema", "optimizer"} <= set(payload)
        assert all(torch.isfinite(v).all() for v in payload["params"].values()
                   if v.is_floating_point())
        runs[distill] = student, os.path.join(out, "checkpoints", "3.pt"), payload

    student, path, payload = runs[True]
    for override in ("consistency_model_onestep.yaml", "consistency_model_multistep.yaml"):
        samples = sample_cli.main([
            "--config_path", student, "--checkpoint", path, "--num_samples", "3",
            "--sampler_config_path", os.path.join(SAMPLERS_DIR, override),
            "--output_path", str(tmp_path / override[:-5]), "--device", "cpu"])
        assert samples.shape == (3, 8, 8, 1) and bool(torch.isfinite(samples).all())
        assert os.path.getsize(tmp_path / override[:-5] / "sample-step3.png") > 0
    # The CLI sampled with the checkpoint's EMA weights.
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    model = build_model(load_yaml(student), device="cpu")
    from xdiffusion_tpu_torch.weights import load_checkpoint

    assert load_checkpoint(model.sampling_network(), path) == 3
    for k, v in model.sampling_network().state_dict().items():
        torch.testing.assert_close(v, payload["ema"][k], rtol=0, atol=0)
