"""The score-SDE path: the VP and sub-VP SDEs, the predictors and
correctors, the predictor-corrector trajectories and the denoising
score-matching loss of the port against the JAX package on the CPU, on the
same seeded weights and the same randomness. The JAX package draws its
noise from keys and takes no injection into the loss; these tests split the
same keys as it does (`jax.random.split`, then `uniform` and `normal`) and
hand the draws to the port, which takes them as arguments. fp32 throughout.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs/image/mnist")
SDE_CONFIGS = ["score_sde_vpsde_continuous.yaml", "score_sde_vpsde_discrete.yaml",
               "score_sde_subvpsde.yaml"]
SHAPE = (2, 16, 16, 1)


def _pair(name, **kw):
    """(JAX SDE, port SDE) of the same class and parameters."""
    from xdiffusion_tpu.sde import subvpsde as jsub
    from xdiffusion_tpu.sde import vpsde as jvp

    from xdiffusion_tpu_torch.sde import subvpsde, vpsde

    if name == "VPSDE":
        return jvp.VPSDE(**kw), vpsde.VPSDE(**kw)
    return jsub.subVPSDE(**kw), subvpsde.subVPSDE(**kw)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([1e-3, 0.6137], dtype=np.float32)
    return x, t


@pytest.mark.parametrize("name", ["VPSDE", "subVPSDE"])
def test_sde_statistics_match_jax(name):
    """Drift and diffusion, the marginal mean and std, the discretisation
    (VP: DDPM's, at steps next to the table's boundaries; sub-VP: Euler-
    Maruyama), the prior's log-density and the reverse SDE: 1e-6 relative."""
    jsde, psde = _pair(name, beta_min=0.1, beta_max=20.0, N=1000)
    x, t = _data()
    t = np.array([0.0, 0.5005005, 1.0], dtype=np.float32)
    x = np.concatenate([x, x[:1]])
    jx, jt, px, pt = jnp.asarray(x), jnp.asarray(t), torch.from_numpy(x), torch.from_numpy(t)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)

    for method in ("sde", "marginal_prob", "discretize"):
        for got, want in zip(getattr(psde, method)(px, pt), getattr(jsde, method)(jx, jt)):
            close(got, want)
    close(psde.prior_logp(px), jsde.prior_logp(jx))

    def jscore(xx, tt):
        return -xx * (1.0 + tt)[:, None, None, None]

    def pscore(xx, tt):
        return -xx * (1.0 + tt)[:, None, None, None]

    for flow in (False, True):
        jrev, prev = jsde.reverse(jscore, flow), psde.reverse(pscore, flow)
        for method in ("sde", "discretize"):
            for got, want in zip(getattr(prev, method)(px, pt), getattr(jrev, method)(jx, jt)):
                close(got, want)
    if name == "VPSDE":
        np.testing.assert_array_equal(psde.sqrt_1m_alphas_cumprod.numpy(),
                                      np.asarray(jsde.sqrt_1m_alphas_cumprod))


def _score_fns():
    return (lambda xx, tt: -xx * (1.0 + tt)[:, None, None, None],
            lambda xx, tt: -xx * (1.0 + tt)[:, None, None, None])


def _drawer(arrays):
    it = iter(arrays)
    return lambda: torch.from_numpy(np.asarray(next(it)))


@pytest.mark.parametrize("name", ["VPSDE", "subVPSDE"])
@pytest.mark.parametrize("predictor,flow", [("AncestralSamplingPredictor", False),
                                            ("EulerMaruyamaPredictor", False),
                                            ("EulerMaruyamaPredictor", True),
                                            ("ReverseDiffusionPredictor", False),
                                            ("ReverseDiffusionPredictor", True)])
def test_predictor_update_matches_jax(name, predictor, flow):
    """One update of each predictor (and the probability-flow forms) with
    the JAX draw `normal(rng, x.shape)` injected: x and its mean, 1e-6
    relative."""
    from xdiffusion_tpu.samplers import pc as jpc

    from xdiffusion_tpu_torch.samplers import pc

    jsde, psde = _pair(name)
    jscore, pscore = _score_fns()
    x, t = _data(1)
    rng = jax.random.PRNGKey(3)
    want = getattr(jpc, predictor)(jsde, jscore, flow).update(rng, jnp.asarray(x), jnp.asarray(t))
    draw = _drawer([jax.random.normal(rng, SHAPE, dtype=jnp.float32)])
    got = getattr(pc, predictor)(psde, pscore, flow).update(torch.from_numpy(x),
                                                            torch.from_numpy(t), draw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["VPSDE", "subVPSDE"])
@pytest.mark.parametrize("n_steps", [1, 2])
def test_correctors_match_jax(name, n_steps):
    """The Langevin corrector's n_steps updates with its draws (split off
    the key as JAX splits them) injected, and the none corrector: 1e-6
    relative."""
    from xdiffusion_tpu.samplers import pc as jpc

    from xdiffusion_tpu_torch.samplers import pc

    jsde, psde = _pair(name)
    jscore, pscore = _score_fns()
    x, t = _data(2)
    rng = jax.random.PRNGKey(4)
    want = jpc.LangevinCorrector(jsde, jscore, snr=0.16, n_steps=n_steps).update(
        rng, jnp.asarray(x), jnp.asarray(t))
    draws, key = [], rng
    for _ in range(n_steps):
        key, step_rng = jax.random.split(key)
        draws.append(jax.random.normal(step_rng, SHAPE, dtype=jnp.float32))
    got = pc.LangevinCorrector(psde, pscore, snr=0.16, n_steps=n_steps).update(
        torch.from_numpy(x), torch.from_numpy(t), _drawer(draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    px = torch.from_numpy(x)
    assert all(v is px for v in pc.NoneCorrector().update(px, torch.from_numpy(t), None))


def _small_config(name, dropout=0.1):
    """The config at num_features 32 and two levels (attention at 16x16: 2
    heads of 64)."""
    with open(os.path.join(CONFIG_DIR, name)) as f:
        cfg = yaml.safe_load(f)
    sn = cfg["diffusion"]["score_network"]["params"]
    sn["num_features"] = 32
    sn["channel_multipliers"] = [1, 2]
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    sn["dropout"] = dropout
    sn["conditioning"]["context_transformer_layer"]["params"]["dropout"] = dropout
    return cfg


def _build(cfg, seed=7):
    """(jax process, flax params, port process) sharing seeded weights."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.sde import GaussianDiffusion_SDE as JaxSDE

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.sde import GaussianDiffusion_SDE
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxSDE(JaxDotConfig(copy.deepcopy(cfg)))
    init = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0)))
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}
    drawn = random_flax_params(flat, seed=seed)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    pmodel = GaussianDiffusion_SDE(DotConfig(copy.deepcopy(cfg)), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, params, pmodel


def _pc_draws(rng, steps, corrector_draws, shape):
    """The draws of the JAX PC sampler's scan for `sample(rng)`, per step the
    corrector's (split off rng_c) and then the predictor's (rng_p)."""
    key, _ = jax.random.split(rng)
    out = []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        rng_c, rng_p = jax.random.split(sk)
        step = []
        for _ in range(corrector_draws):
            rng_c, step_rng = jax.random.split(rng_c)
            step.append(jax.random.normal(step_rng, shape, dtype=jnp.float32))
        step.append(jax.random.normal(rng_p, shape, dtype=jnp.float32))
        out.append(np.stack([np.asarray(a) for a in step]))
    return np.stack(out)


@pytest.mark.parametrize("name", SDE_CONFIGS)
def test_pc_trajectory_matches_jax(name):
    """10 predictor-corrector steps of each SDE config (its predictor and
    corrector, the last step's noise-free mean) at num_features 32 and batch
    2, from the same initial noise with JAX's draws: 1e-4 absolute in [0, 1]
    (fp32 sums in other orders through 10 to 20 network evaluations whose
    scores grow as 1 / std near t = 1e-3)."""
    cfg = _small_config(name)
    jmodel, params, pmodel = _build(cfg)
    shape = (2, 32, 32, 1)
    init = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    want = jmodel.sample(params, rng, num_samples=2, num_sampling_steps=10,
                         initial_noise=jnp.asarray(init))
    langevin = "Langevin" in cfg["diffusion"]["sampling"]["params"]["corrector"]["target"]
    draws = _pc_draws(rng, 10, 1 if langevin else 0, shape)
    got = pmodel.sample(num_samples=2, num_sampling_steps=10, initial_noise=torch.from_numpy(init),
                        context={"sampling_noise": torch.from_numpy(draws)})
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["score_sde_vpsde_continuous.yaml",
                                  "score_sde_vpsde_discrete.yaml", "score_sde_subvpsde.yaml"])
def test_sde_loss_and_gradients_match_jax(name):
    """loss_on_batch in continuous time (VP, sub-VP) and discrete time (the
    std from the sqrt(1 - alpha-bar) table at int32(fp32(t) * 999)), dropout
    0 (the JAX loss always drops), JAX's t and z reproduced from its keys and
    injected: the loss and each example's to 1e-5 relative, every gradient
    to 1e-3 of its largest magnitude, floored at 1e-3 of the network's
    largest."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    cfg = _small_config(name, dropout=0.0)
    jmodel, params, pmodel = _build(cfg)
    images = np.random.default_rng(8).random((3, 32, 32, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(9)

    def jloss(p):
        return jmodel.loss_on_batch(p, rng, jnp.asarray(images), {})

    (want, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    rng_t, rng_z, _ = jax.random.split(rng, 3)
    t = jax.random.uniform(rng_t, (3,)) * (1.0 - 1e-5) + 1e-5
    z = jax.random.normal(rng_z, images.shape)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(jm["timesteps"]))
    net = pmodel.score_network()
    got, metrics = pmodel.loss_on_batch(torch.from_numpy(images), {},
                                        timesteps=torch.from_numpy(np.asarray(t)),
                                        noise=torch.from_numpy(np.asarray(z)), deterministic=True)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(metrics["loss_per_example"].numpy(),
                               np.asarray(jm["loss_per_example"]), rtol=1e-5)
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jgrads["params"]).items()}
    want_grads = flax_to_state_dict(flat, net)
    floor = 1e-3 * max(g.abs().max().item() for g in want_grads.values())
    for pname, p in net.named_parameters():
        w = want_grads[pname]
        err = (p.grad - w).abs().max().item()
        assert err <= max(1e-3 * w.abs().max().item(), floor), (pname, err)


def test_discrete_table_index_is_taken_in_fp32():
    """The discrete score's table index is int32(fp32(t) * (N - 1)): at times
    whose fp32 product lands on an entry boundary the port takes JAX's
    entry, not the float64 product's."""
    from xdiffusion_tpu_torch.sde.vpsde import step_index

    t = np.float32(np.arange(1, 1000) / 999.0)
    want = (jnp.asarray(t) * 999).astype(jnp.int32)
    np.testing.assert_array_equal(step_index(torch.from_numpy(t), 1000, 1.0).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("name", SDE_CONFIGS)
def test_sde_config_builds_at_full_width(name):
    """Every score-SDE config as shipped builds on the CPU (build_model):
    the process, its SDE, the UNet and the PC sampler's parts."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.sde import GaussianDiffusion_SDE
    from xdiffusion_tpu_torch.training.image.train import build_model

    model = build_model(load_yaml(os.path.join(CONFIG_DIR, name)), device="cpu")
    assert isinstance(model, GaussianDiffusion_SDE)
    assert type(model.sde()).__name__ == ("subVPSDE" if "subvp" in name else "VPSDE")
    assert model.sde().N == 1000
    assert sum(p.numel() for p in model.score_network().parameters()) > 30e6


def test_sde_through_the_training_and_sampling_clis(tmp_path, monkeypatch):
    """A tiny sub-VP config (num_features 32, two levels, N = 40: the
    discrete betas stay below 1, as the Langevin corrector's alphas need)
    through the training CLI (2 steps, metrics, checkpoint, a 40-step grid)
    and the sampling CLI (its checkpoint, --sampling_steps 3), --device
    cpu."""
    from test_torch_port_train import _mnist_dir

    from xdiffusion_tpu_torch import sample as sample_cli
    from xdiffusion_tpu_torch import train as train_cli

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", _mnist_dir(tmp_path))
    cfg = _small_config("score_sde_subvpsde.yaml")
    cfg["diffusion"]["sde"]["params"]["N"] = 40
    config = tmp_path / "sde_tiny.yaml"
    config.write_text(yaml.safe_dump(cfg))
    out = train_cli.main(["--config_path", str(config), "--batch_size", "4", "--output_path",
                          str(tmp_path / "out"), "--num_training_steps", "2",
                          "--save_and_sample_every_n", "2", "--num_samples", "4",
                          "--device", "cpu"])
    assert os.path.isfile(os.path.join(out, "checkpoints", "2.pt"))
    assert os.path.getsize(os.path.join(out, "sample-2.png")) > 0
    samples = sample_cli.main(["--config_path", str(config), "--checkpoint",
                               os.path.join(out, "checkpoints", "2.pt"), "--num_samples", "2",
                               "--sampling_steps", "3", "--output_path",
                               str(tmp_path / "samples"), "--device", "cpu"])
    assert samples.shape == (2, 32, 32, 1) and bool(torch.isfinite(samples).all())
    assert os.path.getsize(tmp_path / "samples" / "sample-step2.png") > 0
