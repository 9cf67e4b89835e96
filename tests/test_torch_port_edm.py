"""The EDM path: backbones, preconditioners, losses, samplers and the
importer of the port against the JAX package on the CPU, on the same
seeded weights (flax tree -> port through the bridge) and the same injected
randomness (noise levels, noise, every sampler step's draw).

The tiny SongUNets run at model_channels 32 with channel_mult [8, 8] on
16x16 images: every attention site has C = 256 and one head, as the shipped
SongUNet's (256 tokens at 16x16, 64 at the 8x8 decoder entry), so K1's and
K2's plain versions run at head dim 256. fp32 throughout: the JAX package
and the port sum in other orders, nothing else differs.
"""

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
EDM_CONFIGS = ["edm.yaml", "edm_adm.yaml", "edm_ddpmpp.yaml", "edm_ncsnpp.yaml"]

SONG = dict(img_resolution=16, in_channels=1, out_channels=1, label_dim=0, augment_dim=0,
            model_channels=32, channel_mult=[8, 8], channel_mult_emb=4, num_blocks=1,
            attn_resolutions=[16], dropout=0.1, embedding_type="positional",
            channel_mult_noise=1, encoder_type="standard", decoder_type="standard",
            resample_filter=[1, 1])
NCSN = dict(SONG, embedding_type="fourier", channel_mult_noise=2, encoder_type="residual",
            resample_filter=[1, 3, 3, 1])
ADM = dict(img_resolution=16, in_channels=1, out_channels=1, label_dim=0, augment_dim=0,
           model_channels=32, channel_mult=[2, 4], channel_mult_emb=4, num_blocks=1,
           attn_resolutions=[16, 8], dropout=0.1)
# A cheap backbone for the samplers' trajectories (the network is not what
# they test).
SMALL = dict(SONG, img_resolution=8, model_channels=16, channel_mult=[1], attn_resolutions=[])
BACKBONES = {"song": ("SongUNet", SONG), "ncsn": ("SongUNet", NCSN),
             "adm": ("DhariwalUNet", ADM), "small": ("SongUNet", SMALL)}
PRECONDS = {
    "EDMPrecond": dict(sigma_min=0, sigma_max=float("inf"), sigma_data=0.5),
    "VPPrecond": dict(beta_d=19.9, beta_min=0.1, M=1000, epsilon_t=1e-5),
    "VEPrecond": dict(sigma_min=0.02, sigma_max=100),
    "iDDPMPrecond": dict(C_1=0.001, C_2=0.008, M=1000),
}
LOSSES = {"EDMLoss": dict(P_mean=-1.2, P_std=1.2, sigma_data=0.5),
          "VPLoss": dict(beta_d=19.9, beta_min=0.1, epsilon_t=1e-5),
          "VELoss": dict(sigma_min=0.02, sigma_max=100)}


def _config(backbone="song", precond="EDMPrecond", loss="EDMLoss", sampler=None):
    arch, params = BACKBONES[backbone]
    size = params["img_resolution"]
    sampler = sampler or {"target": "xdiffusion_tpu.samplers.edm.StochasticSampler",
                          "params": {"num_steps": 4}}
    return {
        "target": "xdiffusion_tpu.diffusion.edm.GaussianDiffusion_EDM",
        "diffusion": {
            "sampling": dict(sampler, output_channels=1, output_spatial_size=size),
            "loss": {"target": f"xdiffusion_tpu.diffusion.edm.{loss}", "params": LOSSES[loss]},
            "score_network": {
                "target": f"xdiffusion_tpu.score_networks.edm.{precond}",
                "params": dict(PRECONDS[precond], img_resolution=size, img_channels=1,
                               label_dim=0, use_fp16=False,
                               model={"target": f"xdiffusion_tpu.score_networks.edm.{arch}",
                                      "params": dict(params)}),
            },
        },
        "data": {"image_size": size, "num_channels": 1, "num_classes": 10},
    }


def _build(cfg, seed=7):
    """(jax process, flax params, port process) sharing seeded weights."""
    from xdiffusion_tpu.config import DotConfig as JaxDotConfig
    from xdiffusion_tpu.diffusion.edm import GaussianDiffusion_EDM as JaxEDM

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.diffusion.edm import GaussianDiffusion_EDM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxEDM(JaxDotConfig(cfg))
    # Only the tree's shapes are needed: trace the init, compile nothing.
    init = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0)))
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}
    drawn = random_flax_params(flat, seed=seed)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    pmodel = GaussianDiffusion_EDM(DotConfig(cfg), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(backbone="song", precond="EDMPrecond", loss="EDMLoss"):
        key = (backbone, precond, loss)
        if key not in cache:
            cache[key] = _build(_config(backbone, precond, loss))
        return cache[key]

    return get


def _close(got, want, rel):
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("backbone", ["song", "ncsn", "adm"])
def test_backbone_forward_matches_jax(built, backbone):
    """Each design point's backbone (DDPM++: positional/standard; NCSN++:
    Fourier/residual with the [1, 3, 3, 1] filter; ADM: scale-shift, C/64
    heads) on its noise labels: 1e-4 of the output's scale (fp32 sums over
    up to 512 channels and 256 keys in other orders)."""
    jmodel, params, pmodel = built(backbone)
    x = _x((2, 16, 16, 1))
    labels = np.array([-1.3, 0.4], dtype=np.float32)
    # jit: one compile, where op-by-op dispatch compiles every op anew.
    want = jax.jit(jmodel.score_network().module.apply)(params, jnp.asarray(x),
                                                         jnp.asarray(labels))
    with torch.inference_mode():
        got = pmodel.score_network().model(torch.from_numpy(x), torch.from_numpy(labels))
    assert got.shape == (2, 16, 16, 1) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)


def test_song_attention_runs_at_head_dim_256(built):
    """The tiny SongUNet's attention sites are the shipped one's shape class:
    one head of C = 256 at 256 and 64 tokens."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    _, _, pmodel = built("song")
    calls, original = [], fa.short_attention_bsc

    def recording(q, k, v, heads, scale):
        calls.append((q.shape[1], q.shape[2] // heads, heads))
        return original(q, k, v, heads, scale)

    fa.short_attention_bsc = recording
    try:
        with torch.inference_mode():
            pmodel.score_network()(torch.zeros(1, 16, 16, 1), torch.tensor([1.0]))
    finally:
        fa.short_attention_bsc = original
    assert sorted(calls) == [(64, 256, 1), (256, 256, 1), (256, 256, 1)]


@pytest.mark.parametrize("precond", list(PRECONDS))
def test_preconditioner_matches_jax(built, precond):
    """D(x, sigma) of each preconditioner (its c_skip, c_out, c_in, c_noise in
    fp32) over the ADM backbone, at sigmas across its range: 1e-4 of the
    output's scale; the sigma range and, for iDDPM, round_sigma's index."""
    jmodel, params, pmodel = built("adm", precond)
    jnet, pnet = jmodel.score_network(), pmodel.score_network()
    x = _x((3, 16, 16, 1), seed=1) * 2.0
    sigma = np.array([0.01, 0.7, 40.0], dtype=np.float32)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x), jnp.asarray(sigma))
    with torch.inference_mode():
        got = pnet(torch.from_numpy(x), torch.from_numpy(sigma))
    _close(got.numpy(), want, 1e-4)
    assert (pnet.sigma_min, pnet.sigma_max) == (jnet.sigma_min, jnet.sigma_max)
    if precond == "iDDPMPrecond":
        probe = np.geomspace(1e-3, 200.0, 97).astype(np.float32)
        np.testing.assert_array_equal(pnet.round_sigma(probe, return_index=True).numpy(),
                                      np.asarray(jnet.round_sigma(probe, return_index=True)))
        np.testing.assert_array_equal(pnet.round_sigma(probe).numpy(),
                                      np.asarray(jnet.round_sigma(probe)))


@pytest.mark.parametrize("backbone,loss,precond", [("song", "EDMLoss", "EDMPrecond"),
                                                   ("adm", "VPLoss", "VPPrecond"),
                                                   ("adm", "VELoss", "VEPrecond")])
def test_loss_and_gradients_match_jax(built, backbone, loss, precond):
    """Each loss with injected sigma and unit noise, dropout off (the EDM loss
    over the tiny SongUNet, the VP and VE losses over the ADM backbone with
    their preconditioners): the loss and each example's to 1e-5 relative;
    every parameter's gradient against jax.value_and_grad to 1e-3 of its
    largest magnitude, floored at 1e-3 of the network's largest gradient
    (fp32 sums in other orders through the backward of 10 blocks)."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    jmodel, params, pmodel = built(backbone, precond, loss)
    rng = np.random.default_rng(2)
    images = rng.random((2, 16, 16, 1)).astype(np.float32)
    sigma = np.array([0.05, 3.0], dtype=np.float32)
    noise = _x((2, 16, 16, 1), seed=3)

    def jloss(p, xx, s, e):  # the arrays as arguments: closed over, XLA folds them
        return jmodel.loss_on_batch(p, jax.random.PRNGKey(0), xx, {}, sigma=s, noise=e,
                                    deterministic=True)

    (want, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, jnp.asarray(images), jnp.asarray(sigma), jnp.asarray(noise))
    net = pmodel.score_network()
    net.zero_grad()
    got, metrics = pmodel.loss_on_batch(torch.from_numpy(images), {},
                                        sigma=torch.from_numpy(sigma),
                                        noise=torch.from_numpy(noise), deterministic=True)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(metrics["loss_per_example"].numpy(),
                               np.asarray(jmetrics["loss_per_example"]), rtol=1e-5)
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jgrads["params"]).items()}
    want_grads = flax_to_state_dict(flat, net)
    grads = {k: p.grad for k, p in net.named_parameters()}
    floor = 1e-3 * max(g.abs().max().item() for g in want_grads.values())
    for name, g in grads.items():
        w = want_grads[name]
        err = (g - w).abs().max().item()
        assert err <= max(1e-3 * w.abs().max().item(), floor), (name, err)


def test_fourier_frequencies_stay_out_of_the_optimizer(built):
    """NCSN++'s Fourier frequencies (a stop_gradient param in JAX) are a
    buffer: they load from the flax tree, are no parameter of the default
    optimizer and are unchanged by a training step, as JAX's Adam without
    weight decay leaves them (zero gradient, zero update)."""
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    _, params, pmodel = _build(_config("ncsn"))
    net = pmodel.score_network()
    freqs = net.model.map_noise.freqs
    np.testing.assert_array_equal(freqs.numpy(),
                                  np.asarray(params["params"]["map_noise"]["freqs"]))
    assert all(p is not freqs for p in net.parameters())
    before = freqs.clone()
    state = create_train_state(pmodel, default_optimizer().build(net.parameters()), seed=1)
    make_train_step(pmodel)(state, {"images": torch.rand(2, 16, 16, 1)})
    torch.testing.assert_close(net.model.map_noise.freqs, before, rtol=0, atol=0)


def _jax_step_noise(rng, n, shape):
    """The per-step draws of the JAX EDM samplers' scan for `sample(rng)`."""
    key, _ = jax.random.split(rng)
    draws = []
    for _ in range(n):
        key, nk = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(nk, shape, dtype=jnp.float32)))
    return np.stack(draws)


def _trajectory(built, precond, sampler_kw=None, generalized=False):
    """4 steps of the config's (or the given) sampler at batch 2 over the
    small backbone with the same latents and per-step draws: (jax x0, port
    x0) in model space before the final clip to [0, 1], and the port's
    samples from `sample()`.

    JAX's loop is built and jitted here from the sampler itself, not taken
    through `GaussianDiffusion_EDM.sample`: that caches its jitted loop by
    `(num_samples, id(sampler))`, so a sampler made after an earlier one was
    freed can take the freed one's id and run its stale loop (the heun VE
    case ran the euler VE loop in some processes, one sample value then
    landing on the other side of the clip; ROADMAP queue 3). The clipped
    samples saturate (the VE cases' x0 reach about 500), so the unclipped
    x0 are what is compared."""
    from xdiffusion_tpu.samplers import edm as jax_edm

    from xdiffusion_tpu_torch.samplers import edm as port_edm

    jmodel, params, pmodel = built("small", precond)
    jsampler, psampler = jmodel._sampler, pmodel._sampler
    if sampler_kw is not None:
        cls = "GeneralizedStochasticSampler" if generalized else "StochasticSampler"
        jsampler = getattr(jax_edm, cls)(**sampler_kw)
        psampler = getattr(port_edm, cls)(**sampler_kw)
    shape = (2, 8, 8, 1)
    latents = _x(shape, seed=4)
    rng = jax.random.PRNGKey(5)
    loop = jax.jit(jsampler.build_sample_loop(jmodel, shape))
    want = loop(params, jax.random.split(rng)[0], jnp.asarray(latents), None)
    noise = torch.from_numpy(_jax_step_noise(rng, (sampler_kw or {}).get("num_steps", 4), shape))
    samples = pmodel.sample(num_samples=2, sampler=psampler,
                            initial_noise=torch.from_numpy(latents),
                            context={"sampling_noise": noise})
    net = pmodel.score_network().eval()
    with torch.inference_mode():
        got = psampler.run(net, lambda x, sigma: net(x, sigma, class_labels=None),
                           torch.from_numpy(latents), lambda i: noise[i])
    return np.asarray(want), got.numpy(), samples.numpy()


def _check_trajectory(want, got, samples):
    """x0 to 5e-5 of its largest magnitude (fp32 through sigmas up to 100;
    9e-6 of it seen), and `sample()` the clip of the port's x0 exactly."""
    assert got.shape == want.shape == samples.shape == (2, 8, 8, 1)
    np.testing.assert_allclose(got, want, atol=5e-5 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(samples, np.clip((got + 1.0) * 0.5, 0.0, 1.0))


def test_stochastic_sampler_matches_jax(built):
    """EDM Algorithm 2 (Heun, 4 steps) and with churn (S_churn 40: the draws
    enter), on the same latents and per-step draws: `_check_trajectory`."""
    for kw in (None, dict(num_steps=4, S_churn=40.0, S_min=0.05, S_max=50.0)):
        _check_trajectory(*_trajectory(built, "EDMPrecond", kw))


@pytest.mark.parametrize("solver,disc,schedule,scaling,precond", [
    ("euler", "vp", "vp", "vp", "VPPrecond"), ("heun", "vp", "vp", "vp", "VPPrecond"),
    ("euler", "ve", "ve", "none", "VEPrecond"), ("heun", "ve", "ve", "none", "VEPrecond"),
    ("euler", "iddpm", "linear", "none", "iDDPMPrecond"),
    ("heun", "iddpm", "linear", "none", "iDDPMPrecond"),
    ("euler", "edm", "linear", "none", "EDMPrecond"),
    ("heun", "edm", "linear", "none", "EDMPrecond")])
def test_generalized_sampler_matches_jax(built, solver, disc, schedule, scaling, precond):
    """Every solver and discretisation (with its schedule, scaling and
    preconditioner), 4 steps with churn and injected draws:
    `_check_trajectory`."""
    kw = dict(num_steps=4, solver=solver, discretization=disc, schedule=schedule,
              scaling=scaling, S_churn=10.0, alpha=1.0 if solver == "euler" else 0.8)
    _check_trajectory(*_trajectory(built, precond, kw, generalized=True))


def _reference_state_dict(module, seed, song_head):
    """A seeded state dict in the reference's layout for the port backbone
    `module`: keys enc.16x16_block0.norm0.weight, ...; the qkv and proj 1x1
    convs (3C, C, 1, 1) and (C, C, 1, 1); a SongUNet's head at
    dec.{R}x{R}_aux_{norm,conv}."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, value in module.state_dict().items():
        parts = name.split(".")
        top, leaf = parts[0], parts[-1]
        shape = tuple(value.shape)
        if top in ("out_norm", "out_conv") and song_head:
            r = BACKBONES["song"][1]["img_resolution"]
            top = f"dec.{r}x{r}_aux_{top[4:]}"
        elif top.startswith(("enc_", "dec_")):
            top = top.replace("_", ".", 1)
        mid = [p for p in parts[1:-1] if not (p == "conv" and "aux_residual" in top)]
        if mid and mid[-1] in ("qkv", "proj") and leaf == "weight":
            shape = shape + (1, 1)
        if leaf == "scale":
            leaf = "weight"
        sd[".".join([top, *mid, leaf])] = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    return sd


@pytest.mark.parametrize("arch,backbone", [("song", "ncsn"), ("adm", "adm")])
def test_importer_matches_jax(arch, backbone):
    """A seeded reference-layout state dict through the JAX importer and the
    port's gives the same forward (1e-4 of its scale): the renames, the
    Fourier frequencies and the (head, channel, part) qkv de-interleave
    agree."""
    from xdiffusion_tpu.importers.edm import import_edm_unet_params as jax_import
    from xdiffusion_tpu.score_networks import edm as jax_edm

    from xdiffusion_tpu_torch.importers.edm import import_edm_unet_params
    from xdiffusion_tpu_torch.score_networks import edm as port_edm

    cls, params = BACKBONES[backbone]
    jnet = getattr(jax_edm, cls)(**params)
    x = _x((2, 16, 16, 1), seed=8)
    labels = np.array([0.3, -0.8], dtype=np.float32)
    # The importer (strict) fills every leaf from the state dict: the tree's
    # shapes are enough, so trace the init and compile nothing.
    init = jax.tree_util.tree_map(
        lambda leaf: jnp.zeros(leaf.shape, leaf.dtype),
        jax.eval_shape(jnet.init, jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(labels)))
    pnet = getattr(port_edm, cls)(**params)
    sd = _reference_state_dict(pnet, seed=9, song_head=arch == "song")
    imported = jax_import(init, sd, arch=arch)
    want = jax.jit(jnet.apply)(imported, jnp.asarray(x), jnp.asarray(labels))
    import_edm_unet_params(pnet, sd, arch=arch)
    with torch.inference_mode():
        got = pnet(torch.from_numpy(x), torch.from_numpy(labels))
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("name", EDM_CONFIGS)
def test_edm_config_builds_at_full_width(name):
    """Every EDM config as shipped builds on the CPU (build_model): the
    process, its preconditioner, backbone and sampler."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.edm import GaussianDiffusion_EDM
    from xdiffusion_tpu_torch.training.image.train import build_model

    model = build_model(load_yaml(os.path.join(CONFIG_DIR, name)), device="cpu")
    assert isinstance(model, GaussianDiffusion_EDM)
    net = model.score_network()
    expected = {"edm.yaml": "EDMPrecond", "edm_adm.yaml": "VPPrecond",
                "edm_ddpmpp.yaml": "VPPrecond", "edm_ncsnpp.yaml": "VEPrecond"}[name]
    assert type(net).__name__ == expected
    assert type(net.model).__name__ == ("DhariwalUNet" if "adm" in name else "SongUNet")
    if type(net.model).__name__ == "SongUNet":
        heads = {m.num_heads for m in net.modules() if getattr(m, "attention", False)}
        assert heads == {1}  # one head of 256 channels


def _tiny_yaml(tmp_path):
    cfg = _config("small")
    cfg["diffusion"]["sampling"]["params"] = {"num_steps": 3}
    path = tmp_path / "edm_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_edm_through_the_training_and_sampling_clis(tmp_path, monkeypatch):
    """A tiny EDM config through `python -m xdiffusion_tpu_torch.train` (2
    steps, metrics, checkpoint, a 3-step grid; a resume continues at step
    2) and `...sample` (its checkpoint), --device cpu."""
    import json

    from test_torch_port_train import _mnist_dir

    from xdiffusion_tpu_torch import sample as sample_cli
    from xdiffusion_tpu_torch import train as train_cli

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", _mnist_dir(tmp_path))
    config = _tiny_yaml(tmp_path)
    args = ["--config_path", config, "--batch_size", "4", "--output_path",
            str(tmp_path / "out"), "--save_and_sample_every_n", "2", "--num_samples", "4",
            "--device", "cpu"]
    out = train_cli.main(args + ["--num_training_steps", "2"])
    assert os.path.isfile(os.path.join(out, "checkpoints", "2.pt"))
    assert os.path.getsize(os.path.join(out, "sample-2.png")) > 0
    train_cli.main(args + ["--num_training_steps", "3", "--resume_from", out])
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    samples = sample_cli.main(["--config_path", config, "--checkpoint",
                               os.path.join(out, "checkpoints", "2.pt"), "--num_samples", "3",
                               "--output_path", str(tmp_path / "samples"), "--device", "cpu"])
    assert samples.shape == (3, 8, 8, 1) and bool(torch.isfinite(samples).all())
    assert os.path.getsize(tmp_path / "samples" / "sample-step2.png") > 0
