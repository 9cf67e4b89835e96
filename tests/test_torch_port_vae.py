"""The KL image VAE, the posterior, the VAE-GAN losses and the image
autoencoder trainer of the port against the JAX package on the CPU.

Tiny configs (the JAX tests' 16x16 KL VAE, with attention at the 8x8 level
beside the mid block's, so K1's plain version runs at both) carry one set of
seeded weights into both packages (every parameter drawn, the zero-init
attention projection too, so that attention reaches the output), and the
posterior's draws are JAX's own, rebuilt from its keys and injected. Stated
tolerances: fp32 outputs, moments and losses within 1e-5 of the reference's
largest magnitude; each gradient leaf within 1e-4 of its own (`check_grads`
says where that is floored, and why). Also: the
perceptual distance on the trained filter bank (the port's copy of the asset
is byte-equal) and on the seeded random pyramid, the Haar wavelet loss at odd
extents, hinge and vanilla losses, one VAE-GAN step against JAX's
`make_vae_train_step`, every shipped VAE config built at full width with the
JAX package's parameter counts, and the image autoencoder CLI with a
bit-exact resume and the reconstruct CLI. The objective of the whole
autoencoder in both phases, with every gradient leaf, is held on the video
VAEs (tests/test_torch_port_causal_vae.py); here the loss module alone
takes its variants."""

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

from xdiffusion_tpu_torch.weights import flax_to_state_dict, load_flax_params, random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_CONFIGS = ["configs/video/moving_mnist/ltx_video/autoencoder.yaml",
               "configs/video/moving_mnist/hunyuan_video/autoencoder.yaml",
               "configs/video/moving_mnist/open_sora/vae_hunyuan.yaml",
               "configs/audio/urbansound8k/vae.yaml",
               "configs/audio/urbansound8k/autoencoder/urbansound8k_4x16x32.yaml"]


@pytest.fixture
def built_once(monkeypatch):
    """The trainers and the reconstruct CLI build each (dataset, split, image
    size) once in the test: the synthetic stand-ins are generated anew on
    every load otherwise (the same data each time)."""
    from xdiffusion_tpu_torch import datasets
    from xdiffusion_tpu_torch.datasets import utils
    from xdiffusion_tpu_torch.training.image import autoencoder as image_vae
    from xdiffusion_tpu_torch.training.image import train as image_train
    from xdiffusion_tpu_torch.training.video import autoencoder as video_vae
    from xdiffusion_tpu_torch.training.video import train as video_train

    built = {}

    def load(name, config=None, split="train"):
        size = config.data.image_size if config is not None and "data" in config else None
        key = (name, split, str(size))
        if key not in built:
            built[key] = utils.load_dataset(name, config=config, split=split)
        return built[key]

    for module in (datasets, image_vae, image_train, video_vae, video_train):
        monkeypatch.setattr(module, "load_dataset", load)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def tiny_kl_config(adaptive: bool = True, perceptual: float = 0.5,
                   attn_resolutions=(8,)) -> dict:
    """The JAX tests' 16x16 KL VAE, with attention at 8x8 besides the mid
    block's, and a loss with the perceptual term and the adaptive weight."""
    return {"target": "xdiffusion.autoencoders.kl.AutoencoderKL", "params": {
        "encoder_decoder_config": {
            "double_z": True, "z_channels": 4, "resolution": 16, "in_channels": 1, "out_ch": 1,
            "ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
            "attn_resolutions": list(attn_resolutions), "dropout": 0.0},
        "embed_dim": 4,
        "loss_config": {"target": "xdiffusion.autoencoders.losses.LPIPSWithDiscriminator",
                        "params": {"disc_start": 0, "kl_weight": 1.0e-6, "disc_weight": 0.5,
                                   "disc_in_channels": 1, "disc_num_layers": 2,
                                   "perceptual_weight": perceptual,
                                   "use_adaptive_adversarial_weight": adaptive}}}}


def build_pair(cfg: dict, seed: int = 3):
    """(JAX VAE, its params {"ae", "disc"}, port VAE on the CPU, the drawn
    flat weights): one seeded draw of every parameter, carried into both."""
    from xdiffusion_tpu.config import instantiate_from_config as jax_instantiate

    from xdiffusion_tpu_torch.config import instantiate_from_config

    jvae = jax_instantiate(copy.deepcopy(cfg), use_config_struct=True)
    vae = instantiate_from_config(copy.deepcopy(cfg), use_config_struct=True, device="cpu")
    shapes = jax.eval_shape(jvae.init_params, jax.random.PRNGKey(0))
    flat = {f"{g}/" + "/".join(k): np.zeros(v.shape, np.float32)
            for g, tree in shapes.items()
            for k, v in traverse_util.flatten_dict(tree["params"]).items()}
    drawn = random_flax_params(flat, seed)
    params = {g: {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(v) for k, v in drawn.items()
         if k.startswith(g + "/")})} for g in shapes}
    load_flax_params(vae, drawn)
    return jvae, params, vae, drawn


def grads_as_port(vae, drawn, group: str, jax_grads) -> dict:
    """JAX gradients of one group as the port's {name: tensor} (the other
    group's entries zero-filled for the mapping, then dropped)."""
    flat = {k: np.zeros_like(v) for k, v in drawn.items()}
    flat.update({f"{group}/" + "/".join(k): np.asarray(v)
                 for k, v in traverse_util.flatten_dict(jax_grads["params"]).items()})
    return {k: v for k, v in flax_to_state_dict(flat, vae).items()
            if k.startswith(group + ".")}


def check_grads(vae, want: dict, tol: float = 1e-4) -> None:
    """Each leaf within `tol` of its own largest magnitude, floored at 1e-2 of
    the group's largest gradient: some leaves' exact gradients are 0 (a bias
    that the next one-channel-a-group GroupNorm subtracts again, attention's
    key bias, which the softmax ignores), and both sides hold rounding noise
    there, 1e-8 to 1.2e-7 of the group's largest (more on larger maps: the
    Hunyuan encoder's)."""
    got = {name: p.grad for name, p in vae.named_parameters() if name in want}
    assert set(got) == set(want)
    floor = 1e-2 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        g = torch.zeros_like(w) if g is None else g
        err = float((g - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), floor), (name, err)


def jax_objective(jvae, params, rng, x, step: int = 0):
    """JAX's training_losses of both phases in one jitted program (the two
    phases share the autoencoder's forward), each with the gradient in its
    phase's group: [(loss, logs, grads) of phase 0, of phase 1]. The arrays
    are the program's arguments: closed over, they would be constants, and
    XLA would spend its compile time folding the network over them."""

    def both(params, x, rng):
        def phase(idx, group):
            def fn(p):
                return jvae.training_losses(dict(params, **{group: p}), rng, x,
                                            optimizer_idx=idx,
                                            global_step=jnp.asarray(step, jnp.int32))
            return jax.value_and_grad(fn, has_aux=True)(params[group])
        return phase(0, "ae"), phase(1, "disc")

    return [(loss, logs, grads) for (loss, logs), grads in jax.jit(both)(params, x, rng)]


def check_objective(jvae, params, vae, drawn, x, noise, rng, step: int = 0):
    """Both phases of the VAE-GAN objective: loss and logs within 1e-5 (the
    logits' means within 1e-5 absolute: they average O(1) logits of both
    signs to some 1e-2), each gradient leaf of the phase's group within
    1e-4."""
    for idx, (loss, logs, grads) in enumerate(jax_objective(jvae, params, rng,
                                                            jnp.asarray(x), step)):
        vae.zero_grad(set_to_none=True)
        got, got_logs = vae.training_losses(t(x), idx, step, noise=t(noise))
        got.backward()
        assert rel(got.item(), loss) <= 1e-5, (idx, got.item(), float(loss))
        assert set(got_logs) == set(logs)
        for k, v in logs.items():
            g = got_logs[k].detach().numpy()
            err = abs(float(g) - float(v)) if k.startswith("logits") else rel(g, v)
            assert err <= 1e-5, (idx, k, err)
        check_grads(vae, grads_as_port(vae, drawn, "ae" if idx == 0 else "disc", grads))


def test_perceptual_asset_is_the_jax_packages_byte_for_byte():
    names = ("xdiffusion_tpu", "xdiffusion_tpu_torch")
    blobs = [open(os.path.join(REPO, n, "autoencoders", "assets", "perceptual_filters.npz"),
                  "rb").read() for n in names]
    assert blobs[0] == blobs[1] and len(blobs[0]) > 100_000


def test_diagonal_gaussian_against_jax():
    from xdiffusion_tpu.autoencoders.distributions import DiagonalGaussianDistribution as JaxDG

    from xdiffusion_tpu_torch.autoencoders.distributions import (
        DiagonalGaussianDistribution,
        moments_to_distribution,
    )

    rng = np.random.default_rng(0)
    moments = rng.standard_normal((2, 3, 4, 6)).astype(np.float32) * 3
    moments[..., 3:][0, 0] = 40.0  # clipped to 20
    other = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    jd, d = JaxDG(jnp.asarray(moments)), DiagonalGaussianDistribution(t(moments))
    jo, o = JaxDG(jnp.asarray(other)), DiagonalGaussianDistribution(t(other))
    key = jax.random.PRNGKey(5)
    noise = jax.random.normal(key, (2, 3, 4, 3))
    assert rel(d.sample(t(noise)), jd.sample(key)) <= 1e-6
    assert rel(d.kl(), jd.kl()) <= 1e-5 and rel(d.kl(o), jd.kl(jo)) <= 1e-5
    sample = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)
    assert rel(d.nll(t(sample)), jd.nll(jnp.asarray(sample))) <= 1e-5
    assert np.array_equal(d.mode().numpy(), np.asarray(jd.mode()))
    det = DiagonalGaussianDistribution(t(moments), deterministic=True)
    assert not det.kl().any() and not det.nll(t(sample)).any()
    # One log-variance channel broadcasts over the latent channels.
    uniform = moments_to_distribution(t(moments[..., :4]), 3)
    want = np.clip(np.broadcast_to(moments[..., 3:4], (2, 3, 4, 3)), -30.0, 20.0)
    assert torch.equal(uniform.logvar, t(want))


def test_kl_vae_encode_decode_moments_against_jax():
    """The tiny KL VAE: moments, latents with JAX's posterior draw, decode;
    the attention sites (one head of 16 and 32 channels) take K1's plain
    version."""
    from xdiffusion_tpu.autoencoders.kl import _AutoencoderKLModule as JaxModule

    jvae, params, vae, _ = build_pair(tiny_kl_config())
    x = np.random.default_rng(1).uniform(size=(2, 16, 16, 1)).astype(np.float32)
    want = jax.jit(lambda p, xx: jvae.module.apply(p, xx, method=JaxModule.encode_moments))(
        params["ae"], jnp.asarray(x))
    got = vae.encode_moments(t(x)).detach()
    assert got.shape == (2, 8, 8, 8) and rel(got, want) <= 1e-5
    from xdiffusion_tpu.autoencoders.distributions import DiagonalGaussianDistribution as JaxDG

    key = jax.random.PRNGKey(2)
    z_want = JaxDG(want).sample(key)  # encode_to_latents' posterior of these moments
    z = vae.encode_to_latents(t(x), noise=t(jax.random.normal(key, (2, 8, 8, 4))))
    assert rel(z, z_want) <= 1e-5
    assert rel(vae.decode_from_latents(z).detach(),
               jax.jit(jvae.decode_from_latents)(params, z_want)) <= 1e-5


LOSS_VARIANTS = {
    "hinge_perceptual_adaptive": dict(perceptual_weight=0.5),
    "vanilla_l2_paired_gated": dict(disc_loss="vanilla", rec_loss="l2", kl_start=3,
                                    disc_start=3, use_reconstruction_gan=True,
                                    learned_logvar=False, use_nll=False),
}


@pytest.mark.parametrize("variant", list(LOSS_VARIANTS))
def test_lpips_objective_variants_against_jax(variant):
    """LPIPSWithDiscriminator alone, both phases, on given inputs,
    reconstructions and posterior moments at step 2: the hinge loss with the
    perceptual term at a given adaptive weight (0.7); the vanilla loss on L2
    before kl_start and disc_start, with the paired reconstruction GAN, the
    posterior's log-variance and no NLL. Loss and logs within 1e-5; the
    gradients in the reconstructions (what reaches the decoder) and in the
    loss module's parameters (the discriminator, the log-variance) within
    1e-4 (`check_grads`)."""
    from xdiffusion_tpu.autoencoders.distributions import DiagonalGaussianDistribution as JaxDG
    from xdiffusion_tpu.config import instantiate_from_config as jax_instantiate

    from xdiffusion_tpu_torch.autoencoders.distributions import DiagonalGaussianDistribution
    from xdiffusion_tpu_torch.config import instantiate_from_config

    cfg = {"target": "xdiffusion.autoencoders.losses.LPIPSWithDiscriminator",
           "params": {"disc_start": 0, "kl_weight": 1e-6, "disc_weight": 0.5,
                      "disc_in_channels": 1, "disc_num_layers": 2}}
    cfg["params"].update(LOSS_VARIANTS[variant])
    jloss, ploss = jax_instantiate(copy.deepcopy(cfg)), instantiate_from_config(copy.deepcopy(cfg))
    rng = np.random.default_rng(5)
    x, recon = (rng.uniform(size=(2, 16, 16, 1)).astype(np.float32) for _ in range(2))
    moments = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    step = jnp.asarray(2, jnp.int32)
    shapes = jax.eval_shape(lambda: jloss.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                               jnp.asarray(recon), JaxDG(jnp.asarray(moments)),
                                               1, step))
    drawn = random_flax_params({"/".join(k): np.zeros(v.shape, np.float32) for k, v in
                                traverse_util.flatten_dict(shapes["params"]).items()}, 13)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    load_flax_params(ploss, drawn)
    for idx in (0, 1):
        adaptive = 0.7 if idx == 0 and variant == "hinge_perceptual_adaptive" else None

        def fn(p, r, xx, m, idx=idx, adaptive=adaptive):
            return jloss.apply(p, xx, r, JaxDG(m), idx, step,
                               adaptive_weight=None if adaptive is None else jnp.asarray(adaptive))

        (loss, logs), (gp, gr) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(recon), jnp.asarray(x), jnp.asarray(moments))
        ploss.zero_grad(set_to_none=True)
        r = t(recon).requires_grad_()
        got, got_logs = ploss(t(x), r, DiagonalGaussianDistribution(t(moments)), idx, 2,
                              adaptive_weight=None if adaptive is None else torch.tensor(adaptive))
        got.backward()
        assert rel(got.item(), loss) <= 1e-5, (idx, got.item(), float(loss))
        assert set(got_logs) == set(logs)
        for k, v in logs.items():
            g = got_logs[k].detach().numpy()
            err = abs(float(g) - float(v)) if k.startswith("logits") else rel(g, v)
            assert err <= 1e-5, (idx, k, err)
        if idx == 0:
            assert rel(r.grad.numpy(), gr) <= 1e-4
        want = flax_to_state_dict({"/".join(k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(gp["params"]).items()}, ploss)
        check_grads(ploss, want)


def test_perceptual_and_wavelet_terms_against_jax(monkeypatch):
    from xdiffusion_tpu.autoencoders import perceptual as jp

    from xdiffusion_tpu_torch.autoencoders import losses, perceptual

    rng = np.random.default_rng(7)
    distance = jax.jit(jp.perceptual_distance)
    for shape in ((2, 16, 16, 1), (1, 2, 18, 20, 3)):  # an image; odd sizes of a video
        a, b = (rng.uniform(size=shape).astype(np.float32) for _ in range(2))
        want = distance(jnp.asarray(a), jnp.asarray(b))
        assert rel(perceptual.perceptual_distance(t(a), t(b)), want) <= 1e-5
    monkeypatch.setenv("XDIFFUSION_PERCEPTUAL", "random")
    # A shape of its own: jit's cache would return the trained bank's trace.
    a, b = (rng.uniform(size=(1, 16, 16, 1)).astype(np.float32) for _ in range(2))
    assert perceptual.load_trained_filters(3) is None
    assert rel(perceptual.perceptual_distance(t(a), t(b)),
               jax.jit(jp.perceptual_distance)(jnp.asarray(a), jnp.asarray(b))) <= 1e-5
    for shape in ((2, 5, 7, 9, 2), (1, 4, 6, 8, 1)):
        a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        assert rel(perceptual.haar_dwt3(t(a)), jp.haar_dwt3(jnp.asarray(a))) <= 1e-6
        assert rel(perceptual.wavelet_loss_3d(t(a), t(b)),
                   jp.wavelet_loss_3d(jnp.asarray(a), jnp.asarray(b))) <= 1e-6
    from xdiffusion_tpu.autoencoders import losses as jl

    real, fake = rng.standard_normal((2, 3, 4, 4, 1)).astype(np.float32)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        assert rel(getattr(losses, name)(t(real), t(fake)).item(),
                   getattr(jl, name)(jnp.asarray(real), jnp.asarray(fake))) <= 1e-6


def test_vae_gan_step_against_jax():
    """One step of the two-phase trainer on the tiny KL VAE at a fixed
    adversarial weight (the adaptive one: the video VAEs' objective tests;
    Adam lr 1e-3, betas (0.5, 0.9), as JAX's make_vae_train_step takes it;
    the trainers use 4.5e-6): the losses, and every parameter of both
    groups after the step. Adam's first
    step moves an element by lr * g / (|g| + eps), eps 1e-8, whose slope in g
    is lr * eps / g^2: where the element's gradient is at least 1e-3 the two
    steps agree within 1e-4 of lr, given the gradients' 1e-4 agreement;
    where it is smaller the step turns on the gradients' rounding (an
    element of 1e-6 moves by 0.995 lr on one side and 0.998 lr on the other,
    and a bias whose exact gradient is 0 by lr times the sign of its noise)
    and is held to 2 lr. The
    discriminator phase sees the updated AE (its loss would differ
    otherwise)."""
    import optax
    from xdiffusion_tpu.training.image.autoencoder import VAETrainState
    from xdiffusion_tpu.training.image.autoencoder import make_vae_train_step as jax_step

    from xdiffusion_tpu_torch.training.image.autoencoder import (
        create_vae_train_state,
        make_vae_train_step,
    )

    jvae, params, vae, _ = build_pair(
        tiny_kl_config(adaptive=False, perceptual=0.0, attn_resolutions=()), seed=5)
    x = np.random.default_rng(2).uniform(size=(4, 16, 16, 1)).astype(np.float32)
    tx = optax.adam(1e-3, b1=0.5, b2=0.9)
    jstate = VAETrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_ae=tx.init(params["ae"]), opt_disc=tx.init(params["disc"]))
    before = {k: v.detach().clone() for k, v in vae.state_dict().items()}
    rng = jax.random.PRNGKey(3)
    rng_ae, rng_d = jax.random.split(jax.random.fold_in(rng, 0))
    noise = {k: t(jax.random.normal(jax.random.split(r)[0], (4, 8, 8, 4)))
             for k, r in (("noise_ae", rng_ae), ("noise_disc", rng_d))}
    jstate, jmetrics = jax_step(jvae, tx, tx)(jstate, {"images": jnp.asarray(x)}, rng)
    state = create_vae_train_state(vae, learning_rate=1e-3)
    metrics = make_vae_train_step(vae)(state, dict(images=t(x), **noise))
    assert state.step == 1
    for k in ("loss_ae", "loss_disc", "kl_loss", "d_weight", "nll_loss"):
        assert rel(metrics[k].numpy(), jmetrics[k]) <= 1e-5, k
    flat = {f"{g}/" + "/".join(k): np.asarray(v) for g in ("ae", "disc")
            for k, v in traverse_util.flatten_dict(jstate.params[g]["params"]).items()}
    want = flax_to_state_dict(flat, vae)
    for name, p in vae.named_parameters():
        err = (p.detach() - want[name]).abs()
        grad = torch.zeros_like(p) if p.grad is None else p.grad.abs()
        assert float(err.max()) <= 2e-3 * (1.0 + 1e-6), name
        assert float(torch.where(grad >= 1e-3, err, 0.0).max()) <= 1e-4 * 1e-3, name
    assert torch.equal(vae.disc.logvar, before["disc.logvar"])  # never trained, as in JAX


@pytest.mark.parametrize("path", VAE_CONFIGS)
def test_shipped_vae_config_builds_with_jax_parameter_counts(path):
    """Each shipped VAE config builds at full width in the port on the CPU,
    every parameter fp32, with the JAX package's counts in both groups (its
    shapes from jax.eval_shape of init_params)."""
    from xdiffusion_tpu.config import instantiate_from_config as jax_instantiate
    from xdiffusion_tpu.config import load_yaml as jax_load

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.autoencoder import build_vae

    vae = build_vae(load_yaml(os.path.join(REPO, path)), "cpu")
    jvae = jax_instantiate(jax_load(os.path.join(REPO, path)).autoencoder.to_dict(),
                           use_config_struct=True)
    shapes = jax.eval_shape(jvae.init_params, jax.random.PRNGKey(0))
    for group in ("ae", "disc"):
        want = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes[group]))
        assert sum(p.numel() for p in getattr(vae, group).parameters()) == want, group
    assert all(p.dtype == torch.float32 for p in vae.parameters())


def test_urbansound_vae_runs_at_64x128():
    """urbansound8k_4x16x32.yaml at full width: a 64x128 log-mel encodes to
    (4, 16, 32) latents and decodes back; its mid attention is one head of
    256 channels over 512 tokens. The loss runs (it trains on UrbanSound8k's
    64x128 log-mels through `train_audio_autoencoder`:
    tests/test_torch_port_audio.py)."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.autoencoder import build_vae

    vae = build_vae(load_yaml(os.path.join(REPO, VAE_CONFIGS[-1])), "cpu")
    x = t(np.random.default_rng(0).uniform(size=(1, 64, 128, 1)))
    gen = torch.Generator().manual_seed(0)
    z = vae.encode_to_latents(x, generator=gen)
    assert z.shape == (1, 16, 32, 4)
    with torch.no_grad():
        recon = vae.decode_from_latents(z)
        loss, logs = vae.training_losses(x, 1, 0, generator=gen)
    assert recon.shape == x.shape and bool(torch.isfinite(recon).all())
    assert np.isfinite(loss.item()) and set(logs) == {"disc_loss", "logits_real", "logits_fake"}


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_image_autoencoder_cli_resume_and_reconstruct(tmp_path, monkeypatch, built_once):
    """The image VAE CLI on the synthetic MNIST at 16x16, batch 4: 3 steps
    with checkpoints at 2 and 3; a resume from 2 repeats step 2's losses bit
    for bit (both optimizers, the generator and the batch stream restored);
    the reconstruct CLI on the run."""
    from xdiffusion_tpu_torch import reconstruct, train_autoencoder

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    cfg = {"autoencoder": tiny_kl_config(), "data": {"image_size": 16, "num_channels": 1}}
    path = tmp_path / "kl_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    common = ["--config_path", str(path), "--batch_size", "4", "--device", "cpu",
              "--save_and_sample_every_n", "2", "--learning_rate", "1e-3"]
    run = train_autoencoder.main(common + ["--num_training_steps", "3",
                                           "--output_path", str(tmp_path / "run")])
    metrics = _metrics(run)
    assert sorted(metrics) == [0, 2]
    assert all(np.isfinite(m["loss_ae"]) and np.isfinite(m["loss_disc"]) for m in metrics.values())
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2.pt", "3.pt"]
    assert os.path.exists(os.path.join(run, "reconstruction-3.png"))
    resumed = train_autoencoder.main(common + [
        "--num_training_steps", "3", "--output_path", str(tmp_path / "resumed"),
        "--resume_from", os.path.join(run, "checkpoints", "2.pt")])
    assert _metrics(resumed)[2] == {**metrics[2], "time": _metrics(resumed)[2]["time"]}
    inputs, recon, mse = reconstruct.main([
        "--config_path", str(path), "--autoencoder_checkpoint", run, "--num_samples", "3",
        "--device", "cpu", "--output_path", str(tmp_path / "recon")])
    assert inputs.shape == recon.shape == (3, 16, 16, 1) and np.isfinite(mse)
    assert os.listdir(tmp_path / "recon") == ["reconstruction-step3.png"]


@pytest.mark.parametrize("b,s", [(64, 64), (64, 512), (3, 65), (2, 511)])
def test_bsc_plan_takes_one_head_of_256_at_the_vae_sites(b, s):
    """K1/K2's plan at the KL VAEs' mid-block attention (one head of 256
    over 64 tokens, vae.yaml, and 512, urbansound8k_4x16x32.yaml, at the
    image CLI's batch 64; ragged beside them): the wide variant in both
    dtypes and both directions, within the H100's shared memory."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            plan = fa.bsc_plan(b, s, s, 1, 256, dtype, backward=backward)
            assert plan.variant == "wide"
            assert all(launch.smem <= 232_448 for launch in plan.launches)
