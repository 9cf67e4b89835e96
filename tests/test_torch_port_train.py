"""The port's training path against the JAX package on the CPU: the loss and
its gradients on a tiny UNet, the optimizer and EMA against optax, the
checkpoint round trip, the data pipeline, and the training CLI.

The tiny UNet is the flagship's architecture cut down: 16x16 input,
num_features 32, multipliers [1, 2], attention at 8x8 (2 heads of 32), one
block per level. Both sides get the same seeded weights (flax tree -> port
through the bridge) and, where the loss draws, injected timesteps and noise.
"""

import functools
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
import yaml
from flax import traverse_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml")


def tiny_config(path, parameterization="epsilon", loss_type="l2", fast_sampling=False):
    """Writes the tiny flagship variant to `path`; `fast_sampling` swaps the
    1000-step linear schedule for a 10-step cosine one."""
    with open(FLAGSHIP) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["parameterization"] = parameterization
    diff["noise_scheduler"]["params"]["loss_type"] = loss_type
    if fast_sampling:
        diff["noise_scheduler"]["params"].update(num_scales=10, schedule_type="cosine")
    diff["sampling"]["output_spatial_size"] = 16
    sn = diff["score_network"]["params"]
    sn.update(num_features=32, channel_multipliers=[1, 2], num_resnet_blocks=1,
              input_spatial_size=16)
    sn["attention"]["attention_resolutions"] = [8]
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    sn["conditioning"]["context_transformer_layer"]["params"]["dim_head"] = 32
    cfg["data"]["image_size"] = 16
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _build(path, seed=7):
    """(jax model, flax params, port model, flat drawn weights)."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    jmodel = JaxDDPM(jax_load_yaml(path))
    x, context = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, context)
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(shapes["params"]).items()}
    drawn = random_flax_params(flat, seed=seed)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    pmodel = GaussianDiffusion_DDPM(load_yaml(path), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, params, pmodel


# The UNet configs beside the flagship that the port runs (v target, cosine
# schedule; an 8x8 UNet; rectified flow), cut to num_features 32.
UNET_CONFIGS = ["ddpm_32x32_v_discrete.yaml", "ddpm_8x8_epsilon.yaml",
                "rectified_flow_32x32.yaml"]


def narrow_config(name, path):
    """configs/image/mnist/<name> at num_features 32, written to `path`."""
    with open(os.path.join(REPO, "configs/image/mnist", name)) as f:
        cfg = yaml.safe_load(f)
    sn = cfg["diffusion"]["score_network"]["params"]
    sn["num_features"] = 32
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _batch(seed, n=4, size=16):
    rng = np.random.default_rng(seed)
    images = rng.random((n, size, size, 1)).astype(np.float32)
    t = rng.integers(0, 1000, size=n).astype(np.int32)
    noise = rng.standard_normal((n, size, size, 1)).astype(np.float32)
    return images, t, noise


def test_tiny_unet_loss_and_every_gradient_match_jax(tmp_path):
    """loss_on_batch and the gradient of every parameter against
    jax.value_and_grad of the JAX package's loss_on_batch, with dropout off
    (deterministic=True) and injected timesteps and noise. Every parameter
    gets a gradient. Tolerances, fp32: the loss to 1e-5 relative; each
    gradient to 1e-4 of its own largest magnitude (sums over 16x16 maps and
    the batch in other orders, through every layer of the network; 4e-6 was
    seen), that magnitude floored at 1e-3 of the network's largest gradient:
    a bias just ahead of a GroupNorm whose groups hold one channel has a true
    gradient of 0, and both sides return rounding noise for it."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    jmodel, params, pmodel = _build(tiny_config(tmp_path / "tiny.yaml"))
    images, t, noise = _batch(0)

    def jax_loss(p):
        return jmodel.loss_on_batch(p, jax.random.PRNGKey(1), jnp.asarray(images), {},
                                    timesteps=jnp.asarray(t), noise=jnp.asarray(noise),
                                    deterministic=True)

    (want_loss, want_metrics), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    net = pmodel.score_network()
    loss, metrics = pmodel.loss_on_batch(
        torch.from_numpy(images), {}, timesteps=torch.from_numpy(t).long(),
        noise=torch.from_numpy(noise), deterministic=True)
    loss.backward()
    assert not net.training
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss_per_example"].numpy(),
                               np.asarray(want_metrics["loss_per_example"]), rtol=1e-5)
    assert set(metrics) == set(want_metrics)

    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(grads["params"]).items()}
    want = {k: v.numpy() for k, v in flax_to_state_dict(flat, net).items()}
    named = dict(net.named_parameters())
    assert set(named) == set(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, p in named.items():
        assert p.grad is not None, f"{name} received no gradient"
        scale = max(np.abs(want[name]).max(), floor)
        err = np.abs(p.grad.numpy() - want[name]).max() / scale
        assert err <= 1e-4, f"{name}: max|dg|/max|g| = {err:.2e}"


@pytest.mark.parametrize("loss_type", ["l2", "l1", "huber"])
def test_scheduler_training_functions_match_jax(loss_type):
    """q_sample, the v target and each elementwise loss against the JAX
    package's scheduler, to 1e-6 (fp32)."""
    from xdiffusion_tpu.scheduler import DiscreteNoiseScheduler as JaxScheduler
    from xdiffusion_tpu.scheduler import elementwise_loss as jax_loss

    from xdiffusion_tpu_torch.scheduler import DiscreteNoiseScheduler, elementwise_loss

    images, t, noise = _batch(1)
    x0 = images * 2 - 1
    pred = np.random.default_rng(2).standard_normal(x0.shape).astype(np.float32) * 2
    js, ps = JaxScheduler.create(num_scales=1000), DiscreteNoiseScheduler.create(num_scales=1000)
    tt = torch.from_numpy(t).long()
    for got, want in (
        (ps.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise)),
         js.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))),
        (ps.predict_v_from_x_and_epsilon(torch.from_numpy(x0), torch.from_numpy(noise), tt),
         js.predict_v_from_x_and_epsilon(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))),
        (elementwise_loss(loss_type, torch.from_numpy(pred), torch.from_numpy(noise)),
         jax_loss(loss_type, jnp.asarray(pred), jnp.asarray(noise))),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    times, weights = ps.sample_random_times(64, torch.Generator().manual_seed(0))
    assert times.dtype == torch.int64 and 0 <= times.min() and times.max() < 1000
    assert torch.equal(weights, torch.ones(64))


@pytest.mark.parametrize("parameterization", ["v", "rectified_flow"])
def test_loss_targets(tmp_path, parameterization, monkeypatch):
    """The v and rectified-flow targets of loss_on_batch, with the network's
    prediction pinned to zero: the loss is the target's mean square."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    model = GaussianDiffusion_DDPM(load_yaml(tiny_config(tmp_path / "t.yaml",
                                                         parameterization)), device="cpu")
    monkeypatch.setattr(model, "predict_score", lambda x, context: torch.zeros_like(x))
    images, t, noise = (torch.from_numpy(a) for a in _batch(3))
    t = t.long()
    loss, _ = model.loss_on_batch(images, {}, timesteps=t, noise=noise, deterministic=True)
    x0 = images * 2 - 1
    target = (model.noise_scheduler().predict_v_from_x_and_epsilon(x0, noise, t)
              if parameterization == "v" else x0 - noise)
    torch.testing.assert_close(loss, (target ** 2).mean(), atol=1e-6, rtol=1e-6)


def test_loss_draws_from_the_generator_and_drops_in_training(tmp_path):
    """Without injected timesteps and noise the loss draws them from the
    generator: the same seed gives the same loss, another seed another one.
    In training mode dropout changes the loss; deterministic=True does not
    need a generator."""
    _, _, pmodel = _build(tiny_config(tmp_path / "tiny.yaml"))
    images = torch.from_numpy(_batch(2)[0])
    _, t, noise = _batch(2)
    t, noise = torch.from_numpy(t).long(), torch.from_numpy(noise)

    def loss(seed, **kw):
        with torch.no_grad():
            return pmodel.loss_on_batch(images, {}, generator=torch.Generator().manual_seed(seed),
                                        **kw)[0].item()

    assert loss(0) == loss(0) and loss(0) != loss(1)
    eval_loss = loss(0, timesteps=t, noise=noise, deterministic=True)
    assert loss(0, timesteps=t, noise=noise) != eval_loss
    assert pmodel.score_network().training
    with pytest.raises(ValueError, match="generator"):
        pmodel.loss_on_batch(images, {})


def _optax_tx(kind):
    from xdiffusion_tpu import optim as jopt

    if kind == "adam":
        return jopt.Adam().build()
    if kind == "adamw_linear":
        return jopt.AdamW(weight_decay=0.05).build(jopt.LinearLR(0.5, 1.0, 3))
    return jopt.Adam(lr=1e-3).build(jopt.ConstantLR(0.25, 2))


def _port_tx(kind, params):
    from xdiffusion_tpu_torch import optim as popt

    if kind == "adam":
        return popt.Adam().build(params)
    if kind == "adamw_linear":
        return popt.AdamW(weight_decay=0.05).build(params, popt.LinearLR(0.5, 1.0, 3))
    return popt.Adam(lr=1e-3).build(params, popt.ConstantLR(0.25, 2))


@pytest.mark.parametrize("kind", ["adam", "adamw_linear", "constant_lr"])
def test_optimizer_matches_optax_on_shared_gradients(kind):
    """The port's clip + Adam/AdamW + schedule against the JAX package's optax
    chain, fed the same gradients for 5 steps. Steps 1 and 3 have a global
    norm above the clip (1.0), the others below it. Held apart from the
    loss's gradients on purpose: Adam's early steps move each parameter by
    about lr * sign(g), so a gradient near zero whose sign differs between
    two summation orders would move it by 2 * lr. Tolerance: 1e-6 of the
    parameters' scale (fp32 rounding of the update); the norm to 1e-6
    relative."""
    import optax

    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (2.0 if i in (1, 3) else 0.05)).astype(np.float32)
              for k, s in shapes.items()} for i in range(5)]
    tx = _optax_tx(kind)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ptx = _port_tx(kind, list(tparams.values()))
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        want_norm = float(optax.global_norm(jg))
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = ptx.step()
        assert (want_norm > 1.0) == (i in (1, 3))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6, err_msg=f"step {i} {k}")


def test_ema_matches_update_ema():
    """update_ema against the JAX package's update_ema, 3 updates at rate
    0.9: the same fp32 products and sum, to 1e-7 relative."""
    from xdiffusion_tpu.layers.ema import update_ema as jax_update_ema

    from xdiffusion_tpu_torch.train_step import update_ema

    rng = np.random.default_rng(4)
    target, source = torch.nn.Linear(6, 3), torch.nn.Linear(6, 3)
    tree = {n: jnp.asarray(p.detach().numpy()) for n, p in target.named_parameters()}
    for _ in range(3):
        with torch.no_grad():
            for p in source.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        src = {n: jnp.asarray(p.detach().numpy()) for n, p in source.named_parameters()}
        tree = jax_update_ema(tree, src, 0.9)
        update_ema(target, source, 0.9)
    for n, p in target.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(tree[n]), rtol=1e-7,
                                   atol=1e-8)


def _train_state(path, seed):
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    torch.manual_seed(seed)
    config = load_yaml(path)
    config.to_dict()["training"] = {"ema_decay": 0.99}
    model = GaussianDiffusion_DDPM(config, device="cpu")
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), ema=True, seed=11)
    return state, make_train_step(model, ema_decay=0.99)


def test_checkpoint_resume_continues_bit_identically(tmp_path):
    """Two steps, a checkpoint, a third step; then a fresh state (other
    initial weights) restored from the checkpoint takes the third step: the
    loss, the parameters, the EMA and the optimizer state equal the
    uninterrupted run's bit for bit (the generator's state is restored, so
    timesteps, noise and dropout masks repeat). At most 3 checkpoints stay."""
    from xdiffusion_tpu_torch import checkpoints

    path = tiny_config(tmp_path / "tiny.yaml")
    batches = [{"images": torch.from_numpy(_batch(10 + i)[0])} for i in range(3)]
    state, step = _train_state(path, seed=0)
    for b in batches[:2]:
        step(state, b)
    ckpt_dir = str(tmp_path / "run" / "checkpoints")
    checkpoints.save_checkpoint(ckpt_dir, state, state.step)
    want = step(state, batches[2])

    fresh, step2 = _train_state(path, seed=1)
    fresh, at = checkpoints.restore_checkpoint(str(tmp_path / "run"), fresh)
    assert at == 2 and fresh.step == 2
    got = step2(fresh, batches[2])
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    for a, b in zip(fresh.model.score_network().parameters(),
                    state.model.score_network().parameters()):
        assert torch.equal(a, b)
    for a, b in zip(fresh.ema.parameters(), state.ema.parameters()):
        assert torch.equal(a, b)
    assert fresh.optimizer.count == state.optimizer.count == 3

    for s in (3, 4, 5):
        checkpoints.save_checkpoint(ckpt_dir, state, s)
    assert sorted(os.listdir(ckpt_dir)) == ["3.pt", "4.pt", "5.pt"]
    assert checkpoints.latest_step(str(tmp_path / "run")) == 5


class _Store:
    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)


def test_synthetic_digits_and_batches_equal_jax():
    """`generate_digits` and the first three batches of `batch_iterator`
    equal the JAX package's exactly (images as float32 bits, labels)."""
    from xdiffusion_tpu.datasets.synthetic import generate_digits as jax_digits
    from xdiffusion_tpu.datasets.utils import batch_iterator as jax_batches

    from xdiffusion_tpu_torch.datasets.synthetic import generate_digits
    from xdiffusion_tpu_torch.datasets.utils import batch_iterator

    for n, seed, size in ((400, 0, 28), (64, 1, 12)):
        want, got = jax_digits(n, seed=seed, image_size=size), generate_digits(n, seed, size)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    images, labels = generate_digits(300, seed=3)
    jit, pit = jax_batches(_Store(images, labels), 128, seed=5), batch_iterator(
        _Store(images, labels), 128, seed=5)
    for _ in range(3):
        want, got = next(jit), next(pit)
        np.testing.assert_array_equal(got["images"], want["images"])
        np.testing.assert_array_equal(got["classes"], want["classes"])
    # skip=2 continues the same stream at its third batch (epochs of 2 here).
    skipped = batch_iterator(_Store(images, labels), 128, seed=5, skip=2)
    np.testing.assert_array_equal(next(skipped)["images"], want["images"])


def _write_idx(path, array):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, array.ndim))
        f.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        f.write(array.astype(np.uint8).tobytes())


def _mnist_dir(tmp_path, n=64):
    """A tiny MNIST in IDX form under <tmp>/data/mnist; returns <tmp>/data."""
    rng = np.random.default_rng(6)
    root = tmp_path / "data"
    (root / "mnist").mkdir(parents=True)
    _write_idx(root / "mnist" / "train-images-idx3-ubyte",
               rng.integers(0, 256, size=(n, 28, 28)))
    _write_idx(root / "mnist" / "train-labels-idx1-ubyte", rng.integers(0, 10, size=n))
    return str(root)


def test_mnist_idx_reader_and_resize_equal_jax(tmp_path, monkeypatch):
    """With IDX archives under XDIFFUSION_DATA_DIR both packages read them
    and resize 28 -> 32 to the same uint8 images."""
    from xdiffusion_tpu.datasets.mnist import MNIST as JaxMNIST

    from xdiffusion_tpu_torch.datasets.mnist import MNIST

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", _mnist_dir(tmp_path))
    want, got = JaxMNIST(image_size=32), MNIST(image_size=32)
    assert not got.synthetic and got.images.shape == (64, 32, 32, 1)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_train_cli_on_cpu_writes_metrics_checkpoint_and_grid(tmp_path, monkeypatch):
    """`python -m xdiffusion_tpu_torch.train --device cpu`: 2 steps of the tiny
    config write metrics.jsonl, checkpoints/2.pt and sample-2.png; a resumed
    run continues at step 2. Without --device and without a card it raises.
    `--use_lora_training` over that run's checkpoint trains and writes
    lora_weights.pkl (it raised NotImplementedError until LoRA was ported)."""
    from PIL import Image

    from xdiffusion_tpu_torch import train as cli

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", _mnist_dir(tmp_path))
    config = tiny_config(tmp_path / "tiny.yaml", fast_sampling=True)
    args = ["--config_path", config, "--batch_size", "4", "--output_path",
            str(tmp_path / "out"), "--save_and_sample_every_n", "2", "--num_samples", "4"]
    out = cli.main(args + ["--num_training_steps", "2", "--device", "cpu"])
    assert out == str(tmp_path / "out" / "image_mnist" / "tiny")
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r[k]) for r in records for k in ("loss", "grad_norm"))
    assert os.listdir(os.path.join(out, "checkpoints")) == ["2.pt"]
    assert np.asarray(Image.open(os.path.join(out, "sample-2.png"))).shape == (32, 32)

    cli.main(args + ["--num_training_steps", "3", "--device", "cpu", "--resume_from", out])
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [0, 1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args + ["--num_training_steps", "1"])
    lora = cli.main(args + ["--num_training_steps", "1", "--device", "cpu",
                            "--use_lora_training", "--load_model_weights_from_checkpoint", out,
                            "--output_path", str(tmp_path / "lora")])
    assert {"lora_weights.pkl", "sample-1.png"} <= set(os.listdir(lora))


@pytest.mark.parametrize("name", UNET_CONFIGS)
def test_unet_config_loss_matches_jax(tmp_path, name):
    """loss_on_batch of each UNet config (num_features 32, fp32, seeded flax
    weights through the bridge) against the JAX package's, with injected
    times (integer steps, or rectified flow's times in (0, 1]) and noise and
    dropout off: the loss and each example's loss to 1e-5 relative."""
    jmodel, params, pmodel = _build(narrow_config(name, tmp_path / name))
    size = pmodel.config().diffusion.score_network.params.input_spatial_size
    images, t, noise = _batch(3, size=size)
    if pmodel.config().diffusion.parameterization == "rectified_flow":
        t = np.random.default_rng(4).uniform(1e-3, 1.0, size=t.shape).astype(np.float32)
    want_loss, want_metrics = jax.jit(functools.partial(jmodel.loss_on_batch, deterministic=True))(
        params, jax.random.PRNGKey(1), jnp.asarray(images), {}, timesteps=jnp.asarray(t),
        noise=jnp.asarray(noise))
    tt = torch.from_numpy(t)
    loss, metrics = pmodel.loss_on_batch(
        torch.from_numpy(images), {}, timesteps=tt if tt.is_floating_point() else tt.long(),
        noise=torch.from_numpy(noise), deterministic=True)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss_per_example"].detach().numpy(),
                               np.asarray(want_metrics["loss_per_example"]), rtol=1e-5)
