"""LoRA fine-tuning of the port against the JAX package on the CPU: the
adapted set and factor shapes, the merge through the weight bridge, one
train step with LoRA as the transform of the optimized parameters, a LoRA
file pickled by the JAX package in the port's sampling CLI, the JAX
trainer's failure on its documented recipe beside the port's run, and the
port's two train_lora CLIs end to end.

Networks: the tiny flagship UNet of test_torch_port_train.py (num_features
32, conv and attention kernels, fp32), the tiny DiT of
test_torch_port_dit.py (Dense kernels and a class-embedding table) and the
small SongUNet of test_torch_port_edm.py (an EDM preconditioner's backbone
under `flax_param_prefix`), each on seeded flax weights through the bridge.
"""

import functools
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
from test_torch_port_dit import build as build_dit
from test_torch_port_dit import tiny_config as dit_config
from test_torch_port_edm import _build as build_edm
from test_torch_port_edm import _config as edm_config
from test_torch_port_train import _batch, _build, tiny_config

# fp32 bound of a merged kernel: base + (down @ up), a rank-4 product summed
# in another order by XLA and by torch (6e-8 seen at magnitudes near 1).
MERGE_TOL = 1e-6


def _unet(tmp_path, fast_sampling=True):
    return _build(tiny_config(tmp_path / "tiny.yaml", fast_sampling=fast_sampling))


def _networks(kind, tmp_path):
    """(flax params {"params": tree}, the port's score network) of `kind`."""
    if kind == "unet":
        _, params, pmodel = _unet(tmp_path)
    elif kind == "dit":
        _, params, pmodel, _ = build_dit(dit_config())
    else:
        _, params, pmodel = build_edm(edm_config("small"))
    return params, pmodel.score_network()


def _random_up(jlora, seed=0):
    """The JAX LoRA tree with seeded nonzero `up` factors (init: zeros)."""
    rng = np.random.default_rng(seed)
    weights = {k: {"down": np.array(v["down"]),
                   "up": (0.1 * rng.standard_normal(v["up"].shape)).astype(np.float32)}
               for k, v in jlora["weights"].items()}
    return {"rank": jlora["rank"], "scale": jlora["scale"], "weights": weights}


def _bridged(params, net):
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(params["params"]).items()}
    return flax_to_state_dict(flat, net)


@pytest.mark.parametrize("kind", ["unet", "dit", "edm"])
def test_adapted_set_and_factor_shapes_match_jax(kind, tmp_path):
    """The port adapts exactly the kernels `inject_trainable_lora` adapts,
    under the same tuple paths, with factors of the same shapes; no norm
    scale and no embedding table (2-D `weight`s in torch) among them; the
    port's init is down N(0, 1) / r and up 0."""
    from xdiffusion_tpu import lora as jax_lora

    from xdiffusion_tpu_torch import lora

    params, net = _networks(kind, tmp_path)
    want = jax_lora.inject_trainable_lora(params, jax.random.PRNGKey(1), r=4)
    got = lora.inject_trainable_lora(net, torch.Generator().manual_seed(0), r=4)
    assert len(got.paths) == len(want["weights"]) > 0
    assert set(got.paths) == set(want["weights"])
    for path, down, up in zip(got.paths, got.down, got.up):
        assert tuple(down.shape) == want["weights"][path]["down"].shape
        assert tuple(up.shape) == want["weights"][path]["up"].shape
        assert not up.any()
    owners = {n.rpartition(".")[0] for n in got.names}
    for name, module in net.named_modules():
        if isinstance(module, torch.nn.Embedding):
            assert name not in owners
    assert all(n.rpartition(".")[2] in ("weight", "kernel") for n in got.names)
    down = torch.cat([d.flatten() for d in got.down])
    assert abs(down.std().item() * 4 - 1.0) < 0.05
    assert lora.lora_param_count(got) == jax_lora.lora_param_count(want)


@pytest.mark.parametrize("kind", ["unet", "dit", "edm"])
def test_merge_matches_jax_merge_lora_through_the_bridge(kind, tmp_path):
    """The same factors (nonzero `up`) carried into the port
    (`weights.lora_from_tree`) and merged: every parameter equals the
    bridge's transform of JAX's `merge_lora` within MERGE_TOL of its scale
    (Dense kernels transposed, conv kernels OIHW, K4's HWIO kept), and the
    attached network's parameters read the same merged values."""
    from xdiffusion_tpu import lora as jax_lora

    from xdiffusion_tpu_torch import lora
    from xdiffusion_tpu_torch.weights import lora_from_tree

    params, net = _networks(kind, tmp_path)
    tree = _random_up(jax_lora.inject_trainable_lora(params, jax.random.PRNGKey(1), r=4))
    want = _bridged(jax_lora.merge_lora(params, tree), net)
    factors = lora_from_tree(tree, net)
    attached = {}
    lora.attach(net, factors)
    with torch.no_grad():
        for name in factors.names:
            owner, _, leaf = name.rpartition(".")
            attached[name] = getattr(net.get_submodule(owner), leaf).clone()
    lora.detach(net)
    lora.merge_lora(net, factors)
    got = net.state_dict()
    for name, w in want.items():
        tol = MERGE_TOL * max(1.0, w.abs().max().item())
        assert (got[name] - w).abs().max().item() <= tol, name
        if name in attached:
            torch.testing.assert_close(attached[name], got[name], rtol=0, atol=0)


def test_one_lora_train_step_matches_jax(tmp_path, monkeypatch):
    """One step of make_train_step with LoRA as the parameter transform
    against the JAX package's `make_train_step(param_transform=...)`, with
    injected timesteps and noise and dropout off, from the same base and
    factors (nonzero `up`): the loss and gradient norm to 1e-5 relative,
    each factor's gradient to 1e-4 of its largest magnitude (against
    jax.grad through `apply_lora`), each updated factor within the bound
    that the gradients' agreement puts on Adam's first update (see
    test_torch_port_dit.py's step test), and the base bit for bit
    unchanged."""
    from xdiffusion_tpu import lora as jax_lora
    from xdiffusion_tpu.optim import default_optimizer as jax_default_optimizer
    from xdiffusion_tpu.parallel.train_step import create_train_state as jax_state
    from xdiffusion_tpu.parallel.train_step import make_train_step as jax_step

    from xdiffusion_tpu_torch import lora
    from xdiffusion_tpu_torch.optim import DEFAULT_LR, default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.weights import lora_from_tree

    jmodel, params, pmodel = _unet(tmp_path, fast_sampling=False)
    net = pmodel.score_network()
    tree = _random_up(jax_lora.inject_trainable_lora(params, jax.random.PRNGKey(1), r=4))
    images, t, noise = _batch(5)
    monkeypatch.setattr(jmodel, "loss_on_batch", functools.partial(
        type(jmodel).loss_on_batch, jmodel, noise=jnp.asarray(noise), deterministic=True))
    monkeypatch.setattr(pmodel, "loss_on_batch", functools.partial(
        type(pmodel).loss_on_batch, pmodel, noise=torch.from_numpy(noise), deterministic=True))
    meta = {"rank": tree["rank"], "scale": tree["scale"]}

    def transform(weights):
        return jax_lora.apply_lora(params, {**meta, "weights": weights})

    weights = {k: {"down": jnp.asarray(v["down"]), "up": jnp.asarray(v["up"])}
               for k, v in tree["weights"].items()}

    def jax_loss(w):
        return jmodel.loss_on_batch(transform(w), jax.random.PRNGKey(2), jnp.asarray(images),
                                    {}, timesteps=jnp.asarray(t))[0]

    want_grads = jax.jit(jax.grad(jax_loss))(weights)
    tx = jax_default_optimizer().build()
    state = jax_state(weights, tx)
    state, want = jax_step(jmodel, tx, param_transform=transform)(
        state, {"images": jnp.asarray(images), "timesteps": jnp.asarray(t)},
        jax.random.PRNGKey(2))

    factors = lora_from_tree(tree, net)
    base = {k: v.clone() for k, v in net.state_dict().items()}
    lora.attach(net, factors)
    pstate = create_train_state(pmodel, default_optimizer().build(factors.parameters()),
                                lora=factors)
    step = make_train_step(pmodel, param_transform=factors)
    batch = {"images": torch.from_numpy(images), "timesteps": torch.from_numpy(t).long()}
    loss, _ = pmodel.loss_on_batch(batch["images"], {}, timesteps=batch["timesteps"])
    loss.backward()
    grads = {path: (d.grad.clone(), u.grad.clone())
             for path, d, u in zip(factors.paths, factors.down, factors.up)}
    got = step(pstate, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-5)
    updated = {path: (d.detach(), u.detach())
               for path, d, u in zip(factors.paths, factors.down, factors.up)}
    for path in factors.paths:
        for i, key in enumerate(("down", "up")):
            g, w = grads[path][i], torch.from_numpy(np.asarray(want_grads[path][key]))
            dg = 1e-4 * w.abs().max()
            assert (g - w).abs().max() <= dg, (path, key)
            bound = DEFAULT_LR * torch.clamp(
                dg * 1e-8 / (torch.clamp(w.abs() - dg, min=0) + 1e-8) ** 2, max=2.0)
            after = torch.from_numpy(np.asarray(state.params[path][key]))
            bound = bound + 1e-5 * DEFAULT_LR + 2.0 ** -22 * after.abs()
            assert bool(((updated[path][i] - after).abs() <= bound).all()), (path, key)
    lora.detach(net)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, base[k], rtol=0, atol=0)


def test_jax_lora_file_in_the_port_sampling_cli(tmp_path):
    """A lora_weights.pkl written by the JAX package's `save_lora_weights`
    loads in the port: merged into the bridged base it equals JAX's
    `merge_lora` within MERGE_TOL, and the port's sampling CLI with
    --lora_weights (base: the flax parameters as .npz) samples exactly what
    the merged network samples."""
    from xdiffusion_tpu import lora as jax_lora

    from xdiffusion_tpu_torch import lora
    from xdiffusion_tpu_torch import sample as cli

    config = tiny_config(tmp_path / "tiny.yaml", fast_sampling=True)
    _, params, pmodel = _build(config)
    net = pmodel.score_network()
    tree = _random_up(jax_lora.inject_trainable_lora(params, jax.random.PRNGKey(1), r=4))
    path = str(tmp_path / "lora_weights.pkl")
    jax_lora.save_lora_weights(tree, path)
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(params["params"]).items()}
    np.savez(tmp_path / "base.npz", **flat)
    want = _bridged(jax_lora.merge_lora(params, tree), net)
    lora.merge_lora(net, lora.load_lora_weights(path, net))
    for name, w in want.items():
        assert (net.state_dict()[name] - w).abs().max() <= MERGE_TOL * max(1.0, w.abs().max())

    got = cli.main(["--config_path", config, "--checkpoint", str(tmp_path / "base.npz"),
                    "--lora_weights", path, "--num_samples", "2", "--sampling_steps", "3",
                    "--output_path", str(tmp_path / "out"), "--device", "cpu"])
    merged = pmodel.sample(num_samples=2, num_sampling_steps=3,
                           generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, merged, rtol=0, atol=0)
    assert sorted(os.listdir(tmp_path / "out")) == ["sample-step0.png"]


def _jax_base_checkpoint(config, directory):
    """Seeded parameters of the tiny config's shapes (traced, not compiled)
    in a TrainState with the default optimizer, written by the JAX
    package's `checkpoints.save_checkpoint`; returns them flat."""
    from xdiffusion_tpu import checkpoints as jax_checkpoints
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.optim import default_optimizer as jax_default_optimizer
    from xdiffusion_tpu.parallel.train_step import create_train_state as jax_state
    from xdiffusion_tpu.training.image.train import build_model as jax_build_model

    from xdiffusion_tpu_torch.weights import random_flax_params

    jmodel = jax_build_model(jax_load_yaml(config))
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(3))
    flat = random_flax_params({"/".join(k): v for k, v in
                               traverse_util.flatten_dict(shapes["params"]).items()}, seed=3)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    jax_checkpoints.save_checkpoint(directory, jax_state(params, jax_default_optimizer().build()),
                                    0)
    return flat


_DATASETS = {}


@pytest.fixture
def cached_datasets(monkeypatch):
    """The port trainer's datasets built once for the file (the synthetic
    digits take some 4 s a build); they are the same each time."""
    from xdiffusion_tpu_torch.training.image import train as trainer

    load = trainer.load_dataset

    def cached(name, config=None, split="train"):
        key = (name, split, config.data.image_size)
        if key not in _DATASETS:
            _DATASETS[key] = load(name, config=config, split=split)
        return _DATASETS[key]

    monkeypatch.setattr(trainer, "load_dataset", cached)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_jax_trainer_fails_on_a_base_checkpoint_where_the_port_trains(tmp_path, monkeypatch,
                                                                     cached_datasets):
    """The documented recipe of train_lora: --load_model_weights_from_checkpoint
    supplies the frozen base. JAX's trainer restores that checkpoint into
    its LoRA tree and raises orbax's ValueError before any step (ROADMAP
    queue 3); the port trains on the same base (carried through the bridge
    into a port checkpoint), leaves it bit for bit unchanged and writes
    lora_weights.pkl."""
    from xdiffusion_tpu.training.image.train import train as jax_train

    from xdiffusion_tpu_torch import lora
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.training.image import train as trainer
    from xdiffusion_tpu_torch.weights import load_flax_params

    from xdiffusion_tpu.training.image import train as jax_trainer

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = tiny_config(tmp_path / "tiny.yaml", fast_sampling=True)
    flat = _jax_base_checkpoint(config, str(tmp_path / "jax_base"))

    class Digits:  # JAX's trainer fails before its first batch: 8 blank ones
        synthetic, images, labels = True, np.zeros((8, 16, 16, 1), np.uint8), np.zeros(8)

        def __len__(self):
            return 8

    monkeypatch.setattr(jax_trainer, "load_dataset", lambda *a, **k: (Digits(), None))
    with pytest.raises(ValueError, match="tree structures do not match"):
        jax_train(config, num_training_steps=1, batch_size=4,
                  output_path=str(tmp_path / "jax_out"), use_lora_training=True,
                  load_model_weights_from_checkpoint=str(tmp_path / "jax_base"))

    base_model = GaussianDiffusion_DDPM(load_yaml(config), device="cpu")
    load_flax_params(base_model.score_network(), flat)
    base = str(tmp_path / "base.pt")
    torch.save({"params": base_model.score_network().state_dict(), "step": 0}, base)
    built = []
    build = trainer.build_model
    monkeypatch.setattr(trainer, "build_model",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    out = trainer.train(config, num_training_steps=2, batch_size=4, num_samples=2,
                        output_path=str(tmp_path / "out"), save_and_sample_every_n=2,
                        use_lora_training=True, load_model_weights_from_checkpoint=base,
                        device="cpu", log_every=1)
    assert all(np.isfinite(r["loss"]) for r in _metrics(out).values())
    assert os.path.isfile(os.path.join(out, "lora_weights.pkl"))
    net = built[0].score_network()
    lora.detach(net)
    for k, v in base_model.score_network().state_dict().items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=0, atol=0)


def _ema_config(path):
    """The tiny fast-sampling config with an EMA (decay 0.9)."""
    tiny_config(path, fast_sampling=True)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["training"] = {"ema_decay": 0.9}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.mark.parametrize("cli_name", ["train_lora", "train_lora_moving_mnist"])
def test_train_lora_clis_end_to_end(cli_name, tmp_path, monkeypatch, cached_datasets):
    """`python -m xdiffusion_tpu_torch.train_lora` (and its moving-MNIST
    counterpart, which defaults to image/moving_mnist) on the CPU over a base
    checkpoint, with an EMA: the factors train, the grids sample base + EMA
    factors, lora_weights.pkl holds the trained factors, and a resume from
    step 1 repeats step 2's loss and ends with the same factors, Adam state
    and EMA bit for bit."""
    import importlib
    import pickle

    from xdiffusion_tpu_torch import train as train_cli

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    cli = importlib.import_module(f"xdiffusion_tpu_torch.{cli_name}")
    config = _ema_config(tmp_path / "tiny.yaml")
    common = ["--config_path", config, "--batch_size", "4", "--num_samples", "2",
              "--device", "cpu"]
    base = train_cli.main(common + ["--output_path", str(tmp_path / "base"),
                                    "--num_training_steps", "1", "--dataset_name",
                                    "image/mnist"])
    lora_args = common + ["--load_model_weights_from_checkpoint", base,
                          "--save_and_sample_every_n", "1", "--num_training_steps", "3",
                          "--lora_rank", "2"]
    out = cli.main(lora_args + ["--output_path", str(tmp_path / "run")])
    dataset = "image_moving_mnist" if cli_name.endswith("moving_mnist") else "image_mnist"
    assert out == str(tmp_path / "run" / dataset / "tiny")
    assert {"sample-1.png", "sample-3.png", "lora_weights.pkl", "tensorboard"} <= set(
        os.listdir(out))
    with open(os.path.join(out, "lora_weights.pkl"), "rb") as f:
        tree = pickle.load(f)
    assert tree["rank"] == 2 and all(np.abs(w["up"]).max() > 0 for w in tree["weights"].values())
    resumed = cli.main(lora_args + ["--output_path", str(tmp_path / "resumed"), "--resume_from",
                                    os.path.join(out, "checkpoints", "1.pt")])
    assert _metrics(resumed)[2]["loss"] == _metrics(out)[2]["loss"]
    want = torch.load(os.path.join(out, "checkpoints", "3.pt"), weights_only=True)
    got = torch.load(os.path.join(resumed, "checkpoints", "3.pt"), weights_only=True)
    for key in ("params", "ema"):
        for name, v in want[key].items():
            torch.testing.assert_close(got[key][name], v, rtol=0, atol=0)
    assert set(want["params"]) == {n for n in want["params"] if n.startswith(("down.", "up."))}
    for a, b in zip(jax.tree_util.tree_leaves(want["optimizer"]["optimizer"]["state"]),
                    jax.tree_util.tree_leaves(got["optimizer"]["optimizer"]["state"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
