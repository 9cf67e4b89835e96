"""Progressive distillation in the port against the JAX package on the CPU:
`distillation_loss_on_batch` on ddpm_32x32_v_continuous.yaml's UNet at
num_features 32 (tests/test_torch_port_text.py's `build`), with a teacher
on its own seeded weights, injected timesteps (t = 0 among them) and noise:
the loss, each example's and every student gradient; then the `distill`
CLI for two iterations of two steps with --device cpu."""

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
from test_torch_port_text import build, config_path, small

NAME = "mnist/ddpm_32x32_v_continuous"
N = 64


def _teacher(params, pmodel):
    """Another seeded tree of the same network: (flax params, port module)."""
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(params["params"]).items()}
    drawn = random_flax_params(flat, seed=11)
    tparams = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    teacher = copy.deepcopy(pmodel.score_network())
    load_flax_params(teacher, drawn)
    return tparams, teacher.requires_grad_(False)


def test_distillation_loss_and_gradients_match_jax():
    """Two teacher DDIM half-steps (the second's x read from z_t, as in JAX),
    the implied x and epsilon targets (x_pred at t = 0) and the student's
    epsilon MSE, at t = (0, 5, 31, 60) / 64 with injected noise: the loss
    and each example's to 1e-5 relative; every student gradient against
    jax.value_and_grad to 1e-3 of its largest magnitude, floored at 1e-3 of
    the network's largest gradient (fp32 sums in other orders through the
    UNet's backward); the teacher gets no gradient."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    jmodel, params, pmodel = build(NAME)
    tparams, teacher = _teacher(params, pmodel)
    rng = np.random.default_rng(29)
    images = rng.random((4, 32, 32, 1)).astype(np.float32)
    eps = rng.standard_normal(images.shape).astype(np.float32)
    t = (np.array([0, 5, 31, 60]) / N).astype(np.float32)

    def jloss(p):
        return jmodel.distillation_loss_on_batch(
            p, tparams, jax.random.PRNGKey(1), jnp.asarray(images), {}, N,
            timesteps=jnp.asarray(t), noise=jnp.asarray(eps))

    (want, wm), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    net = pmodel.score_network()
    net.zero_grad()
    got, gm = pmodel.distillation_loss_on_batch(torch.from_numpy(images), {}, N, teacher,
                                                timesteps=torch.from_numpy(t),
                                                noise=torch.from_numpy(eps))
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(gm["loss_per_example"].numpy(),
                               np.asarray(wm["loss_per_example"]), rtol=1e-5)
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(grads["params"]).items()}
    want_grads = flax_to_state_dict(flat, net)
    floor = 1e-3 * max(g.abs().max().item() for g in want_grads.values())
    for name, p in net.named_parameters():
        w = want_grads[name]
        err = (p.grad - w).abs().max().item()
        assert err <= max(1e-3 * w.abs().max().item(), floor), (name, err)
    assert all(p.grad is None for p in teacher.parameters())
    net.zero_grad()


def test_distillation_loss_draws_from_its_generator():
    """Without injected draws the loss takes t = i / N, i uniform in [0, N),
    then the noise, from its generator: the same generator state gives the
    same loss, and the draws are what it injects."""
    _, params, pmodel = build(NAME)
    _, teacher = _teacher(params, pmodel)
    images = torch.rand((2, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, ma = pmodel.distillation_loss_on_batch(images, {}, N, teacher,
                                                  generator=torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        t = torch.randint(0, N, (2,), generator=gen).float() / N
        noise = torch.randn(images.shape, generator=gen)
        b, mb = pmodel.distillation_loss_on_batch(images, {}, N, teacher, timesteps=t,
                                                  noise=noise)
    assert torch.equal(ma["timesteps"], t) and a.item() == b.item()
    with pytest.raises(ValueError, match="generator"):
        pmodel.distillation_loss_on_batch(images, {}, N, teacher)


def test_distill_cli_two_iterations(tmp_path, monkeypatch):
    """`python -m xdiffusion_tpu_torch.distill` with --device cpu on the
    num_features-32 config: two iterations (N = 8, then 4) of two steps from
    a teacher checkpoint's parameters (its EMA, a NaN decoy, is not read):
    finite metrics, a checkpoint per iteration, and per-step generators
    seeded by (seed + 1, step), so both iterations draw alike."""
    from test_torch_port_train import _mnist_dir

    from xdiffusion_tpu_torch import distill as cli
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", _mnist_dir(tmp_path))
    config = small(load_yaml(config_path(NAME)))
    path = tmp_path / "v_continuous_small.yaml"
    path.write_text(yaml.safe_dump(config.to_dict()))
    net = GaussianDiffusion_DDPM(config, device="cpu").score_network()
    decoy = {k: torch.full_like(v, float("nan")) for k, v in net.state_dict().items()}
    ckpt = tmp_path / "teacher.pt"
    torch.save({"step": 7, "params": net.state_dict(), "ema": decoy}, ckpt)

    out = str(tmp_path / "distilled")
    assert cli.main(["--config_path", str(path), "--teacher_model_checkpoint", str(ckpt),
                     "--distillation_iterations", "2", "--initial_sampling_steps", "16",
                     "--steps_per_iteration", "2", "--batch_size", "4", "--output_path", out,
                     "--device", "cpu"]) == out
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [(r["step"], r["N"]) for r in records] == [(0, 8), (2, 4)]
    assert all(np.isfinite(r["loss"]) for r in records)
    for n, step in ((8, 2), (4, 4)):
        payload = torch.load(os.path.join(out, f"checkpoints_N{n}", f"{step}.pt"),
                             weights_only=True)
        assert payload["step"] == step and payload["ema"] is None
        assert all(torch.isfinite(v).all() for v in payload["params"].values()
                   if v.is_floating_point())
    draws = [torch.rand(3, generator=cli.step_generator("cpu", 1, s)) for s in (0, 1, 0)]
    assert torch.equal(draws[0], draws[2]) and not torch.equal(draws[0], draws[1])
