"""The trainer extras of the port against the JAX package on the CPU:
importance sampling (the host path, the device update and weights, the
pre-warm-up draw, a resume), gradient accumulation (against
`optax.MultiSteps`), the step profiler's window, NaN debugging, the model
summary, the TensorBoard event writer and the native batch assembler.

Networks: the tiny flagship UNet of test_torch_port_train.py (num_features
32, fp32) on seeded flax weights through the bridge, the small SongUNet of
test_torch_port_edm.py and the tiny DDPM cascade of
test_torch_port_cascade.py.
"""

import io
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_train import _build, tiny_config

# ---- importance sampling ------------------------------------------------------


def _warmed(sampler, seed):
    """A full loss history of seeded values in [0.01, 0.11) (float32)."""
    rng = np.random.default_rng(seed)
    shape = (sampler.num_timesteps, sampler.history_per_term)
    return (0.01 + 0.1 * rng.random(shape)).astype(np.float32)


def _pairs(rng, n, t_max, dup_max=4):
    """A batch of (timestep, loss) pairs, a third of them among `dup_max`
    timesteps (duplicates)."""
    ts = rng.integers(0, t_max, size=n)
    dup = rng.random(n) < 1 / 3
    ts[dup] = rng.integers(0, dup_max, size=int(dup.sum()))
    return ts, (0.2 * rng.random(n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "cold", "warmed"])
def test_host_importance_sampling_matches_jax_bit_for_bit(kind):
    """`sample` with the same numpy generator draws the same timesteps and
    weights as the JAX package's, and `update_with_all_losses` keeps the
    same float64 history (duplicates stacking in order), before and after
    the warm-up."""
    from xdiffusion_tpu import importance_sampling as jax_is

    from xdiffusion_tpu_torch import importance_sampling as port_is

    if kind == "uniform":
        samplers = [m.UniformSampler(50) for m in (jax_is, port_is)]
    else:
        samplers = [m.ImportanceSampler(12, history_per_term=3, uniform_prob=0.01)
                    for m in (jax_is, port_is)]
        if kind == "warmed":
            for s in samplers:
                s._loss_history = _warmed(s, 0).astype(np.float64)
                s._loss_counts[:] = s.history_per_term
    rng = np.random.default_rng(1)
    for i in range(6):
        draws = [s.sample(16, rng=np.random.default_rng(10 + i)) for s in samplers]
        for a, b in zip(draws[0], draws[1]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        np.testing.assert_array_equal(samplers[1].weights(), samplers[0].weights())
        ts, losses = _pairs(rng, 16, 12 if kind != "uniform" else 50)
        for s in samplers:
            s.update_with_all_losses(ts, losses)
        if kind != "uniform":
            np.testing.assert_array_equal(samplers[1]._loss_history, samplers[0]._loss_history)
            np.testing.assert_array_equal(samplers[1]._loss_counts, samplers[0]._loss_counts)
    assert samplers[1].device_side == samplers[0].device_side


@pytest.mark.parametrize("warm", [False, True])
def test_device_update_and_weights_match_jax(warm):
    """From the same state (cold, so that rows fill, warm up and then roll;
    or a full seeded history), batches of (t, loss) pairs with duplicates
    give `device_update` states equal to the JAX package's bit for bit (the
    update moves values, it computes with none); `device_weights` to 1e-6
    relative (fp32 sums over 10 losses and over the timesteps in other
    orders)."""
    from xdiffusion_tpu import importance_sampling as jax_is

    from xdiffusion_tpu_torch import importance_sampling as port_is

    jax_s = jax_is.ImportanceSampler(20, history_per_term=3, uniform_prob=0.01)
    port_s = port_is.ImportanceSampler(20, history_per_term=3, uniform_prob=0.01)
    jstate, pstate = jax_s.init_device_state(), port_s.init_device_state()
    if warm:
        history = _warmed(port_s, 2)
        jstate = {"loss_history": jnp.asarray(history),
                  "loss_counts": jnp.full((20,), 3, jnp.int32)}
        pstate = {"loss_history": torch.from_numpy(history),
                  "loss_counts": torch.full((20,), 3, dtype=torch.int32)}
    update = jax.jit(jax_s.device_update)
    rng = np.random.default_rng(3)
    for _ in range(12):
        ts, losses = _pairs(rng, 16, 20)
        jstate = update(jstate, jnp.asarray(ts, jnp.int32), jnp.asarray(losses))
        pstate = port_s.device_update(pstate, torch.from_numpy(ts), torch.from_numpy(losses))
        for key in ("loss_history", "loss_counts"):
            np.testing.assert_array_equal(pstate[key].numpy(), np.asarray(jstate[key]))
        np.testing.assert_allclose(port_s.device_weights(pstate).numpy(),
                                   np.asarray(jax_s.device_weights(jstate)), rtol=1e-6)
    assert bool((pstate["loss_counts"] == 3).all())


def test_pre_warm_up_draw_is_uniform_with_jax_weights():
    """Until every timestep has a full history the distribution is uniform:
    the port's `device_weights` equal the JAX package's (1 / T in fp32) bit
    for bit, its draws lie in [0, T) and spread over the timesteps, and each
    draw's weight equals JAX's 1 / (T p[t]) for that t."""
    from xdiffusion_tpu import importance_sampling as jax_is

    from xdiffusion_tpu_torch import importance_sampling as port_is

    jax_s, port_s = jax_is.ImportanceSampler(10), port_is.ImportanceSampler(10)
    jstate, pstate = jax_s.init_device_state(), port_s.init_device_state()
    pstate["loss_counts"][:9] = 10  # one row short of the warm-up
    jstate["loss_counts"] = jnp.asarray(pstate["loss_counts"].numpy())
    p = np.asarray(jax_s.device_weights(jstate))
    np.testing.assert_array_equal(port_s.device_weights(pstate).numpy(), p)
    np.testing.assert_array_equal(p, np.full(10, np.float32(0.1)))
    t, w = port_s.device_sample(torch.Generator().manual_seed(0), 400, pstate)
    assert t.dtype == torch.long and int(t.min()) >= 0 and int(t.max()) < 10
    assert len(set(t.tolist())) == 10
    want = np.asarray(1.0 / (10 * jnp.asarray(p)[jnp.asarray(t.numpy())])).astype(np.float32)
    np.testing.assert_array_equal(w.numpy(), want)


def _importance_config(path):
    """The tiny fast-sampling config with an ImportanceSampler over its 10
    steps, 2 losses a step."""
    tiny_config(path, fast_sampling=True)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["noise_scheduler"]["params"]["importance_sampler"] = {
        "target": "xdiffusion_tpu.importance_sampling.ImportanceSampler",
        "params": {"num_timesteps": 10, "history_per_term": 2, "uniform_prob": 0.01}}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_importance_state_is_checkpointed_and_a_resume_repeats(tmp_path, monkeypatch):
    """The trainer with an ImportanceSampler keeps its state on the device:
    after 6 steps at batch 4 (24 pairs over 10 x 2 slots) it has moved,
    the checkpoint holds it, and a resume from step 3 repeats steps 3-5's
    losses and ends with the same state bit for bit."""
    from xdiffusion_tpu_torch.training.image.train import train

    from test_torch_port_cascade import few_digits

    few_digits(monkeypatch, tmp_path)
    config = _importance_config(tmp_path / "tiny.yaml")
    common = dict(batch_size=4, num_samples=2, save_and_sample_every_n=3, device="cpu",
                  log_every=1)
    out = train(config, num_training_steps=6, output_path=str(tmp_path / "run"), **common)
    resumed = train(config, num_training_steps=6, output_path=str(tmp_path / "resumed"),
                    resume_from=os.path.join(out, "checkpoints", "3.pt"), **common)
    want, got = _metrics(out), _metrics(resumed)
    assert [got[i]["loss"] for i in range(3, 6)] == [want[i]["loss"] for i in range(3, 6)]
    a = torch.load(os.path.join(out, "checkpoints", "6.pt"), weights_only=True)["importance"]
    b = torch.load(os.path.join(resumed, "checkpoints", "6.pt"), weights_only=True)["importance"]
    assert int(a["loss_counts"].sum()) > 0 and float(a["loss_history"].abs().sum()) > 0
    for key in a:
        torch.testing.assert_close(b[key], a[key], rtol=0, atol=0)


# ---- gradient accumulation ----------------------------------------------------


def test_multisteps_matches_optax_on_shared_gradients():
    """`optim.MultiSteps(clip + Adam, 2)` against `optax.MultiSteps` of the
    JAX package's default chain, fed the same 6 gradients (mini-batches 2
    and 5 above the clip, the others below it): the parameters bit for bit
    unchanged after mini-steps 1, 3 and 5, else within 1e-6 (fp32 rounding
    of the update); the returned norm is the mini-batch's; the schedule
    counts real updates."""
    import optax

    from xdiffusion_tpu.optim import default_optimizer as jax_default_optimizer

    from xdiffusion_tpu_torch.optim import MultiSteps, default_optimizer

    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (2.0 if i in (1, 4) else 0.05)).astype(np.float32)
              for k, s in shapes.items()} for i in range(6)]
    tx = optax.MultiSteps(jax_default_optimizer().build(), 2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ptx = MultiSteps(default_optimizer().build(list(tparams.values())), 2)
    for i, g in enumerate(grads):
        before = {k: p.clone() for k, p in tparams.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = ptx.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)), rtol=1e-6)
        for k in shapes:
            if i % 2 == 0:
                torch.testing.assert_close(tparams[k], before[k], rtol=0, atol=0)
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"mini-step {i} {k}")
        assert ptx.count == (i + 1) // 2 == int(opt_state.gradient_step)
        assert ptx.mini_step == int(opt_state.mini_step)


def _injected(monkeypatch, model):
    """Makes `model.loss_on_batch` take its noise from the context's
    "noise" (so that each mini-batch brings its own) with dropout off."""
    loss = type(model).loss_on_batch

    def injected(*args, **kwargs):
        *head, images, context = args
        context = dict(context)
        noise = context.pop("noise")
        return loss(model, *head, images, context, noise=noise, deterministic=True, **kwargs)

    monkeypatch.setattr(model, "loss_on_batch", injected)


def test_accumulated_train_steps_match_jax(tmp_path, monkeypatch):
    """k = 2 over 4 mini-steps with EMA (decay 0.9): the port's train step
    over `MultiSteps` against the JAX package's over `optax.MultiSteps`, on
    the same weights and mini-batches (timesteps and noise injected, dropout
    off). Each mini-step's loss and gradient norm to 1e-5 relative (1e-4
    after the first update); the parameters move after mini-steps 2 and 4
    only, on both sides; after mini-step 2 each parameter, and its EMA,
    within the bound that the gradients' agreement (1e-4 of each one's
    largest magnitude, floored at 1e-3 of the network's largest: a bias
    ahead of a GroupNorm of one-channel groups has a true gradient of 0,
    rounding noise on both sides) puts on Adam's first update
    (test_torch_port_dit.py's step test) on the clipped mean gradient."""
    import optax

    from xdiffusion_tpu.optim import default_optimizer as jax_default_optimizer
    from xdiffusion_tpu.parallel.train_step import create_train_state as jax_state
    from xdiffusion_tpu.parallel.train_step import make_train_step as jax_step

    from xdiffusion_tpu_torch.optim import DEFAULT_LR, MultiSteps, default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    jmodel, params, pmodel = _build(tiny_config(tmp_path / "tiny.yaml"))
    net = pmodel.score_network()
    _injected(monkeypatch, jmodel)
    _injected(monkeypatch, pmodel)
    tx = optax.MultiSteps(jax_default_optimizer().build(), 2)
    state = jax_state(params, tx, ema=True)
    jstep = jax_step(jmodel, tx, ema_decay=0.9)
    pstate = create_train_state(pmodel, MultiSteps(default_optimizer().build(net.parameters()), 2),
                                ema=True)
    pstep = make_train_step(pmodel, ema_decay=0.9)
    rng = np.random.default_rng(6)

    def flat(tree):
        return flax_to_state_dict({"/".join(k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(tree["params"]).items()}, net)

    for i in range(1, 5):
        batch = {"images": rng.random((2, 16, 16, 1)).astype(np.float32),
                 "timesteps": rng.integers(0, 1000, size=2).astype(np.int32),
                 "noise": rng.standard_normal((2, 16, 16, 1)).astype(np.float32)}
        before = {k: p.detach().clone() for k, p in net.named_parameters()}
        jbefore = jax.tree_util.tree_map(np.asarray, state.params)  # the step donates it
        state, want = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))
        got = pstep(pstate, {"images": torch.from_numpy(batch["images"]),
                             "timesteps": torch.from_numpy(batch["timesteps"]).long(),
                             "noise": torch.from_numpy(batch["noise"])})
        rtol = 1e-5 if i <= 2 else 1e-4
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=rtol)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=rtol)
        moved = any(not torch.equal(p, before[k]) for k, p in net.named_parameters())
        jmoved = any(not np.array_equal(a, np.asarray(b)) for a, b in zip(
            jax.tree_util.tree_leaves(jbefore), jax.tree_util.tree_leaves(state.params)))
        assert moved == jmoved == (i % 2 == 0)
        if i == 2:
            after, ema = flat(state.params), flat(state.ema_params)
            pema = dict(pstate.ema.named_parameters())
            floor = 1e-3 * max(p.grad.abs().max() for p in net.parameters())
            for name, p in net.named_parameters():
                g = p.grad.abs()  # the clipped mean gradient Adam took
                dg = 1e-4 * torch.clamp(g.max(), min=floor)
                bound = DEFAULT_LR * torch.clamp(
                    dg * 1e-8 / (torch.clamp(g - dg, min=0) + 1e-8) ** 2, max=2.0)
                bound = bound + 1e-5 * DEFAULT_LR + 2.0 ** -22 * after[name].abs()
                assert bool(((p.detach() - after[name]).abs() <= bound).all()), name
                assert bool(((pema[name] - ema[name]).abs() <= bound).all()), name


# ---- the profiler and NaN debugging -------------------------------------------


def test_step_profiler_traces_only_its_window(tmp_path, monkeypatch, capsys):
    """StepProfiler(start_step=2) over steps 0-5 starts at step 2 and stops
    after step 4, as the JAX package's (whose jax.profiler calls are
    recorded here): one trace under <dir>/profile holding the marks of
    steps 2-4 only, its path printed; a run that ends inside the window
    writes it at close(); without a start step nothing is written;
    `step_timer` times a block. Through the trainer, `profile_start_step`
    writes one trace of its 3 steps."""
    import xdiffusion_tpu.profiling as jax_profiling

    from xdiffusion_tpu_torch import profiling

    calls = []
    monkeypatch.setattr(jax_profiling.jax.profiler, "start_trace",
                        lambda d: calls.append(("start", len(calls))))
    monkeypatch.setattr(jax_profiling.jax.profiler, "stop_trace",
                        lambda: calls.append(("stop", len(calls))))
    jax_prof = jax_profiling.StepProfiler(str(tmp_path / "jax"), start_step=2)
    prof = profiling.StepProfiler(str(tmp_path / "port"), start_step=2)
    active = []
    for step in range(6):
        jax_prof.maybe_start(step)
        prof.maybe_start(step)
        with torch.profiler.record_function(f"mark_step_{step}"):
            torch.ones(3).sum()
        active.append((step, jax_prof._active, prof._profile is not None))
        jax_prof.maybe_stop(step)
        prof.maybe_stop(step)
    assert active == [(s, 2 <= s <= 4, 2 <= s <= 4) for s in range(6)]
    traces = os.listdir(tmp_path / "port" / "profile")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "port" / "profile" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"mark_step_{s}" for s in range(6)} & names == {"mark_step_2", "mark_step_3",
                                                            "mark_step_4"}
    assert "profiler trace written to" in capsys.readouterr().out

    cut = profiling.StepProfiler(str(tmp_path / "cut"), start_step=1)
    cut.maybe_start(1)
    cut.close()
    assert len(os.listdir(tmp_path / "cut" / "profile")) == 1
    off = profiling.StepProfiler(str(tmp_path / "off"))
    for step in range(3):
        off.maybe_start(step)
        off.maybe_stop(step)
    off.close()
    assert not os.path.exists(tmp_path / "off" / "profile")
    with profiling.step_timer() as timed:
        torch.ones(8).sum()
    assert timed["seconds"] > 0

    from test_torch_port_cascade import few_digits
    from xdiffusion_tpu_torch.training.image.train import train

    few_digits(monkeypatch, tmp_path)
    out = train(tiny_config(tmp_path / "tiny.yaml", fast_sampling=True), num_training_steps=5,
                batch_size=2, num_samples=2, save_and_sample_every_n=5, device="cpu",
                output_path=str(tmp_path / "run"), profile_start_step=1)
    assert len(os.listdir(os.path.join(out, "profile"))) == 1


def _poisoned(tree, path=("params", "_downs_0_0_1", "conv1", "kernel")):
    flat = traverse_util.flatten_dict(tree)
    kernel = np.array(flat[path])
    kernel.reshape(-1)[0] = np.nan
    flat[path] = jnp.asarray(kernel)
    return traverse_util.unflatten_dict(flat)


def test_nan_debugging_raises_in_both_packages(tmp_path):
    """A NaN in a conv1 kernel: with jax_debug_nans on, the JAX package's
    loss raises FloatingPointError; inside `nan_debugging` the port's raises
    FloatingPointError naming the conv1 module. A NaN made only in a
    module's backward (0 * d sqrt(u) at u = 0) raises too. On leaving,
    autograd's anomaly mode is as before and no hook is left (the same NaN
    forward passes)."""
    from xdiffusion_tpu.profiling import enable_nan_debugging

    from xdiffusion_tpu_torch.profiling import nan_debugging
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    jmodel, params, pmodel = _build(tiny_config(tmp_path / "tiny.yaml"))
    bad = _poisoned(params)
    images = np.random.default_rng(0).random((2, 16, 16, 1)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    enable_nan_debugging(True)
    try:
        with pytest.raises(FloatingPointError):
            jmodel.loss_on_batch(bad, jax.random.PRNGKey(0), jnp.asarray(images), {},
                                 timesteps=jnp.asarray(t), deterministic=True)
    finally:
        enable_nan_debugging(False)

    net = pmodel.score_network()
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(bad["params"]).items()}
    net.load_state_dict(flax_to_state_dict(flat, net))

    def loss():
        return pmodel.loss_on_batch(torch.from_numpy(images), {},
                                    timesteps=torch.from_numpy(t).long(),
                                    noise=torch.zeros(2, 16, 16, 1), deterministic=True)[0]

    anomaly = torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match=r"forward of _downs_0_0_1\.conv1"):
        with nan_debugging(net):
            loss()
    assert torch.is_anomaly_enabled() == anomaly
    assert torch.isnan(loss())  # no hook left

    class Sqrt(torch.nn.Module):
        def forward(self, x):
            return torch.sqrt(x - x.detach()) * 0.0 + x

    module = torch.nn.Sequential(torch.nn.Linear(3, 3), Sqrt())
    out = module(torch.ones(2, 3)).sum()
    out.backward()  # unchecked: the NaN gradient passes
    assert torch.isnan(module[0].weight.grad).all()
    with pytest.raises(FloatingPointError):
        with nan_debugging(module):
            module(torch.ones(2, 3)).sum().backward()
    assert torch.is_anomaly_enabled() == anomaly


def test_debug_nans_leaves_a_clean_runs_losses(tmp_path, monkeypatch):
    """The trainer with `debug_nans` logs the same losses bit for bit as
    without it (2 steps of the tiny config)."""
    from test_torch_port_cascade import few_digits
    from xdiffusion_tpu_torch.training.image.train import train

    few_digits(monkeypatch, tmp_path)
    config = tiny_config(tmp_path / "tiny.yaml", fast_sampling=True)
    runs = [train(config, num_training_steps=2, batch_size=2, num_samples=2, device="cpu",
                  output_path=str(tmp_path / str(flag)), debug_nans=flag, log_every=1)
            for flag in (False, True)]
    a, b = (_metrics(r) for r in runs)
    assert [a[i]["loss"] for i in (0, 1)] == [b[i]["loss"] for i in (0, 1)]


# ---- the model summary --------------------------------------------------------


def _jax_totals(text):
    return [int(line.split(":")[1].split("(")[0].replace(",", ""))
            for line in text.splitlines() if "Total Parameters:" in line]


def _top_counts(tree):
    counts = {}
    for path, value in traverse_util.flatten_dict(tree).items():
        counts[path[0]] = counts.get(path[0], 0) + int(np.prod(value.shape))
    return counts


@pytest.mark.parametrize("kind", ["ddpm", "edm", "cascade"])
def test_model_summary_matches_the_jax_table(kind, tmp_path, tmp_path_factory):
    """The port's table (forward hooks over the same example inputs) against
    the JAX package's `flax.linen.tabulate` one: the same total parameters
    (one table per stage of a cascade), and each top-level module's count
    that of the flax tree's top-level entry of the same name."""
    from xdiffusion_tpu.summary import model_summary as jax_summary

    from xdiffusion_tpu_torch.summary import model_summary

    if kind == "ddpm":
        jmodel, params, pmodel = _build(tiny_config(tmp_path / "tiny.yaml"))
        trees = [params["params"]]
    elif kind == "edm":
        from test_torch_port_edm import _build as build_edm
        from test_torch_port_edm import _config as edm_config

        jmodel, params, pmodel = build_edm(edm_config("small"))
        trees = [params["params"]]
    else:
        from test_torch_port_cascade import build_cascade

        jmodel, params, pmodel = build_cascade("ddpm_cascade_8x8_to_32x32", tmp_path_factory)
        trees = [params[f"stage_{k + 1}"]["params"] for k in range(len(params))]
    want = jax_summary(jmodel)
    got = model_summary(pmodel)
    assert _jax_totals(got) == _jax_totals(want) == [
        sum(_top_counts(t).values()) for t in trees]
    tables = got.split("Total Parameters:")[:-1]
    assert len(tables) == len(trees)
    for table, tree in zip(tables, trees):
        rows = {}
        for line in table.splitlines():
            cells = [c.strip() for c in line.split("|")]
            if len(cells) == 5 and cells[4].replace(",", "").isdigit() and cells[0] != "(root)":
                rows[cells[0]] = int(cells[4].replace(",", ""))
        assert {k: v for k, v in rows.items() if v} == _top_counts(tree)


def test_summary_env_gate(tmp_path, monkeypatch, capsys):
    """`print_model_summary` prints the table unless
    XDIFFUSION_MODEL_SUMMARY=0, as the JAX package's gate reads it."""
    from xdiffusion_tpu import summary as jax_summary

    from xdiffusion_tpu_torch import summary

    _, _, pmodel = _build(tiny_config(tmp_path / "tiny.yaml"))
    for value, shown in (("0", False), ("false", False), ("1", True)):
        monkeypatch.setenv("XDIFFUSION_MODEL_SUMMARY", value)
        assert summary.summary_enabled() == jax_summary.summary_enabled() == shown
        summary.print_model_summary(pmodel)
        assert ("Total Parameters:" in capsys.readouterr().out) == shown


# ---- TensorBoard ----------------------------------------------------------------


def _records(data):
    out, i = [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        out.append(data[i:i + 16 + n])
        i += 16 + n
    return out


def _png_parts(png):
    """(chunks but IDAT, the inflated IDAT) of a PNG."""
    i, chunks, idat = 8, [], b""
    while i < len(png):
        (n,) = struct.unpack(">I", png[i:i + 4])
        tag = png[i + 4:i + 8]
        if tag == b"IDAT":
            idat += png[i + 8:i + 8 + n]
        else:
            chunks.append(png[i:i + 12 + n])
        i += 12 + n
    return chunks, zlib.decompress(idat)


@pytest.mark.parametrize("channels", [1, 3])
def test_tensorboard_records_equal_jax(tmp_path, monkeypatch, channels):
    """For the same scalars, image and wall time, the port's event file
    (numpy and zlib) holds the JAX package's records (PIL) byte for byte,
    but the PNG's deflate stream where PIL links another zlib than Python's:
    there the PNG's other chunks and its inflated, filtered rows are equal.
    The file loads in the installed TensorBoard reader, as in
    tests/test_tensorboard.py."""
    import time

    ea = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    from PIL import features

    from xdiffusion_tpu.tensorboard import TensorBoardWriter as JaxWriter
    from xdiffusion_tpu.tensorboard import crc32c as jax_crc32c

    from xdiffusion_tpu_torch.tensorboard import TensorBoardWriter, crc32c

    assert crc32c(b"123456789") == jax_crc32c(b"123456789") == 0xE3069283
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    rng = np.random.default_rng(0)
    image = rng.random((40, 24, channels)).astype(np.float32)
    image[:8] = 0.5  # flat rows take the up and sub filters
    for cls, d in ((JaxWriter, "jax"), (TensorBoardWriter, "port")):
        w = cls(str(tmp_path / d))
        for step, val in enumerate([1.0, 0.5, 0.25]):
            w.add_scalar("loss", val, step)
        w.add_image("grid", image, 2)
        w.add_image("u8", (image * 255).astype(np.uint8), 3)
        w.close()
    files = [os.path.join(tmp_path, d, os.listdir(tmp_path / d)[0]) for d in ("jax", "port")]
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    want, got = (_records(open(f, "rb").read()) for f in files)
    assert len(want) == len(got) == 6
    assert want[:4] == got[:4]
    same_zlib = not features.check_feature("zlib_ng")
    for a, b in zip(want[4:], got[4:]):
        if same_zlib:
            assert a == b
        pa, pb = a[a.index(b"\x89PNG"):-4], b[b.index(b"\x89PNG"):-4]
        assert _png_parts(pa) == _png_parts(pb)
        assert a[:a.index(b"\x89PNG")][16:] != b"" and len(a) - len(pa) == len(b) - len(pb)

    acc = ea.EventAccumulator(str(tmp_path / "port"))
    acc.Reload()
    assert [s.value for s in acc.Scalars("loss")] == [1.0, 0.5, 0.25]
    img = acc.Images("grid")[0]
    assert (img.width, img.height) == (24, 40)
    from PIL import Image

    pixels = np.asarray(Image.open(io.BytesIO(img.encoded_image_string)))
    want_pixels = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(pixels.reshape(want_pixels.shape), want_pixels)


def test_metrics_logger_mirrors_scalars_and_grids(tmp_path, monkeypatch):
    """The port's MetricsLogger writes TensorBoard scalars and the sample
    grid (under <out>/tensorboard) as the JAX package's does, and none with
    XDIFFUSION_TENSORBOARD=0."""
    ea = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")

    from xdiffusion_tpu_torch.training.common import MetricsLogger

    monkeypatch.setenv("XDIFFUSION_TENSORBOARD", "1")
    logger = MetricsLogger(str(tmp_path / "run"))
    logger.log(0, {"loss": torch.tensor(2.0)})
    logger.log(50, {"loss": 1.0})
    logger.log_image_grid("samples", np.random.default_rng(0).random((4, 8, 8, 1)), 50)
    logger.close()
    acc = ea.EventAccumulator(str(tmp_path / "run" / "tensorboard"))
    acc.Reload()
    assert [s.step for s in acc.Scalars("loss")] == [0, 50]
    assert acc.Images("samples")[0].width == 16
    monkeypatch.setenv("XDIFFUSION_TENSORBOARD", "0")
    MetricsLogger(str(tmp_path / "off")).close()
    assert os.listdir(tmp_path / "off") == ["metrics.jsonl"]


# ---- the native batch assembler ---------------------------------------------------


def test_native_batch_assembler_matches_jax(monkeypatch):
    """gather_normalize on image and video arenas (indices with repeats)
    and gather_i32 equal the JAX package's native functions bit for bit
    (JAX's library called directly for gather_i32); an arena that is not
    uint8, or not contiguous, takes numpy as in JAX; an index out of range
    raises IndexError; XDIFFUSION_NO_NATIVE=1 gives the same values; the
    port's batch_iterator yields the JAX package's batches."""
    import ctypes

    from xdiffusion_tpu import native as jax_native
    from xdiffusion_tpu.datasets.utils import batch_iterator as jax_batches

    from xdiffusion_tpu_torch import native
    from xdiffusion_tpu_torch.datasets.utils import batch_iterator

    assert native.load() is not None and jax_native.native_available()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (300, 16, 16, 1), dtype=np.uint8)
    videos = rng.integers(0, 256, (20, 4, 8, 8, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, 300).astype(np.int32)
    idx = np.concatenate([rng.permutation(300)[:60], [5, 5, 299, 0]])
    for arena, ix in ((images, idx), (videos, idx % 20), (images.astype(np.float32), idx),
                      (images[:, ::2], idx)):
        got = native.gather_normalize(arena, ix)
        assert got.dtype == np.float32
        assert got.tobytes() == jax_native.gather_normalize(arena, ix).tobytes()
    want = np.empty(idx.shape, np.int32)
    ix64 = np.ascontiguousarray(idx, np.int64)
    jax_native._load().gather_i32(labels.ctypes.data, ix64.ctypes.data, len(ix64),
                                  want.ctypes.data_as(ctypes.c_void_p))
    np.testing.assert_array_equal(native.gather_i32(labels, idx), want)
    for fn in (native.gather_normalize, jax_native.gather_normalize):
        with pytest.raises(IndexError):
            fn(images, np.array([300]))
    monkeypatch.setenv("XDIFFUSION_NO_NATIVE", "1")
    assert native.load() is None
    assert native.gather_normalize(images, idx).tobytes() == \
        jax_native.gather_normalize(images, idx).tobytes()
    monkeypatch.delenv("XDIFFUSION_NO_NATIVE")

    class Digits:
        def __init__(self):
            self.images, self.labels = images, labels

        def __len__(self):
            return len(self.images)

    ours, theirs = batch_iterator(Digits(), 32, seed=4), jax_batches(Digits(), 32, seed=4)
    for _ in range(12):  # past an epoch of 9 batches
        a, b = next(ours), next(theirs)
        assert a["images"].tobytes() == b["images"].tobytes()
        np.testing.assert_array_equal(a["classes"], b["classes"])
