"""Flexible Diffusion Modeling in the port against the JAX package on the
CPU, with the same seeded weights (every parameter drawn away from zero,
the zero-initialised `out`/`proj_out`/`final_conv` too) and the same inputs
made with numpy from a seed:

- `RPENet`; `RPEAttention` temporal (relative-position terms on q, k and v
  over non-arange frame indices, the group mask with pad slots, T different
  from the head dim) and spatial (neither); `FactorizedAttentionBlock`;
  the lookup-table refusal;
- the factorized 3-D UNet on tests/fixtures/fdm_parity.yaml with and
  without `observed_mask`/`x0`, its loss and every gradient against jitted
  `jax.value_and_grad`, a 10-step ancestral trajectory with injected noise,
  and `flexible_diffusion_modeling.yaml` at full width with JAX's
  parameter count;
- `fdm_random_mask` and `sample_fdm_training_batch` (both methods, t == n
  too) bit for bit over many seeds; the video resize;
- the video trainer on the fixture-size FDM config: its FDM batches reach
  the network, and a resume repeats the loss bit for bit;
- `video/moving_mnist_256` on its synthesizer.

Tolerances: fp32, sums in other orders; layers 1e-5 of the output's scale,
the network 2e-5, gradients `GRAD_TOL` (1e-4 of each gradient's largest
magnitude, floored at 1e-3 of the network's; one below that floor, which
vanishes in exact arithmetic, to 1e-3 of the floor), the trajectory 1e-4
on samples in [0, 1]. Moving-MNIST-256's uint8 frames: at most one level
apart, on at most 1e-5 of the values (its resize sums in another order
than XLA's before the truncation)."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import GRAD_TOL, _flat, _tree
from test_torch_port_video_unet import (
    _close,
    _fixture,
    _jnp,
    _net_classes,
    _normal,
    _torch,
    vanishing_aware_grad_errors,
)

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FDM = os.path.join(REPO, "configs", "video", "moving_mnist", "flexible_diffusion_modeling.yaml")
# Source frame indices with repeats and gaps, and a mask that leaves pad
# slots (neither observed nor latent) in the first example.
FRAME_INDICES = np.int32([[0, 3, 7, 2, 9], [5, 1, 9, 4, 4]])
OBSERVED = np.float32([[0, 1, 0, 0, 0], [1, 0, 0, 1, 0]])
LATENT = np.float32([[1, 0, 1, 0, 0], [0, 1, 1, 0, 1]])


def _pair(jmod, pmod, args, seed, jax_kwargs=None, port_kwargs=None):
    """(JAX output, port output) on the same seeded weights."""
    jax_kwargs, port_kwargs = jax_kwargs or {}, port_kwargs or {}
    init = functools.partial(jmod.init, **jax_kwargs)  # static: not traced
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *_jnp(args))
    drawn = random_flax_params(_flat(shapes["params"]), seed=seed)
    want = jax.jit(functools.partial(jmod.apply, **jax_kwargs))(
        {"params": _tree(drawn)}, *_jnp(args))
    load_flax_params(pmod, drawn)
    with torch.no_grad():
        got = pmod(*_torch(args), **port_kwargs)
    return want, got


# ---- layers --------------------------------------------------------------------------


def test_rpe_net_matches_jax():
    """RPENet(64 channels, 2 heads) on (2, 5, 48) embeddings and the signed
    distances of non-arange frame indices: (2, 5, 5, 2, 32), 1e-5."""
    from xdiffusion_tpu.layers.attention import RPENet as JaxRPENet

    from xdiffusion_tpu_torch.layers.attention import RPENet

    rng = np.random.default_rng(0)
    temb = _normal(rng, 2, 5, 48)
    rel = FRAME_INDICES[:, :, None] - FRAME_INDICES[:, None, :]
    want, got = _pair(JaxRPENet(channels=64, num_heads=2), RPENet(64, 2, 48), (temb, rel), 1)
    assert tuple(got.shape) == (2, 5, 5, 2, 32)
    assert np.abs(np.asarray(want)).max() > 1e-1
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["temporal", "spatial"])
def test_rpe_attention_matches_jax(kind):
    """RPEAttention on tokens (2, 6, 5, 64), 2 heads of 32: temporal with
    the three relative-position nets over FRAME_INDICES and the group mask
    clip(OBSERVED + LATENT) (a pad slot in the first example), spatial with
    neither; every weight drawn, so the rpe_q transpose, the residual onto
    the normed input and the zero-initialised projections all count. 1e-5."""
    from xdiffusion_tpu.layers.attention import RPEAttention as JaxAttention

    from xdiffusion_tpu_torch.layers.attention import RPEAttention

    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 6, 5, 64) * 2 + 0.3
    if kind == "temporal":
        args = (x, _normal(rng, 2, 5, 48), FRAME_INDICES, np.clip(OBSERVED + LATENT, 0, 1))
        jmod = JaxAttention(channels=64, num_heads=2, time_embed_dim=48, use_rpe_net=True)
        pmod = RPEAttention(64, 2, 48, use_rpe_net=True)
    else:
        args = (x,)
        jmod = JaxAttention(channels=64, num_heads=2, use_rpe_q=False, use_rpe_k=False,
                            use_rpe_v=False)
        pmod = RPEAttention(64, 2, use_rpe_q=False, use_rpe_k=False, use_rpe_v=False)
    want, got = _pair(jmod, pmod, args, 3)
    _close(got, want, 1e-5)


def test_rpe_attention_terms_are_each_held():
    """Each relative-position term on its own (the other two off) against
    JAX, so that no term's error hides behind another's: q (its transpose),
    k and v. 1e-5."""
    from xdiffusion_tpu.layers.attention import RPEAttention as JaxAttention

    from xdiffusion_tpu_torch.layers.attention import RPEAttention

    rng = np.random.default_rng(4)
    x = _normal(rng, 2, 3, 5, 64)
    args = (x, _normal(rng, 2, 5, 48), FRAME_INDICES, None)
    for term in "qkv":
        flags = {f"use_rpe_{t}": t == term for t in "qkv"}
        want, got = _pair(JaxAttention(channels=64, num_heads=2, time_embed_dim=48,
                                       use_rpe_net=True, **flags),
                          RPEAttention(64, 2, 48, use_rpe_net=True, **flags), args, 5)
        _close(got, want, 1e-5)


def test_factorized_attention_block_matches_jax():
    """FactorizedAttentionBlock on frame-folded maps (2*5, 4, 4, 64): the
    temporal RPE attention over the frames at each of the 16 positions,
    then spatial attention within each frame. 1e-5."""
    from xdiffusion_tpu.layers.attention import FactorizedAttentionBlock as JaxBlock

    from xdiffusion_tpu_torch.layers.attention import FactorizedAttentionBlock

    rng = np.random.default_rng(6)
    args = (_normal(rng, 10, 4, 4, 64), _normal(rng, 2, 5, 48), FRAME_INDICES,
            np.clip(OBSERVED + LATENT, 0, 1))
    want, got = _pair(JaxBlock(channels=64, num_heads=2, time_embed_dim=48),
                      FactorizedAttentionBlock(64, 2, 48), args, 7,
                      jax_kwargs={"frames": 5}, port_kwargs={"frames": 5})
    assert tuple(got.shape) == (10, 4, 4, 64)
    _close(got, want, 1e-5)


def test_lookup_table_rpe_is_refused_as_in_jax():
    from xdiffusion_tpu.layers.attention import RPEAttention as JaxAttention

    from xdiffusion_tpu_torch.layers.attention import RPEAttention

    x = jnp.zeros((1, 2, 3, 64))
    with pytest.raises(NotImplementedError, match="lookup-table"):
        JaxAttention(channels=64, num_heads=2).init(jax.random.PRNGKey(0), x)
    with pytest.raises(NotImplementedError, match="lookup-table"):
        RPEAttention(64, 2, 48)


# ---- the network ---------------------------------------------------------------------


def _network_inputs(masks: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = _normal(rng, 2, 4, 16, 16, 1)
    ctx = {"timestep": np.int32([10, 900]), "frame_indices": FRAME_INDICES[:, :4]}
    if masks:
        ctx.update(video_mask=LATENT[:, :4].astype(bool), observed_mask=OBSERVED[:, :4],
                   x0=_normal(rng, 2, 4, 16, 16, 1))
    return x, ctx


@pytest.mark.parametrize("masks", [True, False], ids=["observed_x0", "all_latent"])
def test_fdm_forward_matches_jax(masks):
    """The fixture's network (2 levels at 16x16, 4 frames, factorized
    attention at 8x8 and in the middle) on 2 videos: with a latent mask, an
    observed mask leaving pad slots, x0 and non-arange frame indices; and
    with none of them (every frame latent). 2e-5 of the scale."""
    from xdiffusion_tpu.config import DotConfig as JaxDot

    from xdiffusion_tpu_torch.config import DotConfig

    cfg = _fixture("fdm_parity")["diffusion"]["score_network"]
    jcls, pcls = _net_classes(cfg["target"])
    jnet, pnet = jcls(config=JaxDot(cfg["params"])), pcls(config=DotConfig(cfg["params"]))
    x, ctx = _network_inputs(masks)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x), _jnp(ctx))
    drawn = random_flax_params(_flat(shapes["params"]), seed=3)
    load_flax_params(pnet, drawn)
    want = np.asarray(jax.jit(jnet.apply)({"params": _tree(drawn)}, jnp.asarray(x), _jnp(ctx)))
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), _torch(ctx))
    assert got.dtype == torch.float32 and np.abs(want).max() > 1e-1
    _close(got, want, 2e-5)


def fdm_config(directory, num_scales: int = 1000) -> str:
    """flexible_diffusion_modeling.yaml's process (epsilon, cosine discrete
    schedule of `num_scales`, ancestral sampler, FDM batches) around the
    fixture's network, its sizes; written to `directory`."""
    with open(FDM) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["score_network"] = _fixture("fdm_parity")["diffusion"]["score_network"]
    cfg["diffusion"]["sampling"].update(output_spatial_size=16, output_frames=4)
    cfg["diffusion"]["noise_scheduler"]["params"]["num_scales"] = num_scales
    cfg["data"].update(image_size=16, input_number_of_frames=4)
    path = os.path.join(str(directory), f"fdm_{num_scales}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def build_fdm(directory, num_scales: int = 1000, seed: int = 7):
    """(JAX process, flax params, port process on the CPU) on shared seeded
    weights."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    path = fdm_config(directory, num_scales)
    jmodel = JaxDDPM(jax_load_yaml(path))
    x, ctx = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    drawn = random_flax_params(_flat(shapes["params"]), seed=seed)
    pmodel = GaussianDiffusion_DDPM(load_yaml(path), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    return jmodel, {"params": _tree(drawn)}, pmodel


def test_fdm_loss_and_every_gradient_match_jax(tmp_path):
    """loss_on_batch on 2 videos of 4 frames with FDM's batch keys (latent
    mask, observed mask with pad slots, frame indices), injected timesteps
    and noise, against jitted jax.value_and_grad: the loss and per-example
    losses to 1e-5 relative, every gradient to GRAD_TOL (a vanishing one to
    1e-3 of the floor)."""
    jmodel, params, pmodel = build_fdm(tmp_path)
    rng = np.random.default_rng(11)
    images = rng.random((2, 4, 16, 16, 1)).astype(np.float32)
    noise = _normal(rng, *images.shape)
    t = np.int32([150, 800])
    ctx = {"video_mask": LATENT[:, :4].astype(bool), "observed_mask": OBSERVED[:, :4],
           "frame_indices": FRAME_INDICES[:, :4]}

    def jax_loss(p):
        return jmodel.loss_on_batch(p, jax.random.PRNGKey(1), jnp.asarray(images), _jnp(ctx),
                                    timesteps=jnp.asarray(t), noise=jnp.asarray(noise),
                                    deterministic=True)

    (want, want_m), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    net = pmodel.score_network()
    net.zero_grad(set_to_none=True)
    got, got_m = pmodel.loss_on_batch(torch.from_numpy(images), _torch(ctx),
                                      timesteps=torch.from_numpy(t).long(),
                                      noise=torch.from_numpy(noise), deterministic=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["loss_per_example"].numpy(),
                               np.asarray(want_m["loss_per_example"]), rtol=1e-5)
    errors = vanishing_aware_grad_errors(grads, net)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_TOL, f"{worst}: {errors[worst]:.2e}"


def test_fdm_residual_blocks_never_drop_in_training(tmp_path, monkeypatch):
    """The JAX network calls its residual blocks without
    deterministic=False, so they never drop (dropout 0.1 in the config):
    the port's training forward with a dropout generator equals its eval
    forward bit for bit, every conv2 fused (K4's path)."""
    from xdiffusion_tpu_torch.layers.resnet import FusedAffineConv

    _, _, pmodel = build_fdm(tmp_path)
    net = pmodel.score_network()
    x, ctx = _network_inputs(True, seed=1)
    ctx = _torch(ctx)
    plain = []
    monkeypatch.setattr(FusedAffineConv, "plain", lambda self, h: plain.append(1))
    with torch.no_grad():
        net.eval()
        want = net(torch.from_numpy(x), ctx)
        net.train()
        got = net(torch.from_numpy(x),
                  dict(ctx, dropout_generator=torch.Generator().manual_seed(0)))
    assert not plain and torch.equal(got, want)


def test_fdm_ten_step_trajectory_matches_jax(tmp_path):
    """10 ancestral steps of a 10-scale cosine schedule at batch 2 with
    injected initial and per-step noise, frames 1 of the first video and 0,
    2 of the second observed through the splice: 1e-4 on samples in
    [0, 1]."""
    jmodel, params, pmodel = build_fdm(tmp_path, num_scales=10)
    rng = np.random.default_rng(12)
    shape = (2, 4, 16, 16, 1)
    init, noise = _normal(rng, *shape), _normal(rng, 10, *shape)
    mask = np.ones((2, 4), dtype=bool)
    mask[0, 1] = mask[1, 0] = mask[1, 2] = False
    ctx = {"sampling_noise": noise, "video_mask": mask, "x0": rng.uniform(-1, 1, shape).astype(
        np.float32)}
    want = np.asarray(jmodel.sample(params, jax.random.PRNGKey(0), num_samples=2,
                                    num_sampling_steps=10, initial_noise=jnp.asarray(init),
                                    context=_jnp(ctx)))
    got = pmodel.sample(num_samples=2, num_sampling_steps=10, initial_noise=torch.from_numpy(init),
                        context=_torch(ctx)).numpy()
    assert got.shape == shape and np.abs(want - 0.5).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fdm_config_builds_at_full_width_with_jax_parameter_count():
    """flexible_diffusion_modeling.yaml (128 channels, [1, 2, 2, 2], 32x32,
    16 frames, 4 heads) builds with the port on the CPU, fp32, with as many
    parameters as the JAX network (shapes from jax.eval_shape of init)."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model

    net = build_model(load_yaml(FDM), device="cpu").score_network()
    jmodel = JaxDDPM(jax_load_yaml(FDM))
    x, ctx = jmodel.example_batch(1)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in net.parameters()) == want == 49061377
    assert all(p.dtype == torch.float32 for p in net.parameters())


# ---- FDM batches, the resize, the trainer --------------------------------------------


@pytest.mark.parametrize("max_obs", [None, 2, 0])
def test_fdm_random_mask_matches_jax_bit_for_bit(max_obs):
    """fdm_random_mask over 40 seeds (batch 6 of 16 frames): the same masks
    as JAX's for the same generator, and the generators left in the same
    state."""
    from xdiffusion_tpu.training_utils import fdm_random_mask as jax_mask

    from xdiffusion_tpu_torch.training_utils import fdm_random_mask

    for seed in range(40):
        jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(fdm_random_mask(6, 16, prng, max_obs),
                                      jax_mask(6, 16, jrng, max_obs))
        assert prng.random() == jrng.random()


@pytest.mark.parametrize("method,t,n", [("random", 16, 16), ("random", 30, 16),
                                        ("random", 30, 8), ("random", 5, 4),
                                        ("uniform", 30, 16)])
def test_sample_fdm_training_batch_matches_jax_bit_for_bit(method, t, n):
    """sample_fdm_training_batch over 60 seeds (batch 4 of t frames to n;
    t == n ends its loop at the full-slot break): the gathered videos, frame
    indices, observed and latent masks equal JAX's bit for bit, with their
    dtypes, and the generators are left in the same state."""
    from xdiffusion_tpu.training_utils import sample_fdm_training_batch as jax_batch

    from xdiffusion_tpu_torch.training_utils import sample_fdm_training_batch

    videos = np.random.default_rng(0).random((4, t, 3, 3, 1)).astype(np.float32)
    for seed in range(60):
        jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = sample_fdm_training_batch(videos, n, method, prng)
        want = jax_batch(videos, n, method, jrng)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert prng.random() == jrng.random()
    fi, observed, latent = got[1:]
    assert fi.shape == (4, n) and ((observed + latent) <= 1).all()


@pytest.mark.parametrize("size", [16, 64])
def test_resize_video_matches_jax(size):
    """The video pipeline's resize (32 -> 16 and 32 -> 64) against
    jax.image.resize on (2, 3, 32, 32, 1) videos in [0, 1]: 2e-7."""
    from xdiffusion_tpu.training_utils import _resize_video as jax_resize

    from xdiffusion_tpu_torch.training_utils import _resize_video

    v = np.random.default_rng(size).random((2, 3, 32, 32, 1)).astype(np.float32)
    got = _resize_video(v, size)
    assert got.shape == (2, 3, size, size, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_resize(v, size), atol=2e-7, rtol=0)


def test_video_trainer_takes_fdm_batches_and_resumes(tmp_path, monkeypatch):
    """train() on the fixture-size FDM config (10 scheduler steps), batch 2,
    2 steps: each step's network sees the FDM batch that
    sample_fdm_training_batch draws from the (seed, step) generator after
    the crop (video_mask = the latent mask, observed_mask, frame_indices);
    sample-2.png and sample-2.gif are written; a resume from step 1 repeats
    step 1's loss bit for bit."""
    from xdiffusion_tpu_torch.score_networks.unet_factorized3d import Unet
    from xdiffusion_tpu_torch.training.video.train import train
    from xdiffusion_tpu_torch.training_utils import (
        get_training_batch,
        preprocess_training_videos,
        sample_fdm_training_batch,
    )

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    path = fdm_config(tmp_path, num_scales=10)
    seen = []
    forward = Unet.forward

    def spy(self, x, context):
        if "observed_mask" in context:  # a training step's (not the sample strips')
            seen.append({k: context[k].numpy().copy()
                         for k in ("video_mask", "observed_mask", "frame_indices")})
        return forward(self, x, context)

    monkeypatch.setattr(Unet, "forward", spy)
    kw = dict(num_training_steps=2, batch_size=2, save_and_sample_every_n=1, device="cpu",
              log_every=1, num_samples=2, sampling_steps=2)
    run = train(path, output_path=str(tmp_path / "a"), **kw)
    assert len(seen) == 2
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.datasets.utils import batch_iterator

    config = load_yaml(path)
    dataset, _ = load_dataset("video/moving_mnist", config=config)
    for step, batch in enumerate(batch_iterator(dataset, 2, seed=0)):
        if step == 2:
            break
        rng = np.random.default_rng((0, step))
        videos = get_training_batch(batch["videos"], False, rng=rng)
        videos, _ = preprocess_training_videos(videos, config, rng=rng)
        _, fi, observed, latent = sample_fdm_training_batch(videos, 4, "random", rng)
        np.testing.assert_array_equal(seen[step]["video_mask"], latent.astype(bool))
        np.testing.assert_array_equal(seen[step]["observed_mask"], observed)
        np.testing.assert_array_equal(seen[step]["frame_indices"], fi)
    assert {"sample-2.png", "sample-2.gif"} <= set(os.listdir(run))
    resumed = train(path, output_path=str(tmp_path / "b"),
                    resume_from=os.path.join(run, "checkpoints", "1.pt"), **kw)

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f)}

    assert losses(resumed)[1] == losses(run)[1]


def test_moving_mnist_256_matches_jax(monkeypatch):
    """video/moving_mnist_256 on its synthesizer (3 videos of 30 frames at
    256x256, two digits each) resized to 32: its uint8 frames within one
    level of JAX's on at most 1e-5 of the values, its labels equal, and its
    prompts ("three and 7") equal for the same generator."""
    from xdiffusion_tpu.datasets import moving_mnist_256 as jax_mm

    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.datasets import moving_mnist_256

    got = moving_mnist_256.MovingMNIST256(image_size=32, num_videos=3)
    want = jax_mm.MovingMNIST256(image_size=32, num_videos=3)
    assert got.synthetic and got.videos.shape == want.videos.shape == (3, 30, 32, 32, 1)
    diff = np.abs(got.videos.astype(int) - want.videos.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5
    assert want.videos.max() > 100
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.shape == (3, 2)
    prompts = moving_mnist_256.convert_labels_to_prompts(got.labels, np.random.default_rng(1))
    seeded = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *args: seeded(1))
    assert prompts == jax_mm.convert_labels_to_prompts(want.labels)
    monkeypatch.undo()
    assert all(" and " in p for p in prompts)
    frames, label = got[1]
    assert frames.dtype == np.float32 and frames.max() <= 1.0 and tuple(label) == tuple(got.labels[1])
    ds, to_prompts = load_dataset("video/moving_mnist_256", config=None)
    assert isinstance(ds, moving_mnist_256.MovingMNIST256) and len(ds) == 100
    assert to_prompts is moving_mnist_256.convert_labels_to_prompts
