"""Sana in the port against the JAX package on the CPU: the ReLU linear
attention, the GLUMBConv Mix-FFN and one transformer block at the shipped
width (d 1152: 36 linear heads of 32, 2 cross-attention heads of 576 over 300
caption keys of 1152, batch 2) on carried weights; `sana.yaml` cut to depth
2 at d 128 (4 linear heads of 32, 2 cross heads of 64): forward, loss, every
parameter's gradient against jitted `jax.value_and_grad`, a 10-step guided
ancestral trajectory with injected noise; the offline prompt embedders
(`SanaPromptToTextEmbedding` bit for bit, `CLIPTextTokenProjection`); the
config built at full width with JAX's parameter count; and a tiny Sana
through the training and sampling CLIs.

The port's cross-attention runs K5's plain version here (CPU tensors); the
JAX side sends these calls to XLA (its flash gate needs 1024 queries)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml
from test_torch_port_cascade import few_digits
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_mmdit import (
    TINY,
    check_forward,
    check_full_width,
    check_loss_and_gradients,
    check_trajectory,
    config_path,
    shared_weights,
)

# depth 2, d = 32 * 4 = 128; the caption stays 300 x 2304.
TINY["sana"] = dict(num_layers=2, num_attention_heads=4)
FULL = dict(dim=1152, heads=36, cross_heads=2, grid=(4, 4), captions=300)


def _scaled_close(got, want, rel: float) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=rel * max(1.0, np.abs(want).max()),
                               rtol=0)


def test_relu_linear_attention_matches_jax_at_full_width():
    """(B 2, 36 heads, 16 tokens, 32): fp32, 1e-6 of the output's scale
    (einsums in other orders; the normaliser's eps 1e-15 as JAX's)."""
    from xdiffusion_tpu.score_networks.sana import relu_linear_attention as jax_rla

    from xdiffusion_tpu_torch.score_networks.sana import relu_linear_attention

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 36, 16, 32)).astype(np.float32) for _ in range(3))
    want = jax.jit(jax_rla)(*(jnp.asarray(t) for t in (q, k, v)))
    got = relu_linear_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.dtype == torch.float32
    _scaled_close(got, want, 1e-6)
    # A row whose query is all negative has no ReLU features: 0 / eps = 0.
    q[0, 0, 0] = -1.0
    got = relu_linear_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert torch.equal(got[0, 0, 0], torch.zeros(32))


def test_glumbconv_matches_jax_at_full_width():
    """The Mix-FFN on the 4x4 grid at C 1152 (hidden int(2.5 C) = 2880; the
    depthwise conv's (3, 3, 1, 5760) kernel carried as groups=5760): fp32,
    2e-5 of the output's scale."""
    from xdiffusion_tpu.score_networks.sana import GLUMBConv as JaxGLU

    from xdiffusion_tpu_torch.score_networks.sana import GLUMBConv

    x = np.random.default_rng(1).standard_normal((2, 4, 4, FULL["dim"])).astype(np.float32)
    jmod, port = JaxGLU(out_channels=FULL["dim"]), GLUMBConv(FULL["dim"], FULL["dim"])
    assert port.conv_depth.weight.shape == (5760, 1, 3, 3) and port.conv_depth.groups == 5760
    params = shared_weights(jmod, port, jnp.asarray(x))
    want = jax.jit(jmod.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _scaled_close(got, want, 2e-5)


def test_sana_block_matches_jax_at_full_width():
    """One block at d 1152 on 16 tokens, 300 caption keys and the six shared
    modulation rows: 2 cross-attention heads of 576 (the head dim K5/K6 take
    on the card). fp32, 2e-5 of the output's scale."""
    from xdiffusion_tpu.score_networks.sana import SanaTransformerBlock as JaxBlock

    from xdiffusion_tpu_torch.score_networks.sana import SanaTransformerBlock

    d, n = FULL["dim"], FULL["grid"][0] * FULL["grid"][1]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n, d)).astype(np.float32)
    y = rng.standard_normal((2, FULL["captions"], d)).astype(np.float32)
    mod = (0.3 * rng.standard_normal((2, 6, d))).astype(np.float32)
    jmod = JaxBlock(dim=d, num_attention_heads=FULL["heads"],
                    num_cross_attention_heads=FULL["cross_heads"], grid=FULL["grid"])
    port = SanaTransformerBlock(d, FULL["heads"], FULL["cross_heads"], grid=FULL["grid"])
    seen = []
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    def spy(q, k, v, scale):
        seen.append((tuple(q.shape), tuple(k.shape), scale))
        return fa.flash_attention_plain(q, k, v, scale)

    args = tuple(jnp.asarray(a) for a in (x, y, mod))
    params = shared_weights(jmod, port, *args)
    want = jax.jit(jmod.apply)(params, *args)
    original = fa._flash_forward
    fa._flash_forward = spy
    try:
        with torch.no_grad():
            got = port(*(torch.from_numpy(a) for a in (x, y, mod)))
    finally:
        fa._flash_forward = original
    assert seen == [((2, 2, n, 576), (2, 2, FULL["captions"], 576), 576 ** -0.5)]
    _scaled_close(got, want, 2e-5)


def test_forward_matches_jax():
    check_forward("sana")


def test_loss_and_every_gradient_match_jax():
    check_loss_and_gradients("sana")


def test_guided_trajectory_matches_jax():
    check_trajectory("sana")


def test_config_builds_at_full_width_with_jax_parameter_count():
    check_full_width("sana")


def test_sana_prompt_embedder_is_bit_equal_to_jax():
    """The offline hash embeddings at Gemma-2's width, (B, 300, 2304), bit
    for bit; a context that already holds the output passes through."""
    from xdiffusion_tpu.layers.embedding import SanaPromptToTextEmbedding as JaxSana

    from xdiffusion_tpu_torch.layers.embedding import SanaPromptToTextEmbedding

    prompts = ["0", "seven", "", "a handwritten digit three"]
    want = np.asarray(JaxSana()({"text_prompts": prompts})["text_embeddings"])
    got = SanaPromptToTextEmbedding()({"text_prompts": prompts, "classes": 1})
    assert sorted(got) == ["classes", "text_embeddings", "text_prompts"]
    assert got["text_embeddings"].dtype == torch.float32
    assert tuple(got["text_embeddings"].shape) == (4, 300, 2304)
    np.testing.assert_array_equal(got["text_embeddings"].numpy(), want)
    short = SanaPromptToTextEmbedding(max_length=7, embedding_dim=16, output_key="emb")
    assert tuple(short({"text_prompts": ["1"]})["emb"].shape) == (1, 7, 16)
    ctx = {"text_prompts": ["1"], "text_embeddings": torch.ones(1)}
    assert SanaPromptToTextEmbedding()(ctx) is ctx


def test_clip_text_token_projection_matches_jax():
    """Token ids (B 2, 77) through the offline table and position embedding
    at width 768 on carried weights: fp32, exact up to one rounding of the
    add (1e-6 of the scale); shorter sequences take the first rows of the
    position table."""
    from xdiffusion_tpu.layers.embedding import CLIPTextTokenProjection as JaxProj

    from xdiffusion_tpu_torch.layers.embedding import CLIPTextTokenProjection

    tokens = np.random.default_rng(3).integers(0, 49408, size=(2, 77)).astype(np.int32)
    jmod, port = JaxProj(), CLIPTextTokenProjection()
    params = shared_weights(jmod, port, jnp.asarray(tokens))
    for length in (77, 20):
        want = jax.jit(jmod.apply)(params, jnp.asarray(tokens[:, :length]))
        with torch.no_grad():
            got = port(torch.from_numpy(tokens[:, :length]))
        assert tuple(got.shape) == (2, length, 768)
        _scaled_close(got, want, 1e-6)


def _tiny_config_file(tmp_path) -> str:
    """sana.yaml at TINY's size, the scheduler's 1000 steps cut to 10 so the
    trainer's end grid stays quick."""
    with open(config_path("sana")) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["score_network"]["params"].update(TINY["sana"])
    sched = cfg["diffusion"]["noise_scheduler"]["params"]
    sched["num_scales"] = sched["importance_sampler"]["params"]["num_timesteps"] = 10
    path = tmp_path / "sana.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_sana_through_the_training_and_sampling_clis(tmp_path, monkeypatch):
    """The tiny Sana through `python -m xdiffusion_tpu_torch.train --device
    cpu` for 3 steps at batch 2 (prompts from the digit labels through the
    hash embedder, the guidance drop at 0.1), a resume from the step-2
    checkpoint that repeats step 3's loss bit for bit, then the sampling
    CLI with prompts and the config's guidance."""
    from xdiffusion_tpu_torch import sample as sample_cli
    from xdiffusion_tpu_torch import train as train_cli

    few_digits(monkeypatch, tmp_path)
    config = _tiny_config_file(tmp_path)
    common = ["--config_path", config, "--batch_size", "2", "--save_and_sample_every_n", "2",
              "--num_samples", "2", "--device", "cpu"]
    run = train_cli.main(common + ["--num_training_steps", "3",
                                   "--output_path", str(tmp_path / "run")])
    import json

    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = {r["step"]: r for r in map(json.loads, f)}
    assert sorted(metrics) == [0, 2]  # every 50th step and the last
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in metrics.values())
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2.pt", "3.pt"]
    resumed = train_cli.main(common + ["--num_training_steps", "3", "--output_path",
                                       str(tmp_path / "resumed"), "--resume_from",
                                       os.path.join(run, "checkpoints", "2.pt")])
    with open(os.path.join(resumed, "metrics.jsonl")) as f:
        again = {r["step"]: r for r in map(json.loads, f)}
    assert again[2]["loss"] == metrics[2]["loss"]
    samples = sample_cli.main(["--config_path", config, "--checkpoint",
                               os.path.join(run, "checkpoints", "3.pt"), "--num_samples", "3",
                               "--sampling_steps", "3", "--guidance", "1.0",
                               "--text_prompts", "0,1", "--output_path", str(tmp_path / "s"),
                               "--device", "cpu"])
    assert tuple(samples.shape) == (3, 32, 32, 1) and bool(torch.isfinite(samples).all())
    assert os.path.getsize(tmp_path / "s" / "sample-step3.png") > 0
