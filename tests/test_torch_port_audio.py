"""The audio path in the port against the JAX package on the CPU.

The mel filterbank and the synthesizer's clips bit for bit; the Hann
window, `wav_to_mel`, the log-mel normalisers and Griffin-Lim (JAX's
initial phases injected) to fp32 rounding (the FFTs, cos and log are
other implementations than XLA's); the UrbanSound8k stand-in's uint8 mels
with at most one level moved on a bounded share of the values; the CLAP
hash embedder bit for bit; `audio/urbansound8k` in the registry, square
and [frames, n_mels]; ddpm_32x32_v_continuous_clap.yaml cut to
num_features 32 and one residual block a level (the CLAP projection as
wide as the timestep embedding it is added to): the forward, the v loss
and every gradient against jitted `jax.value_and_grad`, a 10-step guided
trajectory with injected noise; the config at full width with JAX's
parameter count; the audio training CLI, `sample_audio` (WAVs, the mel
grid, its JSON line) and the audio autoencoder CLI on rectangles."""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_sora import check_full_width, check_loss_and_gradients, video_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLAP = os.path.join(REPO, "configs/audio/urbansound8k/ddpm_32x32_v_continuous_clap.yaml")
PROMPTS = ["dog bark", "siren"]


def _clips(n: int = 4):
    from xdiffusion_tpu.datasets.urbansound8k import synthesize_clips

    return synthesize_clips(n, seed=0)[0]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- the transforms ---------------------------------------------------------------


def test_filterbank_and_window_match_jax():
    """The filterbank (the same numpy code) bit for bit at 32, 80 and 128
    mels; the fp32 Hann window to an ulp (torch's cos against XLA's)."""
    from xdiffusion_tpu.layers import audio as jax_audio

    from xdiffusion_tpu_torch.layers import audio

    for n_mels in (32, 80, 128):
        np.testing.assert_array_equal(audio.mel_filterbank(n_mels=n_mels),
                                      jax_audio.mel_filterbank(n_mels=n_mels))
    want = np.asarray(jnp.hanning(1024))
    got = audio.hann_window(1024)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=6e-8, rtol=0)
    np.testing.assert_array_equal(audio.hann_window(1).numpy(), np.asarray(jnp.hanning(1)))


@pytest.mark.parametrize("n_mels", [32, 128])
def test_wav_to_mel_and_log_scale_match_jax(n_mels):
    """Four synthesizer clips at once against JAX's clip by clip: power mels
    (87 frames) to 1e-6 of their scale; the log-mels of the same mels and
    their inverse to fp32 rounding (2e-6, relative for the inverse)."""
    from xdiffusion_tpu.layers import audio as jax_audio

    from xdiffusion_tpu_torch.layers import audio

    clips = _clips()
    want = np.stack([np.asarray(jax_audio.wav_to_mel(c, n_mels=n_mels)) for c in clips])
    got = audio.wav_to_mel(torch.from_numpy(clips), n_mels=n_mels).numpy()
    assert got.shape == want.shape == (4, 87, n_mels) and got.dtype == np.float32
    assert rel(got, want) <= 1e-6
    log_want = np.asarray(jax_audio.mel_to_logmel(jnp.asarray(want)))
    log_got = audio.mel_to_logmel(torch.from_numpy(want)).numpy()
    np.testing.assert_allclose(log_got, log_want, atol=2e-6, rtol=0)
    assert log_want.min() >= 0.0 and log_got.min() >= 0.0
    back_want = np.asarray(jax_audio.logmel_to_mel(jnp.asarray(log_want)))
    back_got = audio.logmel_to_mel(torch.from_numpy(log_want)).numpy()
    np.testing.assert_allclose(back_got, back_want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("n_iter", [0, 8])
def test_griffin_lim_with_jax_phases_matches_jax(n_iter):
    """mel_to_wav of 32 frames of 128 mels with JAX's initial phases (its
    uniform draws from PRNGKey(0)) injected: the 8192-sample waveform to
    1e-5 of its scale after 0 and 8 iterations; a batch of two equals its
    clips alone; a generator's draws replace injected ones."""
    from xdiffusion_tpu.layers import audio as jax_audio

    from xdiffusion_tpu_torch.layers import audio

    mel = audio.wav_to_mel(torch.from_numpy(_clips(1)), n_mels=128)[0, :32].numpy()
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_audio.mel_to_wav(jnp.asarray(mel), n_mels=128, n_iter=n_iter, rng=key))
    phases = torch.from_numpy(np.asarray(jax.random.uniform(key, (32, 513))))
    got = audio.mel_to_wav(torch.from_numpy(mel), n_mels=128, n_iter=n_iter, phases=phases)
    assert tuple(got.shape) == want.shape == (8192,)
    assert rel(got.numpy(), want) <= 1e-5
    both = audio.mel_to_wav(torch.from_numpy(np.stack([mel, mel])), n_mels=128, n_iter=n_iter,
                            phases=torch.stack([phases, phases]))
    assert torch.equal(both[0], got) and torch.equal(both[1], got)
    drawn = audio.mel_to_wav(torch.from_numpy(mel), n_mels=128, n_iter=1,
                             generator=torch.Generator().manual_seed(0))
    again = audio.mel_to_wav(torch.from_numpy(mel), n_mels=128, n_iter=1,
                             phases=torch.rand((1, 32, 513), generator=torch.Generator().manual_seed(0)))
    assert torch.equal(drawn, again)


# ---- the dataset and the embedder ----------------------------------------------------


def test_synthesized_clips_are_bit_equal_to_jax():
    from xdiffusion_tpu.datasets.urbansound8k import synthesize_clips as jax_clips

    from xdiffusion_tpu_torch.datasets.urbansound8k import synthesize_clips

    for seed in (0, 1):
        want, want_labels = jax_clips(16, seed=seed)
        got, labels = synthesize_clips(16, seed=seed)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(labels, want_labels)


@pytest.mark.parametrize("split,size,n", [("train", 32, 512), ("test", [64, 128], 128)])
def test_urbansound8k_stand_in_matches_jax(split, size, n, tmp_path, monkeypatch):
    """The synthetic UrbanSound8k (no archive under the data root): the
    labels bit for bit; the uint8 log-mels (mels in [0, 1] times 255,
    truncated) equal JAX's but for values within rounding of a level
    boundary, which move one level, on at most 2e-5 of them (the FFT and
    log round otherwise than XLA's; 2 of 524,288 and 9-11 of 1,048,576
    here). Items are float32 in [0, 1]."""
    from xdiffusion_tpu.datasets.urbansound8k import UrbanSound8k as JaxUS

    from xdiffusion_tpu_torch.datasets.urbansound8k import UrbanSound8k

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path))
    want = JaxUS(split=split, image_size=size, num_synthetic=n)
    got = UrbanSound8k(split=split, image_size=size, num_synthetic=n)
    frames, mels = (size, size) if isinstance(size, int) else size
    assert got.synthetic and got.images.shape == want.images.shape == (n, frames, mels, 1)
    assert got.images.dtype == np.uint8 and len(got) == n
    np.testing.assert_array_equal(got.labels, want.labels)
    diff = np.abs(got.images.astype(np.int32) - want.images.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 2e-5
    item, label = got[3]
    assert item.dtype == np.float32 and 0.0 <= item.min() and item.max() <= 1.0
    assert label == int(want.labels[3])


def test_urbansound8k_registry_archive_and_prompts(tmp_path, monkeypatch):
    """`audio/urbansound8k` loads from the registry at the config's size
    (square or [frames, n_mels]); a `melspec_<split>.npz` under the data
    root is read instead of the synthesizer; labels become class names."""
    from xdiffusion_tpu.datasets.urbansound8k import convert_labels_to_prompts as jax_prompts

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.datasets.urbansound8k import convert_labels_to_prompts

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path))
    os.makedirs(tmp_path / "urbansound8k")
    rng = np.random.default_rng(0)
    mels = rng.uniform(-0.2, 1.2, size=(6, 8, 16, 1)).astype(np.float32)
    np.savez(tmp_path / "urbansound8k" / "melspec_train.npz", mels=mels,
             labels=np.int32([0, 1, 2, 3, 4, 9]))
    ds, to_prompts = load_dataset("audio/urbansound8k",
                                  config=DotConfig({"data": {"image_size": [8, 16]}}))
    assert not ds.synthetic and ds.images.shape == (6, 8, 16, 1)
    np.testing.assert_array_equal(ds.images, (np.clip(mels, 0, 1) * 255).astype(np.uint8))
    labels = np.int32([[3, 8], [0, 9]])
    assert to_prompts(labels, rng=np.random.default_rng(1)) == jax_prompts(labels) == [
        "dog bark", "siren", "air conditioner", "street music"]
    assert convert_labels_to_prompts is to_prompts


def test_clap_hash_embedder_is_bit_equal_to_jax():
    """The hash path at 1024 and 32 wide: bit for bit (after checking JAX
    took its fallback), unit norm without the + 1e-8; a context that holds
    the embeddings passes through; the port's loader finds no CLAP
    checkpoint here, so it takes the hash path, as JAX does."""
    from xdiffusion_tpu.layers.clap import FrozenCLAPTextEmbedder as JaxCLAP

    from xdiffusion_tpu_torch.layers.clap import FrozenCLAPTextEmbedder

    prompts = ["dog bark", "", "a siren", "zéro"]
    for dim in (1024, 32):
        jax_clap = JaxCLAP(embedding_dim=dim)
        JaxCLAP._loaded.setdefault(jax_clap.version, None)  # no weights: the hash path
        want = np.asarray(jax_clap({"text_prompts": prompts})["clap_embeddings"])
        got = FrozenCLAPTextEmbedder(embedding_dim=dim)({"text_prompts": prompts, "classes": 1})
        assert sorted(got) == ["clap_embeddings", "classes", "text_prompts"]
        assert got["clap_embeddings"].dtype == torch.float32
        np.testing.assert_array_equal(got["clap_embeddings"].numpy(), want)
    ctx = {"text_prompts": ["x"], "clap_embeddings": 0}
    assert FrozenCLAPTextEmbedder()(ctx) is ctx
    embedder = FrozenCLAPTextEmbedder()
    assert embedder._load(embedder.version) is None
    assert embedder._embed_real(prompts) is None
    want = np.asarray(JaxCLAP()({"text_prompts": prompts})["clap_embeddings"])
    np.testing.assert_array_equal(embedder({"text_prompts": prompts})["clap_embeddings"].numpy(),
                                  want)


def test_clap_guidance_drop_changes_nothing_as_in_jax():
    """The config's guidance signal is `clap_embeddings`, and its
    unconditional adapter (UnconditionalTextPromptsAdapter) blanks prompts
    and zeroes token and text embeddings, not CLAP's: in both packages the
    unconditional context keeps the conditional CLAP embeddings, so the
    training drop and guided sampling change nothing (ROADMAP queue 3)."""
    from xdiffusion_tpu.context import UnconditionalTextPromptsAdapter as JaxAdapter

    from xdiffusion_tpu_torch.context import UnconditionalTextPromptsAdapter

    emb = np.random.default_rng(0).standard_normal((2, 1024)).astype(np.float32)
    want = JaxAdapter()({"clap_embeddings": jnp.asarray(emb), "text_prompts": PROMPTS})
    got = UnconditionalTextPromptsAdapter()({"clap_embeddings": torch.from_numpy(emb),
                                             "text_prompts": PROMPTS})
    assert got["text_prompts"] == want["text_prompts"] == ["", ""]
    np.testing.assert_array_equal(got["clap_embeddings"].numpy(), emb)
    np.testing.assert_array_equal(np.asarray(want["clap_embeddings"]), emb)


# ---- the audio diffusion config --------------------------------------------------------


def tiny_audio(num_scales: int = 1024) -> dict:
    """The config at num_features 32 (the timestep embedding 128 wide, so
    the CLAP projection too) and one residual block a level, with
    `num_scales` logSNR scales; attention at 16x16 as shipped."""
    with open(CLAP) as f:
        cfg = yaml.safe_load(f)
    diff = cfg["diffusion"]
    diff["noise_scheduler"]["params"]["num_scales"] = num_scales
    sn = diff["score_network"]["params"]
    sn.update(num_features=32, num_resnet_blocks=1)
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    sn["conditioning"]["context_transformer_head"][1]["params"].update(
        hidden_features=128, out_features=128)
    return cfg


@pytest.fixture(scope="module")
def audio_pair():
    JaxCLAPLoaded = __import__("xdiffusion_tpu.layers.clap", fromlist=["x"]).FrozenCLAPTextEmbedder
    JaxCLAPLoaded._loaded.setdefault("laion/clap-htsat-unfused", None)
    return video_pair(tiny_audio())


def _contexts(pair, t):
    jmodel, _, pmodel = pair
    jctx = {k: v for k, v in jmodel.preprocess_context({"text_prompts": PROMPTS}).items()
            if hasattr(v, "shape")}
    pctx = {k: v for k, v in pmodel.preprocess_context({"text_prompts": PROMPTS}).items()
            if hasattr(v, "shape")}
    jctx.update(timestep=jnp.asarray(t), logsnr_t=jmodel.noise_scheduler().logsnr(jnp.asarray(t)))
    pctx.update(timestep=torch.from_numpy(t),
                logsnr_t=pmodel.noise_scheduler().logsnr(torch.from_numpy(t)))
    return jctx, pctx


def test_audio_forward_matches_jax(audio_pair):
    """The UNet's prediction with the CLAP embeddings projected into the
    timestep embedding: fp32 2e-5 of the output's scale. Its attention is
    self-attention only (the config's context_dim -1): the CLAP vector
    reaches no cross-attention."""
    jmodel, params, pmodel = audio_pair
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 1)).astype(np.float32)
    jctx, pctx = _contexts(audio_pair, np.float32([0.3, 0.8]))
    want = np.asarray(jax.jit(jmodel.predict_score)(params, jnp.asarray(x), jctx))
    with torch.inference_mode():
        got = pmodel.predict_score(torch.from_numpy(x), pctx).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * max(1.0, np.abs(want).max()), rtol=0)
    names = [n for n, _ in pmodel.score_network().named_modules()]
    assert not any(n.endswith("encoder_kv") for n in names)
    assert any("_context_heads_" in n for n in names)
    other = dict(pctx, clap_embeddings=torch.flip(pctx["clap_embeddings"], [0]))
    with torch.inference_mode():
        moved = pmodel.predict_score(torch.from_numpy(x), other).numpy()
    assert np.abs(moved - got).max() > 1e-4  # the prompt reaches the output


def test_audio_loss_and_every_gradient_match_jax(audio_pair):
    """The continuous v loss with the prompts' CLAP embeddings at injected
    times and noise (dropout off, no guidance drop)."""
    images = np.random.default_rng(3).random((2, 32, 32, 1)).astype(np.float32)
    check_loss_and_gradients(audio_pair, images, {})


def test_audio_guided_trajectory_matches_jax(audio_pair):
    """10 ancestral steps of the config's sampler with the prompts, its
    guidance and injected noise: 1e-3 on samples in [0, 1]."""
    jmodel, params, pmodel = audio_pair
    rng = np.random.default_rng(1)
    init = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    noise = rng.standard_normal((10, 2, 32, 32, 1)).astype(np.float32)
    guidance = pmodel.classifier_free_guidance() or None
    want = np.asarray(jmodel.sample(
        params, jax.random.PRNGKey(0), num_samples=2, num_sampling_steps=10,
        initial_noise=jnp.asarray(init), classifier_free_guidance=guidance,
        context={"text_prompts": PROMPTS, "sampling_noise": jnp.asarray(noise)}))
    got = pmodel.sample(num_samples=2, num_sampling_steps=10, initial_noise=torch.from_numpy(init),
                        classifier_free_guidance=guidance,
                        context={"text_prompts": PROMPTS, "sampling_noise": torch.from_numpy(noise)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_audio_config_builds_at_full_width_with_jax_parameter_count():
    __import__("xdiffusion_tpu.layers.clap", fromlist=["x"]).FrozenCLAPTextEmbedder._loaded \
        .setdefault("laion/clap-htsat-unfused", None)
    check_full_width(CLAP)


# ---- the CLIs -------------------------------------------------------------------------


def test_audio_training_and_sampling_clis(tmp_path, monkeypatch):
    """The tiny audio config (8 logSNR scales) through the audio training
    CLI on the synthetic UrbanSound8k (2 steps at batch 4, the class names
    as prompts), then `sample_audio` on its checkpoint: 3 samples, a mel
    grid, a 16-bit 22,050 Hz WAV each (32 frames: 8192 samples), one JSON
    line."""
    from xdiffusion_tpu_torch import sample_audio, train_audio

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = tmp_path / "clap_tiny.yaml"
    config.write_text(yaml.safe_dump(tiny_audio(num_scales=8)))
    run = train_audio.main(["--config_path", str(config), "--batch_size", "4",
                            "--num_training_steps", "2", "--num_samples", "4",
                            "--device", "cpu", "--output_path", str(tmp_path / "run")])
    assert run.endswith(os.path.join("audio_urbansound8k", "clap_tiny"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1] and all(np.isfinite(r["loss"]) for r in records)
    out = tmp_path / "wavs"
    result = sample_audio.main(["--config_path", str(config), "--checkpoint",
                                os.path.join(run, "checkpoints", "2.pt"), "--num_samples", "3",
                                "--device", "cpu", "--output_path", str(out)])
    assert result["num_samples"] == 3 and result["checkpoint_step"] == 2
    assert result["samples_per_sec"] > 0
    names = sorted(os.listdir(out))
    assert names == ["mel_grid.png", "sample-0-air_conditioner.wav", "sample-1-car_horn.wav",
                     "sample-2-children_playing.wav"]
    with wave.open(str(out / names[1])) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()) == (
            1, 2, 22050, 8192)


def test_audio_autoencoder_cli_trains_on_mel_rectangles(tmp_path, monkeypatch):
    """The audio autoencoder CLI defaults to `audio/urbansound8k`: a tiny KL
    VAE over 16x32 log-mel rectangles (data.image_size [16, 32]), one step
    at batch 2, its reconstruction grid written."""
    from test_torch_port_vae import tiny_kl_config

    from xdiffusion_tpu_torch import train_audio_autoencoder

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    vae = tiny_kl_config(attn_resolutions=())
    vae["params"]["encoder_decoder_config"]["resolution"] = [16, 32]
    config = tmp_path / "audio_vae.yaml"
    config.write_text(yaml.safe_dump({"autoencoder": vae,
                                      "data": {"image_size": [16, 32], "num_channels": 1}}))
    run = train_audio_autoencoder.main(["--config_path", str(config), "--batch_size", "2",
                                        "--num_training_steps", "1", "--device", "cpu",
                                        "--output_path", str(tmp_path / "vae")])
    assert run.endswith(os.path.join("audio_urbansound8k", "audio_vae"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert all(np.isfinite(json.loads(line)["loss_ae"]) for line in f)
    assert any(name.startswith("reconstruction-") for name in os.listdir(run))
