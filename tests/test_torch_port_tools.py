"""The port's evaluation and data CLIs against the JAX package's tools on the
CPU: measure_fid and measure_video_fid (with the samples and the LeNet
extractor shared, their JSON lines and their refusal of the synthetic
stand-in), the port's own seeded sampling in measure_fid, create_moving_mnist
and create_mel_spec into two data roots, and the perceptual-filter trainer
and its CLI."""

import hashlib
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name, argv, monkeypatch, capsys):
    """(exit code, last stdout line as JSON) of tools/<name>.py."""
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    code = 0
    try:
        runpy.run_path(os.path.join(REPO, "tools", name + ".py"), run_name="__main__")
    except SystemExit as e:
        code = e.code
    return code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_tool(module, argv, capsys):
    code = 0
    try:
        module.main(argv + ["--device", "cpu"])
    except SystemExit as e:
        code = e.code
    return code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _share_model_and_extractor(monkeypatch, batches, size, channels=1):
    """Both processes' `sample` hand out `batches` in turn (as JAX arrays or
    torch tensors), both packages' train_feature_extractor return one
    classifier on carried seeded weights, and the JAX tools build and restore
    no network (a zero tree of the init's shapes, the state as it is)."""
    from test_torch_port_fid import _shared_classifier
    from xdiffusion_tpu import checkpoints as jax_checkpoints
    from xdiffusion_tpu.diffusion import ddpm as jax_ddpm
    from xdiffusion_tpu.eval import fid as jax_fid

    from xdiffusion_tpu_torch.diffusion import ddpm
    from xdiffusion_tpu_torch.eval import fid

    jmod, params, port = _shared_classifier(size, channels)
    calls = {"jax": 0, "port": 0}

    def hand_out(side, wrap):
        def sample(self, *args, num_samples=None, **kwargs):
            out = batches[calls[side]]
            calls[side] += 1
            assert out.shape[0] == num_samples
            return wrap(out)

        return sample

    init_params = jax_ddpm.GaussianDiffusion_DDPM.init_params

    def zeros(self, key):
        shapes = jax.eval_shape(lambda k: init_params(self, k), key)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(jax_ddpm.GaussianDiffusion_DDPM, "sample", hand_out("jax", jnp.asarray))
    monkeypatch.setattr(ddpm.GaussianDiffusion_DDPM, "sample",
                        hand_out("port", torch.from_numpy))
    monkeypatch.setattr(jax_ddpm.GaussianDiffusion_DDPM, "init_params", zeros)
    monkeypatch.setattr(jax_checkpoints, "restore_checkpoint", lambda path, state: (state, 0))
    monkeypatch.setattr(jax_fid, "train_feature_extractor",
                        lambda *a, **k: (jmod, params, 0.0))
    monkeypatch.setattr(fid, "train_feature_extractor", lambda *a, **k: (port, 0.0))
    return calls


def _small_datasets(monkeypatch):
    """Both packages' loaders, as the tools call them, build the synthetic
    stand-ins at 1,000 digits (80 videos) instead of 60,000 (2,000): the same
    generators and seeds as at full size, the two packages' sets equal."""
    from xdiffusion_tpu.datasets import mnist as jax_mnist
    from xdiffusion_tpu.datasets import moving_mnist as jax_moving
    from xdiffusion_tpu.datasets import utils as jax_utils

    from xdiffusion_tpu_torch import datasets
    from xdiffusion_tpu_torch.datasets import mnist, moving_mnist

    def loader(images, videos):
        def load(name, config=None, split="train"):
            size = config.data.image_size
            if name == "image/mnist":
                return images(split=split, image_size=size, num_synthetic=1000), None
            assert name == "video/moving_mnist", name
            return videos(split=split, image_size=size, num_videos=80), None

        return load

    monkeypatch.setattr(jax_utils, "load_dataset", loader(jax_mnist.MNIST, jax_moving.MovingMNIST))
    monkeypatch.setattr(datasets, "load_dataset", loader(mnist.MNIST, moving_mnist.MovingMNIST))


def _checkpoint(config_path, tmp_path):
    """A port state dict of the config's score network, seeded."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model
    from xdiffusion_tpu_torch.weights import randomize_

    net = build_model(load_yaml(config_path), device="cpu").score_network()
    randomize_(net, 3)
    path = str(tmp_path / "weights.pt")
    torch.save(net.state_dict(), path)
    return path


def _at_32(path):
    """The config's digits at 32x32, the synthesizer's own size: the two
    packages resize the digits to another size each in its own way."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["image_size"] = 32
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _close_lines(got, want, skip=()):
    """The same keys; each number equal to one unit of its printed rounding."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in skip:
            continue
        if isinstance(w, float):
            assert abs(got[k] - w) <= 1e-3 + 1e-9, (k, got[k], w)
        else:
            assert got[k] == w, k


def test_measure_fid_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    """N = 72 in batches of 36 on the tiny flagship (more samples than the
    64 features: at N = 8 both covariances have rank 7, and the square root
    of their singular product turns the two stacks' 1e-6 feature
    differences into FIDs 1.2 apart): with the samples and the extractor
    shared, the JSON line equals the JAX tool's (each FID to one unit of its
    printed 3 decimals); without --allow-synthetic both print the refusal
    and exit 2."""
    from test_torch_port_train import tiny_config

    from xdiffusion_tpu_torch import measure_fid

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = _at_32(tiny_config(tmp_path / "tiny.yaml"))
    ckpt = _checkpoint(config, tmp_path)
    rng = np.random.default_rng(0)
    batches = [rng.random((36, 32, 32, 1)).astype(np.float32) for _ in range(2)]
    calls = _share_model_and_extractor(monkeypatch, batches, 32)
    _small_datasets(monkeypatch)
    argv = ["--config_path", config, "--checkpoint", ckpt, "--num_samples", "72",
            "--sample_batch", "36", "--sampling_steps", "3", "--allow-synthetic"]
    code, want = _jax_tool("measure_fid", argv, monkeypatch, capsys)
    got_code, got = _port_tool(measure_fid, argv, capsys)
    assert code == got_code == 0 and calls == {"jax": 2, "port": 2}
    assert want["synthetic_data"] is True and np.isfinite(want["fid"])
    _close_lines(got, want)

    calls.update(jax=0, port=0)
    code, want = _jax_tool("measure_fid", argv[:-1], monkeypatch, capsys)
    got_code, got = _port_tool(measure_fid, argv[:-1], capsys)
    assert code == got_code == 2 and got == want and "SYNTHETIC" in got["error"]


def test_measure_fid_samples_with_generators_seeded_seed_plus_i(tmp_path, monkeypatch, capsys):
    """The CLI's own samples (the checkpoint restored, DDIM, 2 steps) are the
    port's sample() of each batch i with a generator seeded seed + i."""
    from test_torch_port_train import tiny_config

    from xdiffusion_tpu_torch import measure_fid
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.eval import fid
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler
    from xdiffusion_tpu_torch.training.image.train import build_model
    from xdiffusion_tpu_torch.weights import load_checkpoint

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = tiny_config(tmp_path / "tiny.yaml")
    ckpt = _checkpoint(config, tmp_path)
    seen = []

    def spy(real, generated, extractor=None, **kwargs):
        seen.append(generated)
        return 1.0

    _small_datasets(monkeypatch)
    monkeypatch.setattr(fid, "compute_fid", spy)
    monkeypatch.setattr(fid, "train_feature_extractor", lambda *a, **k: (None, 0.0))
    _port_tool(measure_fid, ["--config_path", config, "--checkpoint", ckpt, "--num_samples", "3",
                             "--sample_batch", "2", "--sampling_steps", "2", "--seed", "5",
                             "--allow-synthetic"], capsys)
    model = build_model(load_yaml(config), device="cpu")
    load_checkpoint(model.score_network(), ckpt)
    want = np.concatenate([model.sample(
        num_samples=b, num_sampling_steps=2, sampler=DDIMSampler(),
        generator=torch.Generator().manual_seed(5 + i)).numpy() for i, b in enumerate((2, 1))])
    np.testing.assert_array_equal(seen[0], want)


def test_measure_video_fid_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    """4 videos in batches of 2 of the tiny video UNet: with the samples and
    the extractor shared, the JSON line equals the JAX tool's but for the
    wall-clock rate (positive on both); the refusal and exit 2 as the JAX
    tool's."""
    from test_torch_port_video_unet import video_config

    from xdiffusion_tpu_torch import measure_video_fid

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path / "no_data"))
    config = video_config("video_trajectory_parity", tmp_path)
    ckpt = _checkpoint(config, tmp_path)
    rng = np.random.default_rng(1)
    batches = [rng.random((2, 4, 8, 8, 1)).astype(np.float32) for _ in range(2)]
    calls = _share_model_and_extractor(monkeypatch, batches, 8)
    _small_datasets(monkeypatch)
    argv = ["--config_path", config, "--checkpoint", ckpt, "--num_videos", "4",
            "--sample_batch", "2", "--sampling_steps", "3", "--allow-synthetic"]
    code, want = _jax_tool("measure_video_fid", argv, monkeypatch, capsys)
    got_code, got = _port_tool(measure_video_fid, argv, capsys)
    assert code == got_code == 0 and calls == {"jax": 2, "port": 2}
    assert want["frames_per_video"] == 4 and got["vids_per_sec"] > 0
    _close_lines(got, want, skip=("vids_per_sec",))

    code, want = _jax_tool("measure_video_fid", argv[:-1], monkeypatch, capsys)
    got_code, got = _port_tool(measure_video_fid, argv[:-1], capsys)
    assert code == got_code == 2 and got == want and "SYNTHETIC" in got["error"]


# ---- the dataset tools ------------------------------------------------------------


def _run_both(tool, module, argv, tmp_path, monkeypatch, capsys):
    """Runs the JAX tool and the port's with their own data roots under
    tmp_path; returns the two roots."""
    roots = []
    for side in ("jax", "port"):
        root = tmp_path / side
        monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(root))
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [tool + ".py"] + argv)
            runpy.run_path(os.path.join(REPO, "tools", tool + ".py"), run_name="__main__")
        else:
            module.main(argv + ["--device", "cpu"])
        roots.append(root)
    capsys.readouterr()
    return roots


@pytest.mark.parametrize("layout", [[], ["--reference_layout"]], ids=["npz", "reference"])
def test_create_moving_mnist_writes_the_jax_archives(layout, tmp_path, monkeypatch, capsys):
    """Both flag surfaces (the reference tool's --num_images/--frame_size/
    --nums_per_image here), both layouts: the archives equal JAX's bit for
    bit, and the port's moving-MNIST dataset reads the .npz one."""
    from xdiffusion_tpu_torch import create_moving_mnist
    from xdiffusion_tpu_torch.datasets.moving_mnist import MovingMNIST

    argv = ["--num_images", "5", "--frame_size", "16", "--num_frames", "6",
            "--nums_per_image", "2", "--seed", "3"] + layout
    jax_root, port_root = _run_both("create_moving_mnist", create_moving_mnist, argv, tmp_path,
                                    monkeypatch, capsys)
    files = sorted(os.path.relpath(os.path.join(d, f), jax_root)
                   for d, _, fs in os.walk(jax_root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), port_root)
                           for d, _, fs in os.walk(port_root) for f in fs) and files
    for rel in files:
        with np.load(jax_root / rel) as want, np.load(port_root / rel) as got:
            assert sorted(want.files) == sorted(got.files)
            for k in want.files:
                assert want[k].dtype == got[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    if not layout:
        monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(port_root))
        ds = MovingMNIST(split="train", image_size=16)
        assert not ds.synthetic and ds.videos.shape == (5, 6, 16, 16, 1)
        assert ds.labels.shape == (5, 2)


def test_create_mel_spec_writes_the_jax_archive(tmp_path, monkeypatch, capsys):
    """The synthetic clips (no --audio_dir) and a .wav class folder: the
    labels equal JAX's; the log-mels, as the dataset's uint8 levels, within
    one level of JAX's on at most 2e-5 of them (the bound of
    test_urbansound8k_stand_in_matches_jax); the port's dataset reads the
    archive."""
    import wave

    from xdiffusion_tpu_torch import create_mel_spec
    from xdiffusion_tpu_torch.datasets.urbansound8k import UrbanSound8k

    audio = tmp_path / "audio" / "dog_bark"
    audio.mkdir(parents=True)
    for i in range(2):
        pcm = (np.sin(np.arange(11025) * (0.05 + 0.02 * i)) * 20000).astype(np.int16)
        with wave.open(str(audio / f"{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050)
            w.writeframes(pcm.tobytes())
    for extra in ([], ["--audio_dir", str(tmp_path / "audio"), "--split", "val"]):
        argv = ["--num_clips", "24", "--image_size", "32"] + extra
        jax_root, port_root = _run_both("create_mel_spec", create_mel_spec, argv, tmp_path,
                                        monkeypatch, capsys)
        name = "urbansound8k/melspec_%s.npz" % ("val" if extra else "train")
        with np.load(jax_root / name) as want, np.load(port_root / name) as got:
            np.testing.assert_array_equal(got["labels"], want["labels"])
            assert got["mels"].shape == want["mels"].shape and got["mels"].dtype == np.float32
            levels = [(np.clip(m, 0, 1) * 255).astype(np.int32) for m in (got["mels"],
                                                                           want["mels"])]
            diff = np.abs(levels[0] - levels[1])
            assert diff.max() <= 1 and (diff > 0).mean() <= 2e-5
            assert len(got["labels"]) == (2 if extra else 24)
    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(port_root))
    ds = UrbanSound8k(split="train", image_size=32)
    assert not ds.synthetic and len(ds) == 24


# ---- the perceptual filters -------------------------------------------------------


def _asset_digest():
    path = os.path.join(REPO, "xdiffusion_tpu_torch", "autoencoders", "assets",
                        "perceptual_filters.npz")
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_perceptual_filters_train_as_in_jax(tmp_path, monkeypatch, capsys):
    """3 Adam steps at batch 16 on 64 digits of 32x32: the filters within
    1e-5 of JAX's (each moved about 3e-3 from the shared seeded start; Adam
    divides by the root of a squared gradient, so at a gradient near zero
    the two stacks' rounding moves a weight by up to some 3e-6) and the last
    loss to 1e-5 relative. The CLI writes to its --output, the file
    loads back through load_trained_filters, and the shipped asset is
    untouched."""
    from xdiffusion_tpu.autoencoders.perceptual import (
        train_perceptual_filters as jax_train,
    )

    from xdiffusion_tpu_torch import train_perceptual_features
    from xdiffusion_tpu_torch.autoencoders import perceptual
    from xdiffusion_tpu_torch.datasets.synthetic import generate_digits

    digest = _asset_digest()
    images, labels = generate_digits(64, seed=4, image_size=32)
    images = images.astype(np.float32) / 255.0
    want, want_loss = jax_train(images, labels, steps=3, batch_size=16, seed=2)
    got, got_loss = perceptual.train_perceptual_filters(images, labels, steps=3, batch_size=16,
                                                        seed=2, device="cpu")
    start = perceptual._seeded_filters(3)
    for (gw, gb), (ww, wb), (sw, _) in zip(got, want, start):
        assert np.abs(ww - sw).max() > 1e-3
        np.testing.assert_allclose(gw, ww, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gb, wb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)

    out = tmp_path / "perceptual" / "filters.npz"
    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path))
    info = train_perceptual_features.main(["--num_images", "64", "--steps", "2",
                                           "--output", str(out), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == info and info["output"] == str(out) and info["steps"] == 2
    assert info["num_images"] == 64 and info["synthetic_data"] is True
    monkeypatch.setattr(perceptual, "_TRAINED_CACHE", {})
    loaded = perceptual.load_trained_filters(3)
    with np.load(out) as saved:
        for i, (w, b) in enumerate(loaded):
            np.testing.assert_array_equal(w, saved[f"w{i}"])
            np.testing.assert_array_equal(b, saved[f"b{i}"])
    assert _asset_digest() == digest
    assert train_perceptual_features.DEFAULT_OUTPUT == os.path.join(
        REPO, "xdiffusion_tpu_torch", "autoencoders", "assets", "perceptual_filters.npz")
