"""The LeNet-feature FID and the image datasets in the port against the JAX
package on the CPU: the classifier's features on carried weights (its
'SAME' padding and NHWC flatten), the Frechet distance and compute_fid with
a shared extractor, a trained extractor's real-against-real floor and its
FID against noise; the moving-MNIST first frames (and their inverse), the
synthetic CIFAR-10 stand-in and its seeded prompts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from flax import traverse_util

from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params


def _shared_classifier(size: int, channels: int = 1, seed: int = 1):
    """(flax module, flax params, port classifier) on the same seeded
    weights for (size, size, channels) images."""
    from xdiffusion_tpu.eval.fid import FeatureClassifier as JaxClassifier

    from xdiffusion_tpu_torch.eval.fid import FeatureClassifier

    jmod = JaxClassifier()
    init = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, channels)))
    flat = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(init["params"]).items()}
    drawn = random_flax_params(flat, seed)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in drawn.items()})}
    port = FeatureClassifier(channels, size)
    load_flax_params(port, drawn)
    return jmod, params, port.eval()


@pytest.mark.parametrize("size,channels", [(32, 1), (28, 1), (32, 3)])
def test_classifier_features_and_logits_match_flax(size, channels):
    """At 32 (maps 16, 8, 4: every stride-2 conv pads 0 before and 1 after,
    where PyTorch's padding=1 would pad both sides), at 28 (14, 7, 4: the
    last conv pads 1 and 1) and on RGB: features and logits to 1e-5."""
    jmod, params, port = _shared_classifier(size, channels)
    x = np.random.default_rng(size).random((6, size, size, channels)).astype(np.float32)
    assert port.features.in_features == 128 * 4 * 4
    for return_features in (True, False):
        want = np.asarray(jax.jit(functools.partial(jmod.apply, return_features=return_features))(
            params, jnp.asarray(x)))
        with torch.no_grad():
            got = port(torch.from_numpy(x), return_features=return_features)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _digits(n: int, seed: int):
    from xdiffusion_tpu_torch.datasets.synthetic import generate_digits

    images, labels = generate_digits(n, seed=seed, image_size=32)
    return images.astype(np.float32) / 255.0, labels


def test_frechet_distance_and_compute_fid_match_jax():
    """frechet_distance on the same features equals JAX's (the same float64
    numpy and scipy); compute_fid with the carried extractor on digits
    against digits and against noise, to 1e-6 relative beside the
    features' fp32 rounding."""
    from xdiffusion_tpu.eval import fid as jfid

    from xdiffusion_tpu_torch.eval import fid

    rng = np.random.default_rng(0)
    a = rng.standard_normal((200, 64)).astype(np.float32)
    b = (1.3 * rng.standard_normal((150, 64)) + 0.2).astype(np.float32)
    assert fid.frechet_distance(a, b) == jfid.frechet_distance(a, b)
    jmod, params, port = _shared_classifier(32)
    real, _ = _digits(256, 0)
    other, _ = _digits(256, 9)
    noise = rng.random(real.shape).astype(np.float32)
    for generated in (other, noise):
        want = jfid.compute_fid(real, generated, extractor=(jmod, params))
        got = fid.compute_fid(real, generated, extractor=port)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fid.extract_features(port, real[:70], batch_size=32),
                               np.asarray(jmod.apply(params, jnp.asarray(real[:70]),
                                                     return_features=True)), atol=1e-5, rtol=1e-5)


def test_trained_extractor_floor_and_noise():
    """As tests/test_sd3.py holds the JAX harness: 200 Adam steps on 512
    synthetic digits learn them (loss under 1.5); digits against other
    digits give an FID near 0, against noise more than 5x that."""
    from xdiffusion_tpu_torch.eval.fid import compute_fid, train_feature_extractor

    imgs, labels = _digits(512, 0)
    imgs2, _ = _digits(512, 9)
    noise = np.random.default_rng(0).uniform(size=imgs.shape).astype(np.float32)
    model, loss = train_feature_extractor(imgs, labels, steps=200, device="cpu")
    assert loss < 1.5
    assert next(model.parameters()).device.type == "cpu"
    fid_same = compute_fid(imgs, imgs2, extractor=model)
    fid_noise = compute_fid(imgs, noise, extractor=model)
    assert fid_same >= 0
    assert fid_noise > 5 * max(fid_same, 1e-3)
    again, _ = train_feature_extractor(imgs, labels, steps=3, device="cpu")
    first, _ = train_feature_extractor(imgs, labels, steps=3, device="cpu")
    for p, q in zip(again.parameters(), first.parameters()):
        assert torch.equal(p, q)  # seeded: the same weights each time


# ---- datasets -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["image/moving_mnist", "image/moving_mnist_inverted"])
def test_moving_mnist_frames_equal_jax(name):
    """The first frame of each synthetic clip (inverted: 255 - x, uint8) and
    its first digit's label, bit for bit."""
    from xdiffusion_tpu.datasets.utils import load_dataset as jax_load

    from xdiffusion_tpu_torch.datasets.utils import load_dataset

    want, want_prompts = jax_load(name, split="test")
    got, got_prompts = load_dataset(name, split="test")
    assert got.synthetic and want.synthetic
    assert got.images.dtype == np.uint8 and got.images.shape == want.images.shape
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got) == len(want.images) and got_prompts.__name__ == want_prompts.__name__


@pytest.mark.parametrize("split,image_size", [("train", 32), ("test", 32), ("test", 16)])
def test_synthetic_cifar10_equals_jax(split, image_size):
    """The RGB stand-in (digits at seed 2 or 3 tinted from default_rng(4)):
    at the configs' size 32 images and labels bit for bit. Resized to 16
    the port's bilinear downscale (numpy einsum over the jax.image.resize
    weights) sums its four taps in another order than XLA's dot, so a value
    next to an integer may truncate to the level below or above: at most
    one level, on at most 1e-5 of the values."""
    from xdiffusion_tpu.config import DotConfig
    from xdiffusion_tpu.datasets.utils import load_dataset as jax_load

    from xdiffusion_tpu_torch.datasets.utils import load_dataset

    config = DotConfig({"data": {"image_size": image_size}})
    want, _ = jax_load("image/cifar10", config=config, split=split)
    got, _ = load_dataset("image/cifar10", config=config, split=split)
    assert got.synthetic and got.num_classes == 10
    assert got.images.shape == (10000 if split == "train" else 1000, image_size, image_size, 3)
    np.testing.assert_array_equal(got.labels, want.labels)
    if image_size == 32:
        np.testing.assert_array_equal(got.images, want.images)
    else:
        diff = np.abs(got.images.astype(np.int16) - want.images)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5


def test_cifar10_prompts_are_seeded_by_the_rng():
    """Drawn from the rng the trainer seeds with (seed, step): the same
    prompts for the same seed, one of the label's two surface forms."""
    from xdiffusion_tpu.datasets.utils import _CIFAR_CLASSES

    from xdiffusion_tpu_torch.datasets.utils import cifar10_prompts

    labels = np.arange(40) % 10
    first = cifar10_prompts(labels, rng=np.random.default_rng((0, 5)))
    assert first == cifar10_prompts(labels, rng=np.random.default_rng((0, 5)))
    assert first != cifar10_prompts(labels, rng=np.random.default_rng((0, 6)))
    assert all(p in _CIFAR_CLASSES[l] for p, l in zip(first, labels))
    assert len(cifar10_prompts(labels[:3])) == 3  # unseeded, as in JAX
