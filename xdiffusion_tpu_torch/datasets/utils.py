"""Dataset registry and the host batch pipeline.

Counterpart of xdiffusion_tpu/datasets/utils.py for the datasets the port
trains on (MNIST and its inverse, MNIST with Gemma-2 prompt embeddings,
moving-MNIST clips and their first frames, Moving-MNIST-256, CIFAR-10 or its
synthetic stand-in, UrbanSound8k's log-mels or their synthetic stand-in): `load_dataset` returns
(dataset, convert_labels_to_prompts); the
batch iterator is the host half of the input pipeline, epoch-shuffled numpy
batching with drop-remainder over images or videos, and `prefetch` overlaps
it with the device step. The JAX package gathers through its native batch
assembler; the port gathers with numpy, which gives the same float32 values.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np


def load_dataset(dataset_name: str, config=None, split: str = "train"):
    """Returns (dataset, convert_labels_to_prompts)."""
    image_size = 32
    if config is not None and "data" in config:
        image_size = config.data.image_size

    from xdiffusion_tpu_torch.datasets import mnist

    if dataset_name in ("image/mnist", "mnist"):
        return (mnist.MNIST(split=split, image_size=image_size),
                mnist.convert_labels_to_prompts)
    if dataset_name == "image/mnist_inverted":
        return (mnist.MNIST(split=split, image_size=image_size, invert=True),
                mnist.convert_labels_to_prompts)
    if dataset_name == "video/moving_mnist":
        from xdiffusion_tpu_torch.datasets import moving_mnist

        return (moving_mnist.MovingMNIST(split=split, image_size=image_size),
                moving_mnist.convert_labels_to_prompts)
    if dataset_name == "video/moving_mnist_256":
        from xdiffusion_tpu_torch.datasets import moving_mnist_256

        return (moving_mnist_256.MovingMNIST256(split=split, image_size=image_size),
                moving_mnist_256.convert_labels_to_prompts)
    if dataset_name in ("image/moving_mnist", "image/moving_mnist_inverted"):
        # The image view of moving-MNIST: the first frame of each clip.
        from xdiffusion_tpu_torch.datasets import moving_mnist

        clips = moving_mnist.MovingMNIST(split=split, image_size=image_size)
        frames = clips.videos[:, 0]  # (N, S, S, 1) uint8
        if dataset_name.endswith("inverted"):
            frames = 255 - frames
        return (_image_dataset(frames, clips.labels[:, 0], clips.synthetic),
                mnist.convert_labels_to_prompts)
    if dataset_name == "image/cifar10":
        return cifar10(split, image_size), cifar10_prompts
    if dataset_name in ("audio/urbansound8k", "urbansound8k"):
        from xdiffusion_tpu_torch.datasets import urbansound8k

        return (urbansound8k.UrbanSound8k(split=split, image_size=image_size),
                urbansound8k.convert_labels_to_prompts)
    if dataset_name == "image/mnist_embedded_gemma_2":
        from xdiffusion_tpu_torch.datasets import mnist_embedded_gemma_2 as gemma

        return (gemma.MNISTEmbeddedGemma2(split=split, image_size=image_size),
                gemma.convert_labels_to_prompts)
    raise NotImplementedError(f"Dataset {dataset_name!r} is not ported yet.")


def _image_dataset(images: np.ndarray, labels: np.ndarray, synthetic: bool):
    """An in-memory image dataset (the MNIST class's interface) over
    uint8 (N, S, S, C) images and their labels."""
    from xdiffusion_tpu_torch.datasets.mnist import MNIST

    ds = MNIST.__new__(MNIST)
    ds.images, ds.labels, ds.synthetic = images, labels, synthetic
    return ds


_CIFAR_CLASSES = [
    ["airplane", "plane"],
    ["automobile", "car"],
    ["bird", "bird"],
    ["cat", "cat"],
    ["deer", "deer"],
    ["dog", "dog"],
    ["frog", "frog"],
    ["horse", "horse"],
    ["ship", "ship"],
    ["truck", "truck"],
]


def cifar10_prompts(labels, rng: Optional[np.random.Generator] = None) -> List[str]:
    """A class name per label, one of two surface forms drawn from `rng`
    ("automobile" or "car"). The trainer passes
    np.random.default_rng((seed, step)), so a resumed run repeats the
    prompts; the JAX package draws them unseeded."""
    rng = rng or np.random.default_rng()
    picks = rng.integers(0, 2, size=len(labels))
    return [_CIFAR_CLASSES[int(l)][int(p)] for l, p in zip(labels, picks)]


def cifar10(split: str, image_size: int):
    """CIFAR-10 from the pickled batches under the data root
    (`cifar-10-batches-py/`) when they are there, else the JAX package's
    synthetic RGB stand-in: the synthetic digits at seed 2 (train, 10,000)
    or 3 (test, 1,000), each tinted by a colour from default_rng(4). Both
    are resized bilinearly when `image_size` is not 32."""
    import pickle

    from xdiffusion_tpu_torch.datasets.mnist import _resize_bilinear, data_root

    base = os.path.join(data_root(), "cifar-10-batches-py")
    if os.path.isdir(base):
        files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
        images, labels = [], []
        for name in files:
            with open(os.path.join(base, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.append(np.asarray(d[b"labels"], dtype=np.int32))
        ds = _image_dataset(np.concatenate(images), np.concatenate(labels), False)
    else:
        from xdiffusion_tpu_torch.datasets.synthetic import generate_digits

        grey, labels = generate_digits(10000 if split == "train" else 1000,
                                       seed=2 if split == "train" else 3, image_size=32)
        colors = np.random.default_rng(4).uniform(0.4, 1.0, size=(grey.shape[0], 1, 1, 3))
        ds = _image_dataset((grey.astype(np.float32) * colors).astype(np.uint8), labels, True)
    if image_size != 32:
        ds.images = _resize_bilinear(ds.images, image_size)
    ds.num_classes = 10
    return ds


def prefetch(iterator, depth: int = 2):
    """Background-thread prefetch: host batch assembly overlaps the device
    step. The thread fills a bounded queue; numpy's gather runs with the GIL
    released."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def fill():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surface producer errors to the consumer
            q.put(e)

    t = threading.Thread(target=fill, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return gen()


def batch_iterator(dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                   skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite epoch-shuffled iterator of static-shape numpy batches:
    images float32 (B, S, S, C) = uint8 * float32(1 / 255), classes int32,
    both gathered by the native batch assembler (native/);
    for a video dataset (one with `videos`), videos float32 (B, F, S, S, C)
    under "videos" instead of "images", and its per-video digit labels as
    classes.

    `skip` drops that many batches first without gathering them, so a
    resumed run continues the stream where the interrupted one stopped."""
    from xdiffusion_tpu_torch.native import gather_i32, gather_normalize

    n = len(dataset)
    if batch_size > n:
        raise ValueError(f"batch {batch_size} > dataset {n}")
    rng = np.random.default_rng(seed)
    key = "videos" if hasattr(dataset, "videos") else "images"
    data = np.ascontiguousarray(getattr(dataset, key))  # uint8
    labels = np.ascontiguousarray(dataset.labels)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            if skip > 0:
                skip -= 1
                continue
            idx = order[start:start + batch_size]
            yield {key: gather_normalize(data, idx), "classes": gather_i32(labels, idx)}
