"""Dataset registry and the host batch pipeline.

Counterpart of xdiffusion_tpu/datasets/utils.py for the datasets the port
trains on: `load_dataset` returns (dataset, convert_labels_to_prompts); the
batch iterator is the host half of the input pipeline, epoch-shuffled numpy
batching with drop-remainder over images or videos, and `prefetch` overlaps
it with the device step. The JAX package gathers through its native batch
assembler; the port gathers with numpy, which gives the same float32 values.
"""

from __future__ import annotations

from typing import Dict, Iterator

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
    raise NotImplementedError(f"Dataset {dataset_name!r} is not ported yet.")


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
    images float32 (B, S, S, C) = uint8 * float32(1 / 255), classes int32;
    for a video dataset (one with `videos`), videos float32 (B, F, S, S, C)
    under "videos" instead of "images", and its per-video digit labels as
    classes.

    `skip` drops that many batches first without gathering them, so a
    resumed run continues the stream where the interrupted one stopped."""
    n = len(dataset)
    if batch_size > n:
        raise ValueError(f"batch {batch_size} > dataset {n}")
    rng = np.random.default_rng(seed)
    key = "videos" if hasattr(dataset, "videos") else "images"
    data = np.ascontiguousarray(getattr(dataset, key))  # uint8
    labels = dataset.labels
    scale = np.float32(1.0 / 255.0)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            if skip > 0:
                skip -= 1
                continue
            idx = order[start:start + batch_size]
            yield {
                key: data[idx].astype(np.float32) * scale,
                "classes": labels[idx].astype(np.int32),
            }
