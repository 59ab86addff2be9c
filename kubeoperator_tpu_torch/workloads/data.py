"""Input pipeline of the port: host numpy batches to device tensors, with
prefetch. The port's own copy of what its jobs need from
``kubeoperator_tpu/workloads/data.py``: the synthetic image stream, the
``.npy`` dataset, and the prefetch to the device.

Sources are plain iterators of host numpy batches; ``prefetch_to_device``
keeps ``depth`` batches ahead of the consumer, each copied from pinned host
memory without blocking the host (the role ``jax.device_put``'s asynchrony
plays in the JAX package). What runs ahead is the host's part: making the
batch, pinning it and enqueueing its copy. The copies go on the current
stream, so on the device each one runs between the steps' kernels, not
beside them.
"""

from __future__ import annotations

import collections
import os
from typing import Any, Iterable, Iterator

import numpy as np
import torch


def synthetic_image_batches(batch: int, image_size: int, num_classes: int,
                            seed: int = 0, dtype: Any = np.float32,
                            steps: int | None = None,
                            start: int = 0) -> Iterator[tuple]:
    """Deterministic fake ImageNet-shaped stream of (images [B, S, S, 3],
    int32 labels [B]). Step N's batch is keyed by ``(seed, N)``, so a
    resumed run passing ``start=N`` continues the stream, and the same
    seed gives the JAX package's arrays."""
    i = start
    while steps is None or i < start + steps:
        rng = np.random.default_rng((seed, i))
        images = rng.standard_normal((batch, image_size, image_size, 3),
                                     dtype=np.float32).astype(dtype)
        labels = rng.integers(0, num_classes, (batch,), dtype=np.int32)
        yield images, labels
        i += 1


class NpyDataset:
    """Memmapped ``.npy`` pair (``images.npy`` + ``labels.npy``) with
    shuffled epochs, as the JAX package reads it."""

    def __init__(self, directory: str, images: str = "images.npy",
                 labels: str = "labels.npy"):
        self.images = np.load(os.path.join(directory, images), mmap_mode="r")
        self.labels = np.load(os.path.join(directory, labels), mmap_mode="r")
        if len(self.images) != len(self.labels):
            raise ValueError(f"images ({len(self.images)}) and labels "
                             f"({len(self.labels)}) disagree")

    def __len__(self) -> int:
        return len(self.images)

    def batches(self, batch: int, seed: int = 0, epochs: int | None = None,
                shard_id: int = 0, num_shards: int = 1,
                skip_batches: int = 0) -> Iterator[tuple]:
        """Shuffled epochs of (images, labels); incomplete trailing batches
        are dropped. Every shard passes the same seed with its own
        ``shard_id``: all share one permutation per epoch and take disjoint
        strided slices of it, truncated to one length. ``skip_batches``
        fast-forwards the stream (the shuffle is position-derived)."""
        n = len(self)
        shard_len = n // num_shards
        if batch > shard_len:
            raise ValueError(
                f"batch {batch} exceeds shard size {shard_len} "
                f"({n} samples / {num_shards} shards) — the loader would "
                "never yield")
        per_epoch = shard_len // batch
        epoch = skip_batches // per_epoch
        offset = skip_batches % per_epoch
        while epochs is None or epoch < epochs:
            order = np.random.default_rng(seed + epoch).permutation(n)
            shard = order[shard_id::num_shards][:shard_len]
            for b_i in range(offset, per_epoch):
                idx = np.sort(shard[b_i * batch:(b_i + 1) * batch])
                yield (np.asarray(self.images[idx]),
                       np.asarray(self.labels[idx]))
            offset = 0
            epoch += 1


def to_device(batch: Any, device: torch.device) -> Any:
    """A host batch (an array, or a tuple or list of arrays) as tensors on
    ``device``. For a card the host tensor is pinned and the copy does not
    block: it is ordered on the current stream before any later kernel."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(x, device) for x in batch)
    x = torch.from_numpy(np.asarray(batch))
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(batches: Iterable, device: str | torch.device,
                       depth: int = 2) -> Iterator:
    """Keep ``depth`` batches enqueued for ``device`` ahead of the
    consumer: batch N+1 is made, pinned and its copy enqueued before batch
    N is handed out, so the host does that work while the device still
    runs earlier steps. The copy itself is ordered on the current stream
    with the steps' kernels (see ``to_device``)."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    device = torch.device(device)
    queue: collections.deque = collections.deque()
    it = iter(batches)
    for batch in it:
        queue.append(to_device(batch, device))
        if len(queue) >= depth:
            break
    while queue:
        out = queue.popleft()
        for batch in it:
            queue.append(to_device(batch, device))
            break
        yield out
