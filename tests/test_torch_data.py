"""The port's input pipeline: the synthetic image stream and the ``.npy``
dataset equal the JAX package's for the same seed, and
``prefetch_to_device`` hands over every batch, in order, as tensors on the
device, however deep it prefetches."""

import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import data as jdata
from kubeoperator_tpu_torch.workloads import data as tdata

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,start", [(0, 0), (3, 5)])
def test_synthetic_images_equal_jax(seed, start):
    args = dict(batch=2, image_size=8, num_classes=10, seed=seed, steps=3,
                start=start)
    got = list(tdata.synthetic_image_batches(**args))
    want = list(jdata.synthetic_image_batches(**args))
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == np.float32 and gy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_synthetic_stream_resumes_where_it_left_off():
    full = list(tdata.synthetic_image_batches(2, 4, 5, seed=1, steps=4))
    tail = list(tdata.synthetic_image_batches(2, 4, 5, seed=1, steps=2,
                                              start=2))
    for (a, b), (c, d) in zip(full[2:], tail):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("depth,n", [(1, 3), (2, 5), (4, 2)])
def test_prefetch_yields_every_batch_in_order(depth, n):
    source = list(tdata.synthetic_image_batches(3, 4, 7, seed=2, steps=n))
    out = list(tdata.prefetch_to_device(iter(source), "cpu", depth=depth))
    assert len(out) == n
    for (x, y), (wx, wy) in zip(out, source):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)


def test_prefetch_reads_ahead_by_depth():
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield np.full(2, i)

    stream = tdata.prefetch_to_device(source(), "cpu", depth=3)
    first = next(stream)
    assert first.tolist() == [0, 0] and pulled == [0, 1, 2, 3]


def test_prefetch_refuses_depth_zero():
    with pytest.raises(ValueError, match="depth"):
        next(tdata.prefetch_to_device(iter([np.zeros(1)]), "cpu", depth=0))


@pytest.fixture
def npy_dir(tmp_path):
    rng = np.random.default_rng(7)
    np.save(tmp_path / "images.npy",
            rng.integers(0, 255, (23, 4, 4, 3), dtype=np.uint8))
    np.save(tmp_path / "labels.npy", rng.integers(0, 10, 23, dtype=np.int32))
    return str(tmp_path)


@pytest.mark.parametrize("kw", [
    dict(batch=4, seed=0, epochs=2),
    dict(batch=3, seed=5, epochs=1, shard_id=1, num_shards=2),
    dict(batch=5, seed=2, epochs=3, skip_batches=6)])
def test_npy_dataset_batches_equal_jax(npy_dir, kw):
    got = list(tdata.NpyDataset(npy_dir).batches(**kw))
    want = list(jdata.NpyDataset(npy_dir).batches(**kw))
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_npy_dataset_refuses_bad_inputs(npy_dir, tmp_path):
    with pytest.raises(ValueError, match="never yield"):
        next(tdata.NpyDataset(npy_dir).batches(30))
    np.save(tmp_path / "labels.npy", np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="disagree"):
        tdata.NpyDataset(str(tmp_path))
