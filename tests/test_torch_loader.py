"""The port's ``PrefetchLoader`` (``stepth_tpu_torch.core.loader``): the five
cases of ``tests/test_loader.py`` (order, overlap, errors, empty, image
pairs), the bounded look-ahead under contention, and the copies to a
device."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from stepth_tpu.core import io as ref_io
from stepth_tpu_torch.core import io
from stepth_tpu_torch.core.loader import PrefetchLoader, image_pair_loader

from tests.torch_port import cuda, np_, one_torch_thread  # noqa: F401 (fixtures)


def test_order_preserved():
    items = list(range(50))
    out = list(PrefetchLoader(items, lambda x: x * 2, num_threads=4, buffer=4))
    assert out == [x * 2 for x in items]


def test_overlaps_slow_producer():
    def slow(x):
        time.sleep(0.02)
        return x

    items = list(range(16))
    t0 = time.perf_counter()
    out = list(PrefetchLoader(items, slow, num_threads=8, buffer=16))
    dt = time.perf_counter() - t0
    assert out == items
    assert dt < 0.02 * 16  # faster than serial


def test_error_propagates():
    def boom(x):
        if x == 3:
            raise ValueError("boom")
        return x

    with pytest.raises(ValueError, match="boom"):
        list(PrefetchLoader(list(range(8)), boom, num_threads=2, buffer=2))


def test_empty():
    assert list(PrefetchLoader([], lambda x: x)) == []


@pytest.mark.parametrize("device", [None, "cpu"])
def test_image_pair_loader(tmp_path, device):
    rng = np.random.default_rng(0)
    paths, images = [], []
    for i in range(3):
        img = rng.integers(0, 255, (8, 10, 3), dtype=np.uint8)
        p = str(tmp_path / f"im{i}.png")
        io.save(p, img)
        paths.append((p, p))
        images.append(img)
    batches = list(image_pair_loader(paths, num_threads=2, device=device))
    assert len(batches) == 3
    for batch, img, (p, _) in zip(batches, images, paths):
        assert batch["left"].shape == (8, 10, 3)
        if device is None:
            assert isinstance(batch["left"], np.ndarray)
        else:
            assert batch["left"].device == torch.device(device)
        np.testing.assert_array_equal(np_(batch["right"]), img)
        np.testing.assert_array_equal(np_(batch["left"]), ref_io.open_rgb(p))


def test_look_ahead_bounded_under_contention():
    """More workers than cores and a short switch interval: the order holds,
    no index is taken more than ``buffer`` past the consumer, and every
    worker exits."""
    n, buffer = 400, 3
    lock = threading.Lock()
    consumed = [0]
    over = []

    def fn(i):
        with lock:
            # the item being handed over counts as consumed: + 1
            if i >= consumed[0] + 1 + buffer:
                over.append(i)
        return {"i": i, "a": np.full(2, i)}

    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = []
        for item in PrefetchLoader(range(n), fn, num_threads=16, buffer=buffer, device="cpu"):
            out.append(int(item["a"][0]))
            with lock:
                consumed[0] += 1
    finally:
        sys.setswitchinterval(interval)
    assert out == list(range(n)) and not over
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_stopping_early_releases_workers():
    before = threading.active_count()
    it = iter(PrefetchLoader(range(100), lambda x: x, num_threads=4, buffer=2))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() == before


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA"):
        PrefetchLoader([1], lambda x: x, device="cuda")


@pytest.mark.cuda
def test_copies_to_card_are_done_before_use(cuda, tmp_path):
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (540, 960, 3), dtype=np.uint8) for _ in range(6)]
    out = list(PrefetchLoader(range(6), lambda i: (frames[i], {"k": frames[i][..., 0]}),
                              num_threads=3, buffer=2, device=cuda))
    for (img, d), want in zip(out, frames):
        assert img.is_cuda and d["k"].is_cuda
        # read on the consumer's stream with no synchronize in between
        assert int((img.to(torch.int32) - torch.as_tensor(want, device=cuda)).abs().sum()) == 0
        np.testing.assert_array_equal(np_(d["k"]), want[..., 0])
