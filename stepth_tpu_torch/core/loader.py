"""Prefetching host-to-device data loader (twin of
``stepth_tpu/core/loader.py:21-124``).

Decode and I/O run on worker threads while the device computes:
:class:`PrefetchLoader` wraps any indexable source (paths, arrays, frame
indices) with a thread pool and a bounded look-ahead, and yields
``fn(items[i])`` in order. With ``device`` set, each worker turns the array
leaves of its result into tensors there: on a CUDA device it stages them in
pinned host memory and copies them with ``non_blocking=True`` on a stream of
its own, and the consumer's stream waits for that copy (an event) before the
item is yielded, so no tensor is seen before its copy is done.

The consumer counts each item it takes (``loader.takes`` in
``utils.tracing.counters()``) and each take that found the item not yet
made (``loader.starved``), counted when it starts to wait.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from stepth_tpu_torch.utils import tracing


def _map_arrays(fn: Callable, out: Any) -> Any:
    """``fn`` applied to each array or tensor leaf of nested dicts, lists and
    tuples; other leaves are kept."""
    if isinstance(out, dict):
        return {k: _map_arrays(fn, v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_map_arrays(fn, v) for v in out)
    if isinstance(out, (np.ndarray, torch.Tensor)):
        return fn(out)
    return out


class PrefetchLoader:
    """Iterate ``fn(items[i])`` with ``num_threads`` workers taking items up
    to ``buffer`` ahead of the consumer, in order. ``device=None`` yields the
    results as ``fn`` returns them; a device moves their array leaves there
    inside the worker (see the module docstring)."""

    def __init__(
        self,
        items: Sequence[Any],
        fn: Callable[[Any], Any],
        num_threads: int = 4,
        buffer: int = 8,
        device: Optional[torch.device | str] = None,
    ) -> None:
        self.items = list(items)
        self.fn = fn
        self.num_threads = max(1, num_threads)
        self.buffer = max(1, buffer)
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" \
                and not torch.cuda.is_available():
            raise ValueError("device='cuda' asked for, and no CUDA device is available")

    def __len__(self) -> int:
        return len(self.items)

    def _place(self, out: Any, stream: Optional[torch.cuda.Stream]):
        """``out`` with its arrays on ``self.device``; and the event that marks
        the end of their copies (None off the card)."""
        def tensor(a):
            return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))

        if stream is None:
            return _map_arrays(lambda a: tensor(a).to(self.device), out), None
        with torch.cuda.stream(stream):
            out = _map_arrays(
                lambda a: tensor(a).pin_memory().to(self.device, non_blocking=True), out)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _ready(self, out: Any, done: Optional[torch.cuda.Event]) -> Any:
        """Make the consumer's stream wait for the copies of ``out``; the
        tensors are then marked in use on that stream, so their memory is not
        handed back to the worker's stream while the consumer reads it."""
        if done is None:
            return out
        consumer = torch.cuda.current_stream(self.device)
        done.wait(consumer)

        def claim(t):
            if t.is_cuda:
                t.record_stream(consumer)
            return t

        return _map_arrays(claim, out)

    def __iter__(self) -> Iterator[Any]:
        n = len(self.items)
        if n == 0:
            return
        results: dict[int, Any] = {}
        cv = threading.Condition()
        state = {"next": 0, "consumed": 0}  # indices taken / yielded so far
        errors: list[BaseException] = []
        on_card = self.device is not None and self.device.type == "cuda"

        def worker():
            stream = torch.cuda.Stream(device=self.device) if on_card else None
            while True:
                with cv:
                    # Bound the look-ahead when an index is *taken*, not when a
                    # result is stored: indices are taken in order, so the
                    # producer of the next-needed item is always computing,
                    # never parked behind a full buffer of later items (which
                    # would starve the consumer).
                    while (
                        not errors
                        and state["next"] < n
                        and state["next"] - state["consumed"] >= self.buffer
                    ):
                        cv.wait(timeout=0.1)
                    if errors or state["next"] >= n:
                        return
                    i = state["next"]
                    state["next"] = i + 1
                try:
                    out = self.fn(self.items[i])
                    done = None
                    if self.device is not None:
                        out, done = self._place(out, stream)
                except BaseException as e:  # handed to the consumer, which re-raises it
                    with cv:
                        errors.append(e)
                        cv.notify_all()
                    return
                with cv:
                    results[i] = (out, done)
                    cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with tracing.span("stepth/loader/take"):
                    with cv:
                        if i not in results and not errors:
                            tracing.count("loader.starved")
                            while i not in results and not errors:
                                cv.wait(timeout=0.1)
                        if errors:
                            raise errors[0]
                        out, done = results.pop(i)
                        state["consumed"] = i + 1
                        cv.notify_all()
                    item = self._ready(out, done)
                tracing.count("loader.takes")
                yield item
        finally:
            with cv:
                if not errors:
                    errors.append(GeneratorExit())  # unblock waiting workers
                cv.notify_all()
            for t in threads:
                t.join(timeout=1.0)


def image_pair_loader(
    pairs: Sequence[tuple],
    num_threads: int = 4,
    buffer: int = 4,
    device: Optional[torch.device | str] = "cuda",
) -> PrefetchLoader:
    """Loader over (left_path, right_path) tuples → dicts of u8 RGB
    ``{"left", "right"}``: tensors on ``device`` (the card by default), or
    numpy arrays with ``device=None``."""
    from stepth_tpu_torch.core import io

    def load(pair):
        lp, rp = pair
        return {"left": io.open_rgb(lp), "right": io.open_rgb(rp)}

    return PrefetchLoader(pairs, load, num_threads=num_threads, buffer=buffer, device=device)
