"""The served loop of the CLI's ``video`` command, without its file I/O.

One camera stream: the pool's u8 RGB pairs, in order, through the program's
``PrefetchLoader`` at the CLI's settings (``LOADER_THREADS`` worker threads
pin and copy them on streams of their own, ``buffer = 2 × chunk``; torch's
CPU thread pool as the process finds it). A call takes a chunk of pairs from the loader,
stacks them and converts them to f32, runs the configured entry, and copies
each frame's f32 disparity and bool validity to host memory. The loop is
closed: the next call starts once the last one's results are on the host.

Each call records its spans on the host clock: ``loader_wait`` (taking the
pairs), ``stack_convert``, ``model_call`` (entering the entry until it
returns, before anything waits for the card) and ``to_host``. With
``annotate`` the same spans are ``torch.profiler`` annotations, and the
whole call is ``portbench/call``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import numpy as np
import torch

_STREAM_ITEMS = 10 ** 6  # items the stream could serve: far past any window
LOADER_THREADS = 4  # the CLI video command's --threads default


class Served:
    """The loop over one stream. ``entry(ls, rs)`` maps f32 RGB stacks
    [T, H, W, 3] to a list of ``(disparity, valid)`` tensors, one a frame."""

    def __init__(self, loader_cls, pool, entry: Callable, chunk: int, device):
        lefts, rights = pool
        n = lefts.shape[0]
        self.entry = entry
        self.chunk = chunk
        self.loader = loader_cls(range(_STREAM_ITEMS), lambda i: (lefts[i % n], rights[i % n]),
                                 num_threads=LOADER_THREADS, buffer=2 * chunk, device=device)
        self.it = iter(self.loader)
        self.next_item = 0

    def call(self, annotate: bool = False) -> dict:
        """One call: its spans (s), ``items`` (stream indices) and ``outs``
        (host arrays, one ``(disparity, valid)`` a frame)."""
        spans = {}
        mark = torch.profiler.record_function if annotate else (lambda _: contextlib.nullcontext())

        @contextlib.contextmanager
        def span(name):
            t0 = time.perf_counter()
            with mark(f"portbench/{name}"):
                yield
            spans[name] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with mark("portbench/call"):
            with span("loader_wait"):
                pairs = [next(self.it) for _ in range(self.chunk)]
            with span("stack_convert"):
                ls = torch.stack([l for l, _ in pairs]).to(torch.float32)
                rs = torch.stack([r for _, r in pairs]).to(torch.float32)
            with span("model_call"):
                res = self.entry(ls, rs)
            with span("to_host"):
                outs = [(d.cpu().numpy(), v.cpu().numpy()) for d, v in res]
        items = list(range(self.next_item, self.next_item + self.chunk))
        self.next_item += self.chunk
        return {"call": time.perf_counter() - t0, **spans, "items": items, "outs": outs}

    def close(self) -> None:
        """Stop the loader's workers and wait for them."""
        self.it.close()


def entry_of(model, traffic: dict) -> Callable:
    """The served entry of a traffic file: ``StereoModel.video`` on the
    chunk, or ``StereoModel.__call__`` on each frame of it."""
    if traffic["entry"] == "video":
        run = model.video(keyframe_interval=traffic["keyframe_interval"])

        def video(ls, rs):
            res = run(ls, rs)
            return [(res.disparity[t], res.valid[t]) for t in range(ls.shape[0])]

        return video
    if traffic["entry"] == "call":
        def per_frame(ls, rs):
            out = []
            for t in range(ls.shape[0]):
                res = model(ls[t], rs[t])
                out.append((res.disparity, res.valid))
            return out

        return per_frame
    raise ValueError(f"unknown entry {traffic['entry']!r}")


def host_frames(pool, items: List[int]):
    """The u8 RGB host frames of stream items: ``(lefts, rights)``
    [T, H, W, 3]."""
    lefts, rights = pool
    n = lefts.shape[0]
    idx = [i % n for i in items]
    return np.stack([lefts[i] for i in idx]), np.stack([rights[i] for i in idx])
