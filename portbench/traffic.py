"""The one traffic generator: a camera stream's frame pool from a traffic
file's parameters and the run's seed.

A traffic file (``traffic/<cell>.json``) names the served entry and the
content of the stream:

- ``entry``: ``"call"`` (``StereoModel.__call__`` per frame) or ``"video"``
  (``StereoModel.video(keyframe_interval)`` a chunk at a time);
  ``chunk``, ``keyframe_interval``;
- ``pool``: frames made once; the stream takes them in order and wraps at
  a chunk boundary (``pool`` is a multiple of ``chunk``);
- ``content``: ``"clip"``, a box-blurred noise texture whose right view is
  the left shifted by ``shifts[i % len(shifts)]`` columns, or ``"scene"``,
  a rendered ground-truth scene (``portbench.scenes``); either way frame
  ``i`` is the window of columns ``[i·pan, i·pan + W)``;
- ``check_calls``: calls the reference checks after the window, drawn from
  the seed over every call of the window; ``trace_calls``: calls the traced
  run profiles after the window.

Every seed gives the same sizes and the same work per frame in kind; the
seed changes the texture.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
_BLUR = 9  # taps of the clip's box blur, along each axis


def load(name: str) -> dict:
    """The traffic file of a cell, by name."""
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _box_same(x: np.ndarray, axis: int) -> np.ndarray:
    """``np.convolve(m, ones(9) / 9, mode="same")`` along ``axis`` of every
    line, zero outside."""
    k = np.float32(1.0 / _BLUR)
    r = _BLUR // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    p = np.pad(x, pad)
    n = x.shape[axis]
    out = np.zeros_like(x)
    for j in range(_BLUR):
        out += np.take(p, np.arange(j, j + n), axis=axis) * k
    return out


def clip_texture(h: int, w: int, seed: int) -> np.ndarray:
    """Uniform noise in [0, 255) blurred by a 9-tap box along rows, then
    columns: f32 [h, w]."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    return _box_same(_box_same(tex, 1), 0)


def u8_rgb(gray: np.ndarray) -> np.ndarray:
    """A float gray view as u8 RGB (rounded, clipped, three equal channels)."""
    g = np.clip(np.round(gray), 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def make_pool(params: dict, shape, seed: int):
    """``(lefts, rights)``, u8 RGB [pool, H, W, 3] each, C-contiguous."""
    h, w = shape
    n, pan = params["pool"], params.get("pan", 0)
    if n % params["chunk"]:
        raise ValueError(f"pool {n} is not a multiple of chunk {params['chunk']}")
    span = w + pan * (n - 1)
    lefts = np.empty((n, h, w, 3), np.uint8)
    rights = np.empty_like(lefts)
    if params["content"] == "clip":
        shifts = params["shifts"]
        tex = clip_texture(h, span + max(shifts), seed)
        for i in range(n):
            x0, s = i * pan, shifts[i % len(shifts)]
            lefts[i] = u8_rgb(tex[:, x0: x0 + w])
            rights[i] = u8_rgb(tex[:, x0 + s: x0 + s + w])
    elif params["content"] == "scene":
        from portbench import scenes

        left, right = scenes.render(params["scene"], h, span, params["scene_disparities"], seed)
        for i in range(n):
            lefts[i] = u8_rgb(left[:, i * pan: i * pan + w])
            rights[i] = u8_rgb(right[:, i * pan: i * pan + w])
    else:
        raise ValueError(f"unknown content {params['content']!r}")
    return lefts, rights
